"""Parallel runtime (port of smc_tpu/parallel): the particle mesh over
torch.distributed ranks, one process per rank."""

from smc_tpu_torch.parallel.mesh import (
    particle_mesh,
    particle_sharding,
    shard_cloud,
    initialize_multihost,
)

__all__ = ["particle_mesh", "particle_sharding", "shard_cloud",
           "initialize_multihost"]
