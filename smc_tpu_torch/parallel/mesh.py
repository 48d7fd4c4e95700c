"""The particle mesh: one process per rank under torch.distributed, the
particle axis split over the ranks (port of smc_tpu/parallel/mesh.py).

The JAX package runs SPMD over a 1-D device mesh whose axis "parts" is the
particle dimension. Here every rank is a process that runs the same
program with the same seed; rank r of R holds the particle rows
[r N/R, (r+1) N/R) of the cloud, and its likelihood calls (the CUDA kernels
on a card) see only those rows. The cross-particle work of a stage, which
XLA lowers to psum and all-gather, goes through a few collectives here:

  * one all-gather of the cloud's rows (params, loglh, logprior, old_loglh,
    weights) at the top of each stage, after which every rank computes the
    ESS, the log-MDD increment, the adaptive phi, the resampling indices and
    the proposal's mean and covariance from the same data with the
    one-device code, so every host branch is the same on every rank;
  * one all-gather of the acceptance vector after the mutation, for its
    mean.

Reductions over gathered rows run in the one-device order, so a mesh run
equals the one-device run up to what the per-rank batch size changes in the
likelihood and the proposal (nothing, where those are elementwise). NCCL
carries CUDA tensors between cards; gloo carries CPU tensors, and CUDA
tensors through host memory (several ranks sharing a card, which NCCL
refuses).

A gather packs its tensors into one send buffer and receives into one
preallocated [R n, cols] tensor, reading nothing to the host, so smc()'s
fused recursion captures it in its CUDA graph under NCCL (a gloo gather of
CUDA tensors goes through the host and cannot be captured).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from smc_tpu_torch.cloud import Cloud, ARRAY_FIELDS
from smc_tpu_torch.tracing import span

PARTICLE_AXIS = "parts"

# how long a collective may wait for the other ranks before it fails (a
# rank that died or took another branch deadlocks the rest)
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def rank_device(rank: int, device=None) -> torch.device:
    """The device of rank `rank`: `device` where the caller gives one, else
    cuda:LOCAL_RANK (LOCAL_RANK defaults to the rank), whatever the
    backend."""
    if device is None:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    return torch.device(device)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, *,
                         backend: str = "nccl", device=None, store=None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> torch.device:
    """Join this process to the process group and return its device.

    The rendezvous is `store` (a torch.distributed Store, e.g. a FileStore
    every rank opens on one path), else `coordinator_address` ("host:port",
    or a URL such as "tcp://host:port" or "file:///path"), else the
    environment torchrun sets (MASTER_ADDR, MASTER_PORT). `num_processes`
    and `process_id` default to the WORLD_SIZE and RANK variables, or 1
    and 0. `backend` is given, never guessed: "nccl" for one card per rank,
    "gloo" for CPU tensors or for ranks sharing a card. The rank's device is
    rank_device(rank, device): cuda:LOCAL_RANK under either backend unless
    the caller passes `device` (device="cpu" for CPU ranks); a CUDA device
    is made current with torch.cuda.set_device, which raises where there is
    no card. A failed initialization raises."""
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    device = rank_device(rank, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = dict(backend=backend, world_size=world, rank=rank,
                  timeout=timeout)
    if store is not None:
        kwargs["store"] = store
    elif coordinator_address is not None:
        kwargs["init_method"] = (coordinator_address
                                 if "://" in coordinator_address
                                 else f"tcp://{coordinator_address}")
    else:
        kwargs["init_method"] = "env://"
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(**kwargs)
    return device


def particle_mesh(devices=None):
    """The 1-D DeviceMesh "parts" over every rank of the process group.
    `devices` is the mesh's device type; by default "cuda" under NCCL and
    "cpu" under gloo."""
    if not dist.is_initialized():
        raise RuntimeError(
            "particle_mesh needs a process group: call "
            "smc_tpu_torch.parallel.initialize_multihost first, or start the "
            "ranks with torchrun")
    from torch.distributed.device_mesh import init_device_mesh
    if devices is None:
        devices = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(str(devices), (dist.get_world_size(),),
                            mesh_dim_names=(PARTICLE_AXIS,))


def mesh_backend(mesh) -> str:
    """The torch.distributed backend ("nccl", "gloo") of a particle
    mesh's group."""
    return dist.get_backend(mesh.get_group(PARTICLE_AXIS))


# the one-tensor all-gather: all_gather_single where torch has it (it
# deprecates all_gather_into_tensor; torch 2.11 has only the latter)
_all_gather_single = getattr(dist, "all_gather_single",
                             dist.all_gather_into_tensor)


@dataclasses.dataclass
class ParticleSharding:
    """This rank's place on the mesh (`rank` of `world`, communicating over
    `group`) and the collectives a run makes, counted in `counts`:
    `collectives` calls and `bytes` received from the other ranks. A
    fused run's CUDA graph issues its collectives once per replay, and the
    fused recursion adds them to `counts` per replay."""

    rank: int
    world: int
    group: object
    counts: dict = dataclasses.field(
        default_factory=lambda: {"collectives": 0, "bytes": 0})

    @property
    def collectives(self) -> int:
        return self.counts["collectives"]

    @property
    def bytes(self) -> int:
        return self.counts["bytes"]

    def rows(self, n_parts: int) -> slice:
        """This rank's particle rows of a cloud of `n_parts`."""
        if n_parts % self.world != 0:
            raise ValueError(f"n_parts={n_parts} must be divisible by the "
                             f"mesh size {self.world}")
        k = n_parts // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def gather(self, *xs: torch.Tensor):
        """The all-gather along the particle axis: f64 tensors [N/R, ...]
        of this rank -> [N, ...], in one collective (one packed send buffer
        into one preallocated [N, cols] output). One tensor in, one out;
        several in, a tuple out. Span `smc.gather` where it runs on the
        host (not inside a graph replay)."""
        with span("smc.gather"):
            n = xs[0].shape[0]
            flat = [x.reshape(n, -1) for x in xs]
            send = (flat[0] if len(flat) == 1
                    else torch.cat(flat, 1)).contiguous()
            full = send.new_empty((self.world * n, send.shape[1]))
            _all_gather_single(full, send, group=self.group)
            self.counts["collectives"] += 1
            self.counts["bytes"] += ((self.world - 1) * send.numel()
                                     * send.element_size())
            out, col = [], 0
            for x, f in zip(xs, flat):
                out.append(full[:, col:col + f.shape[1]].reshape(
                    (n * self.world,) + tuple(x.shape[1:])))
                col += f.shape[1]
        return out[0] if len(out) == 1 else tuple(out)

    def shard(self, cloud: Cloud) -> Cloud:
        """A copy of the (whole) `cloud` holding this rank's rows."""
        rows = self.rows(cloud.n_parts)
        return _replace_arrays(cloud, {f: getattr(cloud, f)[rows]
                                       for f in ARRAY_FIELDS})

    def gather_cloud(self, cloud: Cloud) -> Cloud:
        """The whole cloud from every rank's rows (one collective)."""
        return _replace_arrays(cloud, dict(zip(ARRAY_FIELDS, self.gather(
            *(getattr(cloud, f) for f in ARRAY_FIELDS)))))

    def barrier(self) -> None:
        dist.barrier(group=self.group)
        self.counts["collectives"] += 1


def _replace_arrays(cloud: Cloud, arrays) -> Cloud:
    return dataclasses.replace(
        cloud, tempering_schedule=list(cloud.tempering_schedule),
        ESS=list(cloud.ESS), **arrays)


def particle_sharding(mesh) -> ParticleSharding:
    """This rank's ParticleSharding on a 1-D particle mesh."""
    if tuple(mesh.mesh_dim_names or ()) != (PARTICLE_AXIS,):
        raise ValueError(f"expected a 1-D mesh with dimension "
                         f"{PARTICLE_AXIS!r}, got {mesh.mesh_dim_names}")
    return ParticleSharding(rank=mesh.get_local_rank(PARTICLE_AXIS),
                            world=mesh.size(),
                            group=mesh.get_group(PARTICLE_AXIS))


def shard_cloud(cloud: Cloud, mesh) -> Cloud:
    """A copy of the whole `cloud` holding this rank's particle rows."""
    return particle_sharding(mesh).shard(cloud)
