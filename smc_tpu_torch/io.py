"""Persistence (port of smc_tpu/io.py): cloud save/load, intermediate
checkpoints, final artifacts.

The npz format is the JAX package's, unchanged: the six particle arrays, the
scalar state as a JSON string in `_meta`, and `extra_<name>` arrays. A cloud
saved by either package loads in the other. Checkpoints carry each package's
own PRNG state: the JAX package an `extra_rng_key`, this one the torch
generator's state (uint8) as `extra_torch_rng_state`, so a resume here is
bit-identical to the uninterrupted run. The two PRNGs differ, so a
checkpoint with only a JAX key cannot be resumed here (`load_checkpoint`
raises), while `load_cloud` of it works.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from smc_tpu_torch.cloud import Cloud, ARRAY_FIELDS, split_cloud, join_cloud

_SCALAR_FIELDS = ("tempering_schedule", "ESS", "stage_index", "n_phi",
                  "resamples", "c", "accept_rate", "total_sampling_time")
RNG_STATE_KEY = "torch_rng_state"


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_cloud(path: str, cloud: Cloud, extra: Optional[dict] = None) -> None:
    """Write a cloud (arrays + scalar state [+ extra arrays]) to one npz,
    atomically (through a temporary file)."""
    payload = {f: _host(getattr(cloud, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(cloud, f) for f in _SCALAR_FIELDS}
    payload["_meta"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), dtype=np.uint8)
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = _host(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)


def load_cloud(path: str, device="cuda") -> Tuple[Cloud, dict]:
    """Read a cloud written by either package's save_cloud onto `device`.
    Returns (cloud, extra) with the extra arrays as numpy."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["_meta"].tobytes()).decode("utf-8"))
        cloud = Cloud.from_numpy(z, device=device)
        cloud.tempering_schedule = list(meta["tempering_schedule"])
        cloud.ESS = list(meta["ESS"])
        cloud.stage_index = int(meta["stage_index"])
        cloud.n_phi = int(meta["n_phi"])
        cloud.resamples = int(meta["resamples"])
        cloud.c = float(meta["c"])
        cloud.accept_rate = float(meta["accept_rate"])
        cloud.total_sampling_time = float(meta["total_sampling_time"])
        extra = {k[len("extra_"):]: z[k] for k in z.files
                 if k.startswith("extra_")}
    return cloud, extra


def get_cloud(path: str, device="cuda") -> Cloud:
    """Just the cloud of a saved file."""
    return load_cloud(path, device=device)[0]


def save_particle_store(path: str, cloud: Cloud) -> None:
    """Params-only store: HDF5 dataset "smcparams" when the path ends in
    .h5/.hdf5 and h5py is importable, else a .npy next to the path."""
    params = _host(cloud.params)
    if path.endswith((".h5", ".hdf5")):
        try:
            import h5py
            with h5py.File(path, "w") as f:
                f.create_dataset("smcparams", data=params)
            return
        except ImportError:
            path = path + ".npy"
    np.save(path if path.endswith(".npy") else path + ".npy", params)


def split_cloud_file(path: str, n_pieces: int) -> list:
    """Split a saved cloud into n_pieces row-slice files
    `<path>_part{i}.npz` (the extra arrays go with the first). Returns the
    piece paths."""
    cloud, extra = load_cloud(path, device="cpu")
    base = path[:-4] if path.endswith(".npz") else path
    out = []
    for i, piece in enumerate(split_cloud(cloud, n_pieces), start=1):
        p = f"{base}_part{i}.npz"
        save_cloud(p, piece, extra=extra if i == 1 else None)
        out.append(p)
    return out


def join_cloud_file(path: str, n_pieces: int) -> str:
    """Rejoin `<path>_part{i}.npz` into `<path>`. Returns the path."""
    base = path[:-4] if path.endswith(".npz") else path
    pieces, extra = [], {}
    for i in range(1, n_pieces + 1):
        c, e = load_cloud(f"{base}_part{i}.npz", device="cpu")
        pieces.append(c)
        if e:
            extra = e
    save_cloud(path if path.endswith(".npz") else path + ".npz",
               join_cloud(pieces), extra=extra or None)
    return path


def intermediate_path(savepath: str, stage: int) -> str:
    """Per-stage checkpoint path `<base>_stage=<stage>.npz`."""
    base = savepath[:-4] if savepath.endswith(".npz") else savepath
    return f"{base}_stage={stage}.npz"


def save_checkpoint(savepath: str, stage: int, cloud: Cloud, w_matrix,
                    W_matrix, j: int, phi_prop: float, log_mdd: float,
                    rng_state) -> None:
    """Intermediate checkpoint with the loop state: the cloud, the w/W
    matrices, the schedule pointer j and proposal phi_prop, the running
    log-MDD and the torch generator state."""
    save_cloud(intermediate_path(savepath, stage), cloud, extra={
        "w": w_matrix,
        "W": W_matrix,
        "j": np.asarray(j),
        "phi_prop": np.asarray(phi_prop),
        "log_mdd": np.asarray(log_mdd),
        RNG_STATE_KEY: np.asarray(rng_state, np.uint8),
    })


def load_checkpoint(path: str, device="cuda"):
    """Restore (cloud, w, W, j, phi_prop, log_mdd, rng_state). Raises
    ValueError when the file holds no torch generator state (a checkpoint
    of the JAX package)."""
    cloud, extra = load_cloud(path, device=device)
    if RNG_STATE_KEY not in extra:
        what = ("only a JAX PRNG key (extra_rng_key)" if "rng_key" in extra
                else "no PRNG state")
        raise ValueError(
            f"{path} holds {what}, not a torch generator state: the JAX and "
            "torch PRNGs differ, so the run cannot be resumed bit for bit "
            "here (load_cloud still reads the cloud)")
    return (cloud, extra["w"], extra["W"], int(extra["j"]),
            float(extra["phi_prop"]), float(extra.get("log_mdd", 0.0)),
            extra[RNG_STATE_KEY])
