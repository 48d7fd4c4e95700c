"""The Metropolis resampler's chain: a hand-written CUDA kernel
(csrc/metropolis_kernel.cu, body and design in csrc/metropolis_chain.cuh)
and its dispatch.

Not a TPU kernel: the JAX package runs the chain of
smc_tpu/ops/resample.py::_metropolis_adaptive as an XLA while loop whose
trip count is read from the weights on the device. The port's stage, which
a fused run captures in a CUDA graph, cannot loop a data-dependent number
of times in PyTorch launches; one launch of this kernel runs every slot's
whole chain, its length B read from device memory.

`metropolis_chain(weights, key, steps, flag, n_out)`: slot i starts at
i mod n and takes `steps` Metropolis steps (none where `flag` is false),
step t of slot i drawing from Philox4x32-10 at counter (i, t, 0, 0) under
`key` (two words in [0, 2^32)). Dispatch: a CPU tensor runs the plain
version (`metropolis_chain_plain`, the same arithmetic in torch, bit for
bit); a CUDA tensor launches the kernel, or raises. The kernel launches
through ops/kernels.py, which counts it under "metropolis".
"""

from __future__ import annotations

from typing import Optional

import torch

from smc_tpu_torch.ops.kernels import cuda_device, launch

# Philox4x32-10's multipliers and key increments (Random123)
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
_TWO_M53 = 2.0 ** -53

def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of m * x for a 32-bit constant m and 32-bit
    words x in int64: x split into 16-bit halves, so no product passes
    2^49 (m * x itself can pass 2^63, which int64 does not hold)."""
    a = m * (x >> 16)
    b = m * (x & 0xFFFF)
    s = a + (b >> 16)
    return s >> 16, ((s & 0xFFFF) << 16) | (b & 0xFFFF)


def philox4x32_10(ctr, key):
    """Philox4x32-10 of the counter words ctr (four int64 tensors, or
    ints, holding 32-bit words; tensors broadcast) under key (two ints):
    four int64 tensors of 32-bit words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = int(key[0]) & _MASK, int(key[1]) & _MASK
    for _ in range(10):
        hi0, lo0 = _mulhilo(M0, torch.as_tensor(c0))
        hi1, lo1 = _mulhilo(M1, torch.as_tensor(c2))
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + W0) & _MASK, (k1 + W1) & _MASK
    return c0, c1, c2, c3


def _check(weights, key, n_out):
    if weights.dim() != 1 or weights.dtype != torch.float64:
        raise ValueError(f"the chain needs f64 weights [n], not "
                         f"{weights.dtype} {tuple(weights.shape)}")
    n = weights.shape[0]
    if not 1 <= n < 2 ** 31 or not 0 <= n_out < 2 ** 32:
        raise ValueError(f"the chain serves 1 <= n < 2^31 weights and "
                         f"n_out < 2^32 slots, not n={n}, n_out={n_out}")
    if key.shape != (2,) or key.dtype != torch.int64:
        raise ValueError(f"the chain's key is int64 [2], not {key.dtype} "
                         f"{tuple(key.shape)}")


def metropolis_chain_plain(weights: torch.Tensor, key: torch.Tensor,
                           steps: torch.Tensor,
                           flag: Optional[torch.Tensor] = None,
                           n_out: Optional[int] = None) -> torch.Tensor:
    """The plain version: the kernel's arithmetic as torch operations on
    every slot at once, one step at a time. It reads the key, the flag and
    the chain length to the host."""
    n = weights.shape[0]
    n_out = n if n_out is None else int(n_out)
    _check(weights, key, n_out)
    b = int(steps) if flag is None or bool(flag) else 0
    k = key.tolist()
    i = torch.arange(n_out, dtype=torch.int64, device=weights.device)
    j = i % n
    wj = weights[j]
    zero = torch.zeros_like(i)
    for t in range(max(b, 0)):
        x0, x1, x2, _ = philox4x32_10((i, zero + t, zero, zero), k)
        prop = (x0 * n) >> 32
        u = ((x1 << 21) | (x2 >> 11)).to(torch.float64) * _TWO_M53
        wp = weights[prop]
        move = u * wj < wp
        j = torch.where(move, prop, j)
        wj = torch.where(move, wp, wj)
    return j


def metropolis_chain(weights: torch.Tensor, key: torch.Tensor,
                     steps: torch.Tensor, flag: Optional[torch.Tensor] = None,
                     n_out: Optional[int] = None) -> torch.Tensor:
    """Ancestor indices (int64 [n_out], n_out defaulting to n) of the
    Metropolis chains over the f64 weights [n]: `steps` (an int64 device
    scalar) steps per slot where `flag` (a bool device scalar; None: true)
    holds, none elsewhere. On a card one launch that reads nothing to the
    host; on the CPU the plain version."""
    if weights.device.type == "cpu":
        return metropolis_chain_plain(weights, key, steps, flag, n_out)
    dev = cuda_device(weights)
    n = weights.shape[0]
    n_out = n if n_out is None else int(n_out)
    _check(weights, key, n_out)
    if flag is None:
        flag = torch.ones((), dtype=torch.bool, device=dev)
    for name, t, dtype in (("key", key, torch.int64),
                           ("flag", flag, torch.bool),
                           ("steps", steps, torch.int64)):
        if t.device != dev or t.dtype != dtype:
            raise ValueError(f"the chain's {name} must be {dtype} on {dev}, "
                             f"not {t.dtype} on {t.device}")
    w = weights.contiguous()
    key, flag, steps = key.contiguous(), flag.reshape(()), steps.reshape(())
    idx = torch.empty(n_out, dtype=torch.int64, device=dev)
    launch("metropolis", "smc_metropolis", dev, w.data_ptr(), n, n_out,
           key.data_ptr(), flag.data_ptr(), steps.data_ptr(), idx.data_ptr())
    return idx
