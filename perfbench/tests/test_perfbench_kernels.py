"""The frozen work counts of perfbench/kernels/ give chip_smoke.py's numbers
at An-Schorfheide's, Smets-Wouters' and two synthetic shapes."""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke  # noqa: E402
from perfbench import peaks, spec  # noqa: E402
from perfbench.kernels import _counts  # noqa: E402


def _model_inputs(name, n, seed):
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    from smc_tpu_torch.models import as_dsge, sw_dsge
    mod, params, data = {
        "as": (as_dsge, as_dsge.an_schorfheide_parameters(),
               as_dsge.load_as_data()),
        "sw": (sw_dsge, sw_dsge.sw_parameters(), sw_dsge.load_sw_data()),
    }[name]
    th = ParamSpace(params).sample_prior(TorchDraws(seed, "cpu"), n,
                                         device="cpu")
    if name == "sw":            # near-mode draws run every filter step
        th = torch.cat([th, torch.as_tensor(sw_dsge.TRUE_PARAMS)[None]
                        .expand(4, -1) * (1 + 1e-4 * torch.arange(4.0)[
                            :, None])])
    d, Z, H = mod._measurement(th)
    return (*mod._system(th), mod._shock_cov(th), Z, d, H,
            torch.as_tensor(data))


def _synthetic(n_s, n_o):
    from torch_parity import synthetic_system
    sys_np, data = synthetic_system(n_s, 3, 64, n_o=n_o)
    return (*[torch.as_tensor(x) for x in sys_np], torch.as_tensor(data))


CASES = {
    "as": lambda: _model_inputs("as", 256, 1),
    "sw": lambda: _model_inputs("sw", 48, 2),
    "synthetic-9-2": lambda: _synthetic(9, 2),
    "synthetic-4-3": lambda: _synthetic(4, 3),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    A, B, C, D, Q, Z, d, H, data = CASES[request.param]()
    return request.param, (A, B, C, D, Q, Z, d, H, data)


def test_flop_formulas_match(case):
    _, (A, B, C, D, Q, Z, d, H, data) = case
    ns, nk, no = A.shape[0], D.shape[1], Z.shape[0]
    for it in (0, 3, 16):
        assert _counts.re_flops(ns, nk, it) == chip_smoke.re_flops(ns, nk, it)
        for steps in (1, 80):
            assert _counts.kalman_flops(ns, nk, it, steps, no) == \
                chip_smoke.kalman_flops(ns, nk, it, steps, no)
    for m in (1, 4):
        assert _counts.psd_solve_flops(no, m) == \
            chip_smoke.psd_solve_flops(no, m)
    assert peaks.PEAK_F64 == chip_smoke.PEAK_F64
    assert peaks.PEAK_F64_MMA == chip_smoke.PEAK_F64_MMA
    assert peaks.PEAK_BYTES == chip_smoke.PEAK_BYTES


def test_counts_and_bounds_match(case):
    name, (A, B, C, D, Q, Z, d, H, data) = case
    from smc_tpu_torch.models.dsge import bl_solve_linear_re
    X, M, ok = bl_solve_linear_re(A, B, C, D)
    want = chip_smoke.general_work(A, B, C, X, M, ok, Q, Z, d, H, data)
    w = _counts.Workload(A, B, C, D, Q, Z, d, H, data)
    assert torch.equal(w.solution[2], ok)
    assert torch.equal(w.cr_iters, want[2])
    assert torch.equal(w.lyap_iters, want[3])
    assert torch.equal(w.filter_steps, want[4])
    for kernel, got in (("re_general", want[0]), ("kalman_general", want[1])):
        flop, nbytes = spec.kernel_counts(kernel).work(w)
        assert flop == got[0] and nbytes == got[1]
        assert peaks.bound_ms(flop, nbytes) == (got[2], got[3])
    if Z.shape[0] == 3 and A.shape[0] <= 8:
        # the n_obs-3 kernels: kernel_phase's counts (every filter step)
        re_flop = chip_smoke._work_flop(
            want[2], lambda i: chip_smoke.re_flops(A.shape[0], D.shape[1], i))
        kal_flop = chip_smoke._work_flop(
            want[3], lambda i: chip_smoke.kalman_flops(
                A.shape[0], D.shape[1], i, data.shape[1]))
        assert spec.kernel_counts("re").work(w)[0] == re_flop
        assert spec.kernel_counts("kalman").work(w)[0] == kal_flop
