"""The sw_pi_fg configuration's reference (perfbench/reference/sw_pi_fg.py)
against the repository's test reference it copies and against the port's
plain path, its priors against the port's, and the work count of the
expectation-rows kernel (perfbench/kernels/expectation_rows.py). The tests
import the port; the reference does not."""

from __future__ import annotations

import os
import sys

import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from perfbench import peaks, spec  # noqa: E402
from perfbench.kernels import _counts  # noqa: E402
from perfbench.reference import prior, sw_pi_fg  # noqa: E402
from perfbench.traced import TracedRun  # noqa: E402

# the bands of test_perfbench_reference.py: rounding within 50 nats of the
# best draw, the Chandrasekhar tail's drift deeper (as SW's)
BAND_NATS, BAND_RTOL, TAIL_RTOL = 50.0, 1e-10, 1e-3


def _case(n, seed):
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    th = ParamSpace(fg.sw_pi_fg_parameters()).sample_prior(
        TorchDraws(seed, "cpu"), n, device="cpu")
    g = torch.Generator().manual_seed(seed)
    near = torch.as_tensor(fg.TRUE_PARAMS)[None] * (
        1 + 1e-3 * torch.randn((6, th.shape[1]), generator=g,
                               dtype=torch.float64))
    return fg, torch.cat([th, near]), fg.load_sw_pi_fg_data()


def test_the_copy_is_the_tests_reference():
    import reference_sw_pi_fg as original
    _, th, data = _case(12, 3)
    y = torch.as_tensor(data)
    assert sw_pi_fg.PRIORS == original.PRIORS
    assert sw_pi_fg.EXPECTATION_ROWS == original.EXPECTATION_ROWS
    for got, want in zip(sw_pi_fg.inputs(th), original.inputs(th)):
        assert torch.equal(got, want)
    assert torch.equal(sw_pi_fg.loglike(th, y), original.loglike(th, y))


def test_reference_matches_the_ports_plain_path():
    fg, th, data = _case(24, 5)
    want = fg.sw_pi_fg().loglike_batched(th, data)
    got = sw_pi_fg.loglike(th, torch.as_tensor(data))
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert fin[-6:].all()
    rel = (got - want).abs() / want.abs()
    band = fin & (want > want[fin].max() - BAND_NATS)
    assert band.sum() >= 2
    assert rel[band].max() <= BAND_RTOL
    assert rel[fin].max() <= TAIL_RTOL


def test_reference_computes_in_the_dtype_it_is_given():
    _, th, data = _case(2, 1)
    assert sw_pi_fg.loglike(th.float(), data).dtype == torch.float32


def test_reference_prior_matches_the_ports():
    from smc_tpu_torch.params import ParamSpace
    fg, th, _ = _case(512, 17)
    space = ParamSpace(fg.sw_pi_fg_parameters())
    assert [p[0] for p in sw_pi_fg.PRIORS] == space.names
    assert [(p[4], p[5]) for p in sw_pi_fg.PRIORS] == list(zip(space.lo,
                                                               space.hi))
    wide = torch.cat([th, th * 1.5])
    got = prior.log_prior(sw_pi_fg.PRIORS, wide)
    want = space.log_prior(wide)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    assert fin.sum() > 100
    assert torch.allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)


def test_expectation_rows_work_count():
    """The count against what the plain version runs: its chain's matrix
    flop as torch's counter reads them (einsum products, 2 n_s^2 a step),
    plus the sums' additions and the means' divisions; the bytes from the
    tensors' sizes; the bound bytes at the model's shape."""
    from torch.utils.flop_counter import FlopCounterMode
    from smc_tpu_torch.models.dsge import bl_expectation_rows
    counts = spec.kernel_counts("expectation_rows")
    fg, th, data = _case(8, 7)
    passive = th[:1].clone()
    passive[0, 10] = 0.5          # crpi < 1: no unique stable solution
    th = torch.cat([th, passive])
    w = _counts.Workload(*sw_pi_fg.inputs(th), data)
    X, _, ok = w.solution
    n_ok, n_s = int(ok.sum()), w.n_s
    assert 0 < n_ok < w.n
    with FlopCounterMode(display=False) as fc:
        bl_expectation_rows(w.Z[..., :1], X[..., :1].contiguous(),
                            sw_pi_fg.EXPECTATION_ROWS)
    rows = sw_pi_fg.EXPECTATION_ROWS
    adds = sum(last - first + 1 for _, _, first, last in rows) * n_s
    flop, nbytes = counts.work(w)
    assert flop == (0, n_ok * (fc.get_total_flops() + adds
                               + len(rows) * n_s))
    assert fc.get_total_flops() == (40 + 6) * 2 * n_s * n_s
    filled = len(rows) * n_s * 8
    assert nbytes == (n_ok * (X[..., 0].numel() * 8 - filled)
                      + w.n * (1 + 2 * w.Z[..., 0].numel() * 8))
    assert peaks.bound_ms(flop, nbytes)[1] == "bytes"


@pytest.mark.parametrize("rows", [((7, 5, 2, 3),), ()])
def test_expectation_rows_count_reads_the_workloads_rows(rows):
    """The count takes the rows the workload's Z records, not one
    configuration's: other rows give their own chain, no rows raise."""
    counts = spec.kernel_counts("expectation_rows")
    _, th, data = _case(4, 9)
    w = _counts.Workload(*sw_pi_fg.inputs(th), data)
    assert counts.rows_of(w) == sw_pi_fg.EXPECTATION_ROWS
    w.Z = w.Z.clone()
    w.Z.expectation_rows = rows
    if not rows:
        with pytest.raises(ValueError):
            counts.work(w)
        return
    n_ok, n_s = int(w.solution[2].sum()), w.n_s
    assert counts.work(w)[0] == (0, n_ok * (3 * 2 * n_s * n_s + 2 * n_s
                                            + n_s))


def test_new_readers_read_nothing_without_a_trace():
    """A run whose trace holds no launch of the kernels (or no trace)
    reads None: the metric is then left out of the line."""
    from perfbench.tests._small import small_cell
    cell = small_cell("swpifg-4k-fixed")
    run = TracedRun([], [], None, cell, None)
    for name in ("expectation_rows_roofline", "kalman_general_r16_roofline"):
        assert cell.reader(name).read(run) is None
    assert {m["name"] for m in cell.per_layer} >= {
        "expectation_rows_roofline", "kalman_general_r16_roofline",
        "likelihood_ms_per_stage", "stage_mfu"}
    assert cell.config.KERNELS == ("re_general", "kalman_general",
                                   "expectation_rows")


@pytest.mark.parametrize("kernel", ["re_general", "kalman_general",
                                    "expectation_rows"])
def test_the_cells_kernels_count_the_models_work(kernel):
    _, th, data = _case(6, 2)
    w = _counts.Workload(*sw_pi_fg.inputs(th), data)
    flop, nbytes = spec.kernel_counts(kernel).work(w)
    assert flop[0] + flop[1] > 0 and nbytes > 0
