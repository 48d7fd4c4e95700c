"""smc_tpu_torch's spans (tracing.py): under a torch profiler the fused
recursion and the host loop open the span tree that tracing.py sets out,
and a mesh gathers inside it; with no profiler recording, smc() enters no
record_function; smc(profile_dir=...) traces the whole call. On the CPU at
a small size, with the card test (marker `cuda`: the capture inside the
first chunk, no span per replay) run on a card with
    python -m pytest --noconftest tests/test_torch_tracing.py -m cuda -q
"""

import collections
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch.profiler import ProfilerActivity, profile

import smc_tpu_torch
from smc_tpu_torch import tracing
from smc_tpu_torch.models.regression import (regression_parameters,
                                             make_regression_loglike,
                                             generate_regression_data)
from smc_tpu_torch.parallel import mesh as mesh_mod

from torch_parity import StubMesh

from smc_tpu_torch.distributions import Uniform
from smc_tpu_torch.models.dsge import LinearDSGE
from smc_tpu_torch.params import parameter
from smc_tpu_torch.rng import TorchDraws

N_PHI = 5
# a prior draw with alpha1 above this has no finite likelihood, so the
# initial draw takes redraw rounds (Normal(0, 10) prior: ~7% of the draws)
ALPHA_CUT = 15.0


@pytest.fixture(scope="module")
def model():
    y, x = generate_regression_data(n=50, seed=1793)
    loglike = make_regression_loglike(x)

    def cut(th, data):
        return torch.where(th[:, 0] > ALPHA_CUT, -torch.inf,
                           loglike(th, data))
    return cut, y


def _smc(model, device="cpu", **kw):
    loglike, y = model
    kw = dict(dict(n_parts=64, n_phi=N_PHI, verbose="none", seed=1,
                   batched=True), **kw)
    return smc_tpu_torch.smc(loglike, regression_parameters(), y,
                             device=device, **kw)


def _traced(run, cuda=False):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        res = run()
    return res, prof


def _tree(prof):
    """(span, its innermost enclosing span) of every smc.* span, counted."""
    def parent(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith("smc."):
            p = p.cpu_parent
        return p.name if p is not None else None
    return collections.Counter((e.name, parent(e)) for e in prof.events()
                               if e.name.startswith("smc."))


@pytest.mark.parametrize("fused", [True, False])
def test_spans_nest_as_the_calls_run(model, fused):
    res, prof = _traced(lambda: _smc(model, fused=fused))
    stages = N_PHI - 1
    rounds = 1 + res.init_rounds
    assert res.init_rounds >= 1 and res.fused == fused
    stage_in = "smc.chunk" if fused else "smc.estimation"
    want = collections.Counter({
        ("smc.estimation", None): 1,
        ("smc.init", "smc.estimation"): 1,
        ("smc.init.round", "smc.init"): rounds,
        ("smc.likelihood", "smc.init.round"): rounds,
        ("smc.stage", stage_in): stages,
        ("smc.correction", "smc.stage"): stages,
        ("smc.selection", "smc.stage"): stages,
        ("smc.mutation", "smc.stage"): stages,
        ("smc.likelihood", "smc.mutation"): stages,
        ("smc.finish", "smc.estimation"): 1,
    })
    if fused:
        # one chunk (verbose "none"): the stages, then the chunk's read;
        # the final scalar read in finish
        want[("smc.chunk", "smc.estimation")] = 1
        want[("smc.read", "smc.chunk")] = 1
        want[("smc.read", "smc.finish")] = 1
    else:
        want[("smc.read", "smc.stage")] = stages
    assert _tree(prof) == want


def test_a_mesh_gathers_inside_the_spans(model, monkeypatch):
    """A one-rank mesh (its all-gather a copy): the gathers of the initial
    draw, of each stage's rows and acceptance, and of the final cloud."""
    monkeypatch.setattr(mesh_mod, "_all_gather_single",
                        lambda full, send, group=None: full.copy_(send))
    res, prof = _traced(lambda: _smc(model, mesh=StubMesh(1)))
    stages = N_PHI - 1
    tree = _tree(prof)
    gathers = {p: n for (s, p), n in tree.items() if s == "smc.gather"}
    assert gathers == {"smc.init.round": 1, "smc.stage": stages,
                       "smc.mutation": stages, "smc.finish": 1}
    assert res.collectives == sum(gathers.values())


@pytest.mark.parametrize("fused", [True, False])
def test_no_span_opens_while_no_profiler_records(model, monkeypatch, fused):
    def refuse(name, *args, **kwargs):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert tracing.span("smc.a") is tracing.span("smc.b")
    res = _smc(model, fused=fused)
    assert res.fused == fused and len(res.cloud.tempering_schedule) == N_PHI


@pytest.fixture(scope="module")
def expectations_model():
    """Two AR(1) states, their sum observed, with its expectation two
    quarters ahead and its mean over the next four: a LinearDSGE with two
    expectation rows, at a size the CPU runs in a blink."""
    def system(th):
        n = th.shape[0]
        A = torch.zeros((2, 2, n), dtype=torch.float64, device=th.device)
        A[0, 0], A[1, 1] = 0.9, th[:, 0]
        eye = torch.eye(2, dtype=torch.float64, device=th.device)
        B = (-eye)[:, :, None].expand(2, 2, n).contiguous()
        D = eye[:, :, None].expand(2, 2, n).contiguous()
        return A, B, torch.zeros_like(A), D

    def measurement(th):
        n = th.shape[0]
        Z = torch.zeros((3, 2, n), dtype=torch.float64, device=th.device)
        Z[0] = 1.0
        H = (1e-2 * torch.eye(3, dtype=torch.float64, device=th.device)
             )[:, :, None].expand(3, 3, n).contiguous()
        return torch.zeros((3, n), dtype=torch.float64, device=th.device), \
            Z, H

    def shock_cov(th):
        sig = torch.stack([torch.ones_like(th[:, 1]), th[:, 1]], 1)
        return torch.diag_embed(sig * sig, dim1=0, dim2=1).contiguous()

    params = [parameter("rho", 0.5, (0.0, 0.95), prior=Uniform(0.0, 0.95)),
              parameter("sig", 1.0, (0.1, 3.0), prior=Uniform(0.1, 3.0))]
    dsge = LinearDSGE(params, system, measurement, 2, shock_cov,
                      expectation_rows=((1, 0, 2, 2), (2, 0, 1, 4)))
    y = dsge.simulate([0.5, 1.0], 40, TorchDraws(3, "cpu")).numpy()
    return dsge, params, y


def test_expectation_rows_open_their_span_in_each_likelihood_call(
        expectations_model):
    dsge, params, y = expectations_model
    res, prof = _traced(lambda: smc_tpu_torch.smc(
        dsge.loglike_batched, params, y, n_parts=64, n_phi=N_PHI, seed=1,
        batched=True, verbose="none", device="cpu"))
    tree = _tree(prof)
    calls = 1 + res.init_rounds + N_PHI - 1
    assert tree[("smc.likelihood", "smc.init.round")] + tree[
        ("smc.likelihood", "smc.mutation")] == calls
    assert tree[("smc.likelihood.expectations", "smc.likelihood")] == calls
    assert sum(n for (s, _), n in tree.items()
               if s == "smc.likelihood.expectations") == calls


def test_profile_dir_traces_the_whole_call(model, tmp_path):
    _smc(model, profile_dir=str(tmp_path))
    with open(tmp_path / "smc_trace.json") as f:
        events = json.load(f)["traceEvents"]
    spans = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            spans.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    (a, b), = spans["smc.estimation"]
    for name in ("smc.init", "smc.init.round", "smc.chunk", "smc.stage",
                 "smc.likelihood", "smc.read", "smc.finish"):
        assert spans[name], name
        assert all(a <= s and e <= b for s, e in spans[name]), name


@pytest.mark.cuda
def test_on_the_card_the_capture_sits_in_the_first_chunk(model):
    """The eager first stage and the capture inside the first chunk, then
    replays that open no span: every span is counted as often at 5 stages
    as at 11."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    _smc(model, device=dev)                       # builds the kernels
    trees = {}
    for n_phi in (N_PHI, 2 * N_PHI + 1):
        res, prof = _traced(lambda: _smc(model, device=dev, n_phi=n_phi),
                            cuda=True)
        assert res.fused and res.capture_seconds > 0
        trees[n_phi] = _tree(prof)
    tree = trees[N_PHI]
    assert tree == trees[2 * N_PHI + 1]
    assert tree[("smc.chunk", "smc.estimation")] == 1
    assert tree[("smc.stage", "smc.chunk")] == 1
    assert tree[("smc.capture", "smc.chunk")] == 1
    for step in ("smc.correction", "smc.selection", "smc.mutation"):
        assert tree[(step, "smc.stage")] == 1
        assert tree[(step, "smc.capture")] == 1
    assert tree[("smc.likelihood", "smc.capture")] == 0
    assert tree[("smc.likelihood", "smc.mutation")] == 2


@pytest.mark.cuda
def test_on_the_card_the_expectation_rows_count_each_replay(
        expectations_model):
    """On the card the rows' kernel launches once per likelihood call, its
    counter counting each replay; its span opens in the init rounds, the
    eager stage and the capture, and in no replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from smc_tpu_torch.ops.kernels import LAUNCHES
    dev = torch.device("cuda", 0)
    dsge, params, y = expectations_model
    run = lambda n_phi: smc_tpu_torch.smc(
        dsge.loglike_batched, params, y, n_parts=64, n_phi=n_phi, seed=1,
        batched=True, verbose="none", device=dev)
    run(N_PHI)                                    # builds the kernels
    for n_phi in (N_PHI, 2 * N_PHI + 1):
        before = LAUNCHES["expectation_rows"]
        res, prof = _traced(lambda: run(n_phi), cuda=True)
        assert res.fused and res.capture_seconds > 0
        assert LAUNCHES["expectation_rows"] - before == (
            1 + res.init_rounds + n_phi - 1 + res.masked_stages)
        tree = _tree(prof)
        assert tree[("smc.likelihood.expectations", "smc.likelihood")] == (
            1 + res.init_rounds + 2)
