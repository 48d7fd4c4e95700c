"""Time this checkout's general-shape DSGE kernels
(csrc/dsge_general_kernels.cu) against another csrc/ tree's, in turns
(other, this, this, other) on one card.

    python3 tests/torch_general_turns.py --other DIR
        [--shape sw|sw-post|as2|swpifg|swpifg-post|NS,NK,NO] [--out FILE]

DIR holds a dsge_general_kernels.cu with this checkout's C interface
(smc_general_prepare, smc_general_re, smc_general_kalman): a copy of
csrc/ edited by hand (a variant) or an older commit's, unpacked with `git
archive` into a gitignored directory. It is built with nvcc and this
checkout's flags for the library (tests/torch_turns.py); this checkout's
library through smc_tpu_torch._build. Both are launched through the same
bare ctypes calls on outputs allocated once, on chip_smoke.py's inputs:
"sw" (the default) its general phase's SW_N_PARTS Smets-Wouters prior
draws, "sw-post" as many draws from the normal of
perfbench/posteriors/smets_wouters.json's posterior means and standard
deviations, each parameter clamped to its prior's bounds (the clouds the
benchmark's SW cells filter in their later stages, without their
correlations), "as2" AS_N_PARTS AS-2obs prior draws, "swpifg" SW_N_PARTS
prior draws of models/sw_pi_fg.py (44 states, 14 observables: the Kalman
kernel on rows of 16), "swpifg-post" its posterior table's draws as
"sw-post", or GEN_N synthetic systems at (n_state, n_shock, n_obs).
sw_pi_fg's Z holds its expectation rows, filled once from this checkout's
RE and expectation-rows kernels. Each turn times the RE solve and the Kalman
filter back to back (chip_smoke.cuda_ms) and from a CUDA graph
(chip_smoke.graph_ms). Prints both builds' ptxas lines (registers, spills)
and one line per turn; with --out, writes the numbers, with the card's
name and power limit, to FILE as JSON."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from torch_turns import build_tree, turns  # noqa: E402


def library(path: Path, device):
    """The dsge_general build at `path`, typed (the entries it has) and
    readied on `device`."""
    from smc_tpu_torch.ops import kernels
    lib = kernels.typed(path, "dsge_general", missing_ok=True)
    kernels.prepare(lib, "dsge_general", device)
    return lib


def kalman_launcher(lib, X, M, Q, Z, d, H, data, ok, out):
    """kalman(): a bare launch of the library's Kalman kernel on these
    tensors, into `out`."""
    import torch
    n_s, n_k, n_o, n = X.shape[0], M.shape[1], Z.shape[0], X.shape[-1]

    def kalman():
        rc = lib.smc_general_kalman(
            n_s, n_k, n_o, X.data_ptr(), M.data_ptr(), Q.data_ptr(),
            Z.data_ptr(), d.data_ptr(), H.data_ptr(), data.data_ptr(),
            data.shape[1], ok.data_ptr(), n, 30, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"Kalman launch failed ({rc})")
    return kalman


def launchers(path: Path, inputs):
    """(re(), kalman(), outputs): bare launches of the library's kernels on
    `inputs` into outputs allocated once."""
    import torch
    A, B, C, D, Q, Z, d, H, data = inputs
    lib = library(path, A.device)
    n_s, n_k, n = A.shape[0], D.shape[1], A.shape[-1]
    X = torch.empty((n_s, n_s, n), dtype=A.dtype, device=A.device)
    M = torch.empty((n_s, n_k, n), dtype=A.dtype, device=A.device)
    ok = torch.empty(n, dtype=torch.bool, device=A.device)
    out = torch.empty(n, dtype=A.dtype, device=A.device)

    def re():
        rc = lib.smc_general_re(n_s, n_k, A.data_ptr(), B.data_ptr(),
                                C.data_ptr(), D.data_ptr(), X.data_ptr(),
                                M.data_ptr(), ok.data_ptr(), n, 16, 1e-8,
                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"RE launch failed ({rc})")

    kalman = kalman_launcher(lib, X, M, Q, Z, d, H, data, ok, out)
    re()
    kalman()
    torch.cuda.synchronize()
    return re, kalman, (X, M, ok, out)


def inputs_for(shape: str, dev):
    """chip_smoke.py's general-phase inputs: A, B, C, D, Q, Z, d, H, data."""
    import torch
    import chip_smoke
    from torch_parity import synthetic_system
    from smc_tpu_torch.models import as_dsge, sw_dsge
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    if shape == "sw-post":
        th = posterior_draws("smets_wouters",
                             ParamSpace(sw_dsge.sw_parameters()), dev)
        d, Z, H = sw_dsge._measurement(th)
        return (*sw_dsge._system(th), sw_dsge._shock_cov(th), Z, d, H,
                torch.as_tensor(sw_dsge.load_sw_data(), device=dev)
                .contiguous())
    if shape in ("sw", "as2"):
        mod, params, meas, data, n, seed = (
            (sw_dsge, sw_dsge.sw_parameters(), sw_dsge._measurement,
             sw_dsge.load_sw_data(), chip_smoke.SW_N_PARTS, 2)
            if shape == "sw" else
            (as_dsge, as_dsge.an_schorfheide_parameters(),
             as_dsge._measurement_2obs, as_dsge.load_as_data()[:2],
             chip_smoke.AS_N_PARTS, 3))
        th = ParamSpace(params).sample_prior(TorchDraws(seed, dev), n,
                                             device=dev)
        d, Z, H = meas(th)
        return (*mod._system(th), mod._shock_cov(th), Z, d, H,
                torch.as_tensor(data, device=dev).contiguous())
    if shape in ("swpifg", "swpifg-post"):
        return sw_pi_fg_inputs(shape, dev)
    n_s, n_k, n_o = (int(v) for v in shape.split(","))
    sys_np, data = synthetic_system(n_s, n_k, chip_smoke.GEN_N, n_o=n_o)
    return tuple(torch.as_tensor(x, device=dev) for x in (*sys_np, data))


def posterior_draws(config: str, space, dev):
    """SW_N_PARTS draws from the normal of perfbench/posteriors/<config>.json's
    posterior means and standard deviations, each parameter clamped to its
    prior's bounds."""
    import torch
    import chip_smoke
    with open(ROOT / "perfbench" / "posteriors" / f"{config}.json") as f:
        table = json.load(f)
    gen = torch.Generator(device=dev).manual_seed(2)
    mean, sd = (torch.as_tensor(table[k], device=dev) for k in ("mean", "sd"))
    th = mean + sd * torch.randn((chip_smoke.SW_N_PARTS, mean.numel()),
                                 generator=gen, dtype=mean.dtype, device=dev)
    return torch.minimum(torch.maximum(
        th, torch.as_tensor(space.lo, device=dev)),
        torch.as_tensor(space.hi, device=dev))


def sw_pi_fg_inputs(shape: str, dev):
    """sw_pi_fg's A, B, C, D, Q, Z, d, H, data at its prior draws
    ("swpifg") or at draws from its posterior table ("swpifg-post"), Z's
    expectation rows filled."""
    import torch
    import chip_smoke
    from smc_tpu_torch.models import sw_pi_fg as fg
    from smc_tpu_torch.ops import cuda_dsge_expectations as ce
    from smc_tpu_torch.ops import cuda_dsge_general as g
    from smc_tpu_torch.params import ParamSpace
    from smc_tpu_torch.rng import TorchDraws
    space, n = ParamSpace(fg.sw_pi_fg_parameters()), chip_smoke.SW_N_PARTS
    if shape == "swpifg":
        th = space.sample_prior(TorchDraws(2, dev), n, device=dev)
    else:
        th = posterior_draws("sw_pi_fg", space, dev)
    A, B, C, D = fg._system(th)
    d, Z, H = fg._measurement(th)
    X, _, ok = g.solve_linear_re(A, B, C, D)
    Z = ce.expectation_rows(Z, X, ok, fg.EXPECTATION_ROWS)
    data = torch.as_tensor(fg.load_sw_pi_fg_data(), device=dev)
    return A, B, C, D, fg._shock_cov(th), Z, d, H, data.contiguous()


def build_other(csrc: Path) -> Path:
    """The dsge_general library of another csrc/ tree, with this checkout's
    flags for it."""
    from smc_tpu_torch import _build
    return build_tree(Path(csrc).resolve(), "dsge_general_kernels.cu",
                      "libsmc_dsge_general_other",
                      _build.CUDA_LIBRARIES["dsge_general"].flags)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--shape", default="sw",
                    help="sw, sw-post, as2, swpifg, swpifg-post or "
                         "n_state,n_shock,n_obs (default sw)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    import chip_smoke
    from smc_tpu_torch import _build
    dev = torch.device("cuda", 0)
    inputs = inputs_for(args.shape, dev)
    libs = {"other": build_other(args.other),
            "this": _build.build_cuda_library("dsge_general")}
    print(f"# {chip_smoke.smi_line()}")
    for name, path in libs.items():
        for line in chip_smoke.ptxas_lines(path.with_suffix(".log")
                                           .read_text()):
            print(f"# ptxas {name}: {line}")
    runs = {name: launchers(path, inputs) for name, path in libs.items()}
    same = all(torch.equal(a, b) for a, b in zip(runs["other"][2],
                                                 runs["this"][2]))
    print(f"# {args.shape}: N={inputs[0].shape[-1]}, outputs bitwise equal: "
          f"{same}")
    times = {kern: turns({name: runs[name][i] for name in runs}, args.reps)
             for i, kern in enumerate(("re", "kalman"))}
    for kern, t in times.items():
        for name, ms in t.items():
            print(f"# {kern} {name} (ms, graph ms) per turn: {ms}",
                  flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=chip_smoke.smi_line(), shape=args.shape,
                           equal=same, ms=times), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
