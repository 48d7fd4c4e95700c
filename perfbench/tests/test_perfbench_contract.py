"""BENCHMARK.json against the rules the harness and its checker hold it to,
and the files it names found by name."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, ROOT)

from perfbench import check, spec  # noqa: E402

TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
METRIC_KEYS = {"name", "unit", "better", "source"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


@pytest.fixture(scope="module")
def bench():
    with open(spec.BENCHMARK) as f:
        return json.load(f)


def test_parses_with_exactly_the_keys(bench):
    assert set(bench) == TOP_KEYS
    assert os.path.getsize(spec.BENCHMARK) <= 64 * 1024
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in SOURCES


def test_names_and_units_use_only_the_allowed_characters(bench):
    names = ([c["name"] for c in bench["configs"]]
             + [w[k] for w in bench["workloads"]
                for k in ("name", "config", "traffic")]
             + [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
             + [k for c in bench["configs"] for k in c["reduced"]])
    for n in names:
        assert spec.NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert spec.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for group in (metrics, [w["name"] for w in bench["workloads"]],
                  [c["name"] for c in bench["configs"]]):
        assert len(group) == len(set(group))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    text = [c["why"] for c in bench["configs"]] + [
        w["why"] for w in bench["workloads"]] + [
        m["layer"] for m in bench["per_layer"]] + [
        c["source"] for c in bench["configs"]]
    for t in text:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t


def test_every_metric_is_reported_where_it_is_read(bench):
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]

    def cells_of(m):
        return set(m.get("workloads", cells))

    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert cells_of(m) <= cells
        assert cells_of(m) <= cells_of(e2e[m["moves"]]), m["name"]
    for c in cells:
        assert any(c in cells_of(m) for m in bench["end_to_end"]
                   if m["name"] != "setup_s")
        assert any(c in cells_of(m) for m in bench["per_layer"])
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)


def test_every_cells_files_are_found_by_name(bench):
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"], bench)
        assert callable(cell.config.program)
        assert os.path.isfile(os.path.join(ROOT, cell.config.DATA))
        assert callable(cell.reference.loglike)
        assert len(cell.reference.PRIORS) == cell.config.SIZES["n_params"]
        for k in ("mean", "sd", "log_mdd"):
            assert k in cell.posterior, (w["config"], k)
        assert len(cell.posterior["mean"]) == len(cell.reference.PRIORS)
        numbers = set(check.NUMBERS) | ({"ranks_gap"} if w["chips"] > 1
                                        else set())
        assert set(cell.limits) == numbers
        for k in ("smc", "ranks", "traced_estimations", "checked_share"):
            assert k in cell.mix, (w["traffic"], k)
        for m in cell.per_layer:
            assert callable(cell.reader(m["name"]).read)
        for k in cell.config.KERNELS:
            assert callable(spec.kernel_counts(k).work)
    for c in bench["configs"]:
        assert c["file"].startswith("perfbench/")


def test_a_full_check_of_24_cells_fits_its_time(bench):
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _py_files(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH_DIR, sub)):
        if os.sep + "tests" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_imports_jax_or_the_jax_package():
    for path in _py_files():
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax",
                                              "smc_tpu"), (path, name)


def test_the_reference_imports_nothing_of_the_program():
    for path in _py_files("reference"):
        for name in _imports(path):
            assert name.split(".")[0] != "smc_tpu_torch", (path, name)
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.reference import an_schorfheide, smets_wouters\n"
            "import perfbench.check, perfbench.kernels.kalman_general\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"smc_tpu_torch", "smc_tpu", "jax", "jaxlib"}


def test_a_run_loads_no_jax_module():
    """A whole run of a cell at a small size on the CPU, in its own process:
    what it has loaded once its window has closed holds no jax, jaxlib,
    flax or smc_tpu (top-level names compared whole)."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from perfbench import run\n"
        "from perfbench.tests._small import small_cell\n"
        "out = run.run(small_cell(), 7, 0.5, False, run.Rank('cpu'))\n"
        "print(json.dumps([run.forbidden_modules(), out['correct'],\n"
        "                  'smc_tpu_torch' in sys.modules]))\n" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    found, correct, program = json.loads(out.stdout.strip().splitlines()[-1])
    assert found == [] and program and correct


def test_run_refuses_without_a_card_and_prints_nothing():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import torch\n"
            "torch.cuda.is_available = lambda: False\n"
            "from perfbench import run\n"
            "sys.exit(run.main(['--workload', 'as-16k-fixed', '--seed', "
            "'5', '--seconds', '1', '--trace', '0']))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
