"""BENCHMARK.json and the files it names: a cell's configuration
(configs/<config>.py), traffic mix (mixes/<traffic>.json), limits of the
correctness check (limits/<cell>.json), the plain reference
(reference/<config>.py) and its posterior (posteriors/<config>.json),
the per-layer metrics' readers
(metrics/<metric>.py) and the kernels' work counts
(kernels/<kernel>.py). Everything is found by the names that
BENCHMARK.json gives, so a cell, a mix, a configuration or a metric is
added as new files and an entry there, with no edit to this code."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def load_module(path: str, name: str):
    """The module in the file `path` (relative to perfbench/), loaded under
    `name`; raises FileNotFoundError where there is no such file."""
    full = os.path.join(HERE, path)
    if not os.path.isfile(full):
        raise FileNotFoundError(f"{full}: no such file")
    spec = importlib.util.spec_from_file_location(name, full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One entry of `workloads`, with everything it names loaded."""

    name: str
    chips: int
    config: object              # configs/<config>.py
    mix: dict                   # mixes/<traffic>.json
    limits: Dict[str, float]    # limits/<cell>.json
    reference: object           # reference/<config>.py
    posterior: Optional[dict]   # posteriors/<config>.json (posterior.py)
    end_to_end: List[dict]      # the end-to-end metrics this cell reports
    per_layer: List[dict]       # the per-layer metrics this cell reports

    def reader(self, metric: str):
        """metrics/<metric>.py."""
        return load_module(f"metrics/{metric}.py",
                           f"perfbench_metric_{metric.replace('.', '_')}")


def kernel_counts(name: str):
    """kernels/<name>.py: a kernel's work on given inputs."""
    return importlib.import_module(f"perfbench.kernels.{name}")


def read_benchmark(path: str = BENCHMARK) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None,
              mix: Optional[dict] = None) -> Cell:
    """The cell `name` of BENCHMARK.json; `mix` replaces the mix's file
    (the tests' small sizes)."""
    bench = bench or read_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (there are "
                       f"{sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = configs[w["config"]]
    config = load_module(os.path.relpath(os.path.join(ROOT, cfg["file"]),
                                         HERE),
                         f"perfbench_config_{w['config']}")
    if mix is None:
        with open(os.path.join(HERE, "mixes", f"{w['traffic']}.json")) as f:
            mix = json.load(f)
    with open(os.path.join(HERE, "limits", f"{name}.json")) as f:
        limits = json.load(f)
    reference = importlib.import_module(
        f"perfbench.reference.{w['config']}")
    table = os.path.join(HERE, "posteriors", f"{w['config']}.json")
    posterior = None
    if os.path.isfile(table):
        with open(table) as f:
            posterior = json.load(f)
    return Cell(name=name, chips=int(w["chips"]), config=config, mix=mix,
                limits=limits, reference=reference, posterior=posterior,
                end_to_end=[m for m in bench["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _reports(m, name)])
