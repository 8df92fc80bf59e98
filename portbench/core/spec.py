"""The cell a run measures, found by name: its entry in BENCHMARK.json,
its configuration file, the configuration's scene builder
(scenes/<builder>.py) and reference (reference/<reference>.py), its
traffic file (traffic/<traffic>.json) and the call shape it names
(calls/<call>.py), its correctness limits (checks/<workload>.json) and
the reader of each of its metrics (metrics/<name>.py). A name that is
not there fails the run."""

from __future__ import annotations

import importlib
import json
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent.parent      # portbench/
ROOT = HERE.parent


def _load(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path.relative_to(ROOT)}")
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """portbench/<kind>/<name>.py, imported."""
    if not (HERE / kind / f"{name}.py").is_file():
        raise FileNotFoundError(f"{kind} {name!r}: no file "
                                f"portbench/{kind}/{name}.py")
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_reader(name: str):
    """metrics/<name>.py: its `read(ctx)`, and its `least(st, cfg, s)`
    where the metric is a roofline."""
    mod = module("metrics", name)
    if not callable(getattr(mod, "read", None)):
        raise AttributeError(f"portbench/metrics/{name}.py has no read")
    return mod


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell `workload` of BENCHMARK.json (or of `bench`)."""
    if bench is None:
        bench = _load(ROOT / "BENCHMARK.json", "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(cells)}")
    cell = cells[workload]
    confs = {c["name"]: c for c in bench["configs"]}
    if cell["config"] not in confs:
        raise KeyError(f"workload {workload}: unknown config "
                       f"{cell['config']!r}")
    conf = _load(ROOT / confs[cell["config"]]["file"],
                 f"config {cell['config']}")
    traffic = _load(HERE / "traffic" / f"{cell['traffic']}.json",
                    f"traffic {cell['traffic']}")
    limits = _load(HERE / "checks" / f"{workload}.json",
                   f"correctness limits of {workload}")
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload)]
    layer = [m for m in bench["per_layer"] if _listed(m, workload)]
    readers = {m["name"]: metric_reader(m["name"]) for m in layer}
    return SimpleNamespace(
        name=workload, chips=cell["chips"], conf=conf, traffic=traffic,
        limits=limits["limits"], end_to_end=e2e, per_layer=layer,
        readers=readers,
        builder=module("scenes", conf["scene"]["builder"]),
        reference=module("reference", conf["reference"]),
        call=module("calls", traffic["call"]).Call)
