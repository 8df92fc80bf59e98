"""The harness finds every configuration, traffic mix, limit file and
metric reader by its name in BENCHMARK.json, and fails on a name it
cannot find."""

import copy
import json

import pytest

from portbench.core import spec as spec_mod
from portbench.tests.tiny import ROOT

BENCH = json.load(open(ROOT / "BENCHMARK.json"))
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves(workload):
    spec = spec_mod.load(workload, BENCH)
    assert spec.conf["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == workload)
    assert set(spec.limits) == {"pose_gap_m", "vel_gap_m_s", "lam_gap_Ns",
                                "key_mismatch"}
    names = {m["name"] for m in spec.per_layer}
    assert set(spec.readers) == names
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"}


def test_sweep_roofline_only_where_listed():
    assert "sweep_roofline_pct" in spec_mod.load("pile4k.settled16",
                                                 BENCH).readers
    assert "sweep_roofline_pct" not in spec_mod.load("envs4096x8.reset4",
                                                     BENCH).readers


@pytest.mark.parametrize("what", ["workload", "config", "traffic", "metric",
                                  "builder", "reference", "call"])
def test_unknown_names_fail(what, monkeypatch):
    bench = copy.deepcopy(BENCH)
    name = "pile4k.settled16"
    if what == "workload":
        name = "no_such.cell"
    elif what == "config":
        bench["workloads"][0]["config"] = "no_such_config"
    elif what == "traffic":
        bench["workloads"][0]["traffic"] = "no_such_mix"
    elif what == "metric":
        bench["per_layer"].append(dict(bench["per_layer"][0],
                                       name="no_such_metric"))
    else:
        loads = spec_mod._load

        def renamed(path, label):
            got = loads(path, label)
            if what == "call" and label.startswith("traffic"):
                got = dict(got, call="no_such_call")
            elif what != "call" and label.startswith("config"):
                got = copy.deepcopy(got)
                if what == "builder":
                    got["scene"]["builder"] = "no_such_builder"
                else:
                    got["reference"] = "no_such_reference"
            return got
        monkeypatch.setattr(spec_mod, "_load", renamed)
    with pytest.raises((KeyError, FileNotFoundError)):
        spec_mod.load(name, bench)


@pytest.mark.parametrize("workload", CELLS)
def test_modules_found_by_name(workload):
    """The scene builder, the reference and the call shape are the files
    the configuration and the traffic name."""
    spec = spec_mod.load(workload, BENCH)
    assert spec.builder.__name__ == (
        f"portbench.scenes.{spec.conf['scene']['builder']}")
    assert spec.reference.__name__ == (
        f"portbench.reference.{spec.conf['reference']}")
    assert spec.call.__module__ == f"portbench.calls.{spec.traffic['call']}"


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_files_match_the_program(name):
    """The factory and overrides give the file's "sim" values, and the
    configuration's file is the one BENCHMARK.json names."""
    from portbench.core.program import program_config

    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    conf = json.load(open(ROOT / entry["file"]))
    assert conf["name"] == name and conf["reduced"] == entry["reduced"]
    program_config(conf)
    bad = copy.deepcopy(conf)
    bad["sim"]["contact_iters"] += 1
    with pytest.raises(ValueError):
        program_config(bad)
