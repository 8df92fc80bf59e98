"""Cells of the benchmark cut to sizes a CPU test can run: the same
files, with the scene and the factory's arguments made small."""

import copy
import dataclasses
import json
from pathlib import Path

from portbench.core import spec as spec_mod

ROOT = Path(__file__).resolve().parent.parent.parent
SMALL = {"pile4k": ({"n_bodies": 256, "x_aspect": 4.0}, [256]),
         "envs4096x8": ({"n_envs": 16}, [16, 8])}
SETTLE = {"settled16": 32, "reset4": 16, "still32": 64}


def tiny_spec(workload: str, episode_calls: int = 4):
    bench = json.load(open(ROOT / "BENCHMARK.json"))
    spec = spec_mod.load(workload, bench)
    conf = copy.deepcopy(spec.conf)
    scene_kw, args = SMALL[conf["name"]]
    conf["scene"].update(scene_kw)
    conf["config"]["args"] = args
    from physics_tpu_torch import scenes
    c = conf["config"]
    cfg = getattr(scenes, c["factory"])(*args).replace(**c["overrides"])
    conf["sim"] = {k: (list(v) if isinstance(v, tuple) else v)
                   for k, v in dataclasses.asdict(cfg).items()}
    spec.conf = conf
    spec.traffic = dict(spec.traffic,
                        settle_steps=SETTLE[workload.split(".")[1]])
    if spec.traffic["episode_calls"]:
        spec.traffic["episode_calls"] = episode_calls
    return spec
