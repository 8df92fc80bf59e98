"""run.py end to end: without a card it exits 2 and prints no result;
from a directory that holds only BENCHMARK.json and portbench/ it exits
with another code than 0; on the card (marked cuda) one short run
prints its JSON result line with correct true."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.tests.tiny import ROOT

CMD = [sys.executable, "portbench/run.py", "--workload",
       "pile4k.settled16", "--seed", str(2**31 + 99), "--seconds", "1",
       "--trace", "0"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 2
    assert r.stdout.strip() == ""


def test_alone_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(CMD, cwd=tmp_path, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"correct"' not in r.stdout


@pytest.mark.cuda
def test_one_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    r = subprocess.run(CMD, cwd=ROOT, capture_output=True, text=True,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last["correct"] is True
    assert set(last["metrics"]) == {"body_steps_per_s", "call_ms_p95",
                                    "setup_s"}
    assert last["device"]["platform"] == "gpu"
    assert list(last)[-1] == "checks"
