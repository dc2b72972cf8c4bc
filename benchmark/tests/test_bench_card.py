"""One short run of each one-card cell on the card, as the driver makes
it (a new process from the checkout's root).  Skips without a card; on
the card: ``python -m pytest benchmark/tests/test_bench_card.py
--noconftest -m cuda``."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.manifest import ROOT, load_manifest

ONE_CARD = [w["name"] for w in load_manifest()["workloads"]
            if w["chips"] == 1]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark measures the card only")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_short_run_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "6000000011", "--seconds", "8", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
