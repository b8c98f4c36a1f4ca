"""On the card: one short traced run of each cell through the command
the driver runs, its result line whole and correct.  Skips without an
NVIDIA GPU; run it there with
``python -m pytest -p no:cacheprovider gxbench/tests -m cuda``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from gxbench.cell import ROOT, load_cell
from gxbench.tests.tiny import ENCODER, RESNET


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels")


@pytest.mark.cuda
@pytest.mark.parametrize("name", [RESNET, ENCODER])
def test_a_short_traced_run(card, name):
    done = subprocess.run(
        [sys.executable, "gxbench/run.py", "--workload", name, "--seed",
         str(2 ** 33 + 5), "--seconds", "3", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stderr[-4000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"], done.stderr[-4000:]
    cell = load_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.per_layer}
    assert result["device"]["busy_s"] > 0
    assert list(result)[-1] == "checks"
