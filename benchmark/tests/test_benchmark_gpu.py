"""Each cell's command on a card: a short run that exits 0 with `correct`
true. Run on the card with `python -m pytest --noconftest -m gpu
benchmark/tests/test_benchmark_gpu.py` (the repository's root conftest
imports JAX)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["refine.sphere160.b1", "refine.body160.b4"])
def test_cell_on_the_card(card, cell):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "77", "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
