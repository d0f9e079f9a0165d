"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (gaustar_tpu_torch begins with gaustar_tpu), and the
benchmark's yardstick loads nothing of the program."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "gaustar_tpu"}


def modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0] for m in sys.modules}))"],
                         cwd=REPO, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    loaded = modules_after(
        "from benchmark import harness\n"
        "from benchmark.tests.small import small_config\n"
        "for cell, cfg in (('refine.sphere160.b1', 'gaustar_sphere160'), ('refine.body160.b4', 'gaustar_body160')):\n"
        "    harness.run_cell(cell, 5, 0.2, True, device='cpu', config=small_config(cfg), log=lambda *a: None)\n"
        "assert not harness.loaded_forbidden()")
    assert "gaustar_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_yardstick_loads_nothing_of_the_program():
    loaded = modules_after(
        "import benchmark.bounds, benchmark.check, benchmark.scene, benchmark.trace\n"
        "import benchmark.reference.refine_step, benchmark.reference.blend\n"
        "import benchmark.gt.dented_sphere, benchmark.gt.textured_body\n"
        "import importlib, pathlib\n"
        "for p in pathlib.Path('benchmark/metrics').glob('[a-z]*.py'):\n"
        "    importlib.import_module('benchmark.metrics.' + p.stem)")
    assert not loaded & (FORBIDDEN | {"gaustar_tpu_torch"})
