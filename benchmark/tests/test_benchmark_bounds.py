"""The blend's operation and byte counts against a count by hand, and the
count module's independence from the program."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

from benchmark import bounds
from benchmark.reference.blend import PIX, walk

REPO = Path(__file__).resolve().parents[2]


def two_tiles():
    """A 32x16 image of two 16x16 tiles, 3 channels. Every pair has a flat
    footprint (conic 0, so power 0 and alpha = min(0.99, opacity)).
    Tile 0: opacities 0.99, 0.9, 0.95, 0.5: T goes 1 -> 0.01 -> 1e-3, and
    the third pair would take it to 5e-5 < 1e-4, so every pixel stops
    there: 3 pairs tested, 2 included, the fourth never read.
    Tile 1: opacities 0.5, 0.001: the second is below 1/255 and skipped;
    2 tested, 1 included."""
    ops = [0.99, 0.9, 0.95, 0.5, 0.5, 0.001]
    pd = torch.zeros(9, len(ops))
    pd[0], pd[1] = 8.0, 8.0
    pd[5] = torch.tensor(ops)
    pd[6:] = 0.5
    start = torch.tensor([0, 4], dtype=torch.int32)
    count = torch.tensor([4, 2], dtype=torch.int32)
    return pd, start, count, 2, 32, 16, 3


def test_walk_by_hand():
    pd, start, count, gx, w, h, c = two_tiles()
    out = walk(pd[:6 + c].T.contiguous(), start.long(), count.long(), gx, w, h, c)
    assert out["tested"].tolist() == [3 * PIX, 2 * PIX]
    assert out["included"].tolist() == [2 * PIX, 1 * PIX]
    assert out["reach"].tolist() == [3, 2]
    assert out["back_tested"].tolist() == [2 * PIX, 1 * PIX]
    assert out["back_reach"].tolist() == [2, 1]


def test_blend_counts_by_hand():
    c = bounds.blend_counts(*two_tiles())
    tested, included, back_tested = 5 * PIX, 3 * PIX, 3 * PIX
    assert c["fwd_ops"] == 16 * tested + (4 + 2 * 3) * included
    assert c["fwd_bytes"] == 4 * 9 * (3 + 2) + 8 * 2 + 4 * PIX * (3 + 2) * 2
    assert c["bwd_ops"] == 16 * back_tested + (29 + 8 * 3 + 9 + 3) * included
    assert c["bwd_bytes"] == 8 * 9 * (2 + 1) + 8 * 2 + 4 * PIX * (3 + 3) * 2
    peak = bounds.PEAKS["NVIDIA H100 80GB HBM3"]
    assert bounds.bound_s(c["fwd_ops"], c["fwd_bytes"], peak) == max(c["fwd_ops"] / 67e12, c["fwd_bytes"] / 3.35e12)


def test_pixels_outside_the_image_walk_nothing():
    pd, start, count, gx, w, h, c = two_tiles()
    out = walk(pd[:6 + c].T.contiguous(), start.long(), count.long(), gx, 24, h, c)
    assert out["tested"].tolist() == [3 * PIX, 2 * PIX // 2]


def test_counts_import_nothing_of_the_program():
    code = ("import sys; import benchmark.bounds, benchmark.reference.refine_step; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'gaustar_tpu_torch', 'gaustar_tpu', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def traced(kernel_names, captured):
    """A Trace of one step whose kernels have the given names, with the
    two-tile render captured `captured` times."""
    from benchmark import trace

    kernels = [(name, 0.1 + 0.01 * i, 0.105 + 0.01 * i) for i, name in enumerate(kernel_names)]
    calls = [(two_tiles(), {})] * captured
    return trace.Trace(1, (0.0, 1.0), 0.9, kernels, kernels, [], [], {bounds.BLEND_CAPTURE: calls})


def test_rooflines_fail_where_calls_and_kernels_disagree():
    import pytest

    from benchmark.harness import Run

    def run_of(t):
        return Run(1.0, 1.0, 1, 512, 1, 10, "NVIDIA H100 80GB HBM3", t)

    blend = ["blend_test_kernel", "blend_chain_kernel", "blend_scan_kernel", "blend_grad_kernel"]
    sound = run_of(traced(["elementwise_add"] + blend, 1))
    assert 0 < bounds.roofline(sound, "fwd") < 100 and 0 < bounds.roofline(sound, "bwd") < 100
    with pytest.raises(RuntimeError, match="another path"):
        bounds.roofline(run_of(traced(blend, 0)), "fwd")
    with pytest.raises(RuntimeError, match="no kernel named"):
        bounds.roofline(run_of(traced(["elementwise_add", "renamed_blend"], 1)), "bwd")
    # No kernel recorded at all (the CPU): nothing to read, and no failure.
    assert bounds.roofline(run_of(traced([], 1)), "fwd") is None
