"""The plain reference against the port on a small scene on the CPU, and
the reference's chunked blend against one evaluated whole."""

from __future__ import annotations

import pytest
import torch

from benchmark import check, scene
from benchmark.programs.refine_step import Program
from benchmark.reference import blend
from benchmark.reference.refine_step import Reference
from benchmark.tests.small import CELLS, small_config


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_matches_the_port(cell):
    """Sound runs at this size read a first-step loss gap of 2-5e-7, gradient
    gaps of 2e-7 to 4e-6 and change gaps of 3e-6 to 2e-4 (the later steps
    move the mesh by the sign of area terms that sit at round-off)."""
    config = small_config(CELLS[cell])
    batch = scene.load_json("mixes", "b4" if cell.endswith("b4") else "b1")["cameras_per_step"]
    for seed in (3, 2**31 + 3):
        inputs = scene.make_scene(config, seed, "cpu")
        steps = scene.camera_schedule(seed, inputs.rig.n, batch)
        cams = [next(steps) for _ in range(3)]
        prog = check.program_readings(Program(inputs, config, "cpu"), cams)
        ref = check.reference_readings(Reference(inputs, config), cams)
        gaps = check.gaps(prog, ref)
        assert abs(prog["losses"][0] - ref["losses"][0]) <= 1e-5 * ref["losses"][0]
        assert gaps["grad_gap"] <= 1e-4
        assert gaps["change_gap"] <= 2e-3
        assert {"delta_t", "delta_r"} <= set(gaps["unmoved_leaves"])


def test_chunked_blend_equals_one_chunk(monkeypatch):
    g = torch.Generator().manual_seed(0)
    p, channels = 300, 4
    feats = torch.zeros(p, 6 + channels)
    feats[:, 0] = 48 * torch.rand(p, generator=g)
    feats[:, 1] = 32 * torch.rand(p, generator=g)
    feats[:, 2] = feats[:, 4] = 0.05 + 0.1 * torch.rand(p, generator=g)
    feats[:, 3] = 0.01 * torch.randn(p, generator=g)
    feats[:, 5] = torch.rand(p, generator=g)
    feats[:, 6:] = torch.rand(p, channels, generator=g)
    count = torch.tensor([120, 0, 40, 90, 30, 20])
    start = torch.cumsum(count, 0) - count
    cot = torch.randn(6, channels + 1, blend.PIX, generator=g)

    def run(limit):
        monkeypatch.setattr(blend, "CHUNK_ELEMS", limit)
        x = feats.clone().requires_grad_()
        out = blend.TileBlend.apply(x, start, count, 3, 48, 32, channels)
        (grad,) = torch.autograd.grad((out * cot).sum(), [x])
        return out, grad

    whole, g_whole = run(1 << 30)
    parts, g_parts = run(1)  # one tile a chunk
    assert torch.allclose(whole, parts, atol=1e-6)
    assert torch.allclose(g_whole, g_parts, atol=1e-5, rtol=1e-5)
    assert float(g_whole.abs().sum()) > 0
