"""The harness finds its files by name, each cell runs end to end on a small
scene on the CPU, and the command refuses to run without a card."""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness, scene
from benchmark.tests.small import CELLS, small_config

REPO = Path(__file__).resolve().parents[2]


def test_cells_find_their_files_by_name():
    spec = harness.benchmark_spec()
    for cell in spec["workloads"]:
        config = scene.load_json("configs", cell["config"])
        mix = scene.load_json("mixes", cell["traffic"])
        limits = scene.load_json("limits", cell["name"])
        assert set(limits) == {"loss_gap", "grad_gap", "change_gap"}
        assert mix["cameras_per_step"] >= 1 and mix["check_steps"] >= 1 and mix["trace_steps"] >= 1
        importlib.import_module(f"benchmark.gt.{config['gt']['kind']}")
        assert hasattr(importlib.import_module(f"benchmark.reference.{config['reference']}"), "Reference")
        program = harness.program_module(config)
        assert all(hasattr(program, k) for k in ("Program", "pixels_per_step", "step_operations"))
    for entry in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.reader(entry["name"]).read)
    for entry in spec["configs"]:
        assert (REPO / entry["file"]).exists()
        assert scene.load_json("configs", entry["name"])["name"] == entry["name"]


def test_seeded_inputs_repeat_and_take_large_seeds():
    config = small_config("gaustar_body160")
    seed = 2**31 + 12345
    a, b = scene.make_scene(config, seed, "cpu"), scene.make_scene(config, seed, "cpu")
    c = scene.make_scene(config, seed + 1, "cpu")
    assert torch.equal(a.colors, b.colors) and torch.equal(a.gt_images, b.gt_images)
    assert not torch.equal(a.colors, c.colors)
    steps = scene.camera_schedule(seed, 8, 4)
    first = [next(steps) for _ in range(2)]
    assert sorted(first[0] + first[1]) == list(range(8))


def test_uv_ellipsoid_counts_and_winding():
    verts, faces = scene.uv_ellipsoid(201, 250, (0.0, 0.0, 4.0), (0.6, 0.6, 0.6), "cpu")
    assert faces.shape == (100_000, 3) and verts.shape == (2 + 200 * 250, 3)
    fv = verts[faces]
    normal = torch.linalg.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    outward = fv.mean(1) - torch.tensor([0.0, 0.0, 4.0])
    assert bool(((normal * outward).sum(-1) > 0).all())


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_runs_end_to_end_on_cpu(cell, traced, capsys):
    out = harness.run_cell(cell, 2**31 + 7, 0.5, traced, device="cpu", config=small_config(CELLS[cell]))
    harness.emit(out)
    stdout, stderr = capsys.readouterr()
    line = json.loads(stdout.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert stderr.strip().splitlines()[-1].startswith("check change_gap ")
    assert line["device"]["platform"] == "cpu"
    names = {m["name"] for m in harness.cell_metrics(harness.benchmark_spec(), cell, traced)}
    assert set(line["metrics"]) <= names
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"]) and "breakdown" in line
        assert "kernel_launches_per_iter" in {name.split(".")[0] for name in line["metrics"]}
    else:
        # A CPU run has no device time for a reader of the traced steps.
        on_host = {name for name in names if not getattr(harness.reader(name), "TRACE", False)}
        assert on_host <= set(line["metrics"])
        assert all(m["value"] > 0 for m in line["metrics"].values())


def test_each_cell_reports_what_its_metrics_move():
    """Every cell reports setup_s and another end-to-end metric; a per-layer
    metric runs in the cells that report the metric it moves, and its
    `workloads` list names only such cells; each cell reads some per-layer
    metric."""
    spec = harness.benchmark_spec()
    for cell in spec["workloads"]:
        end_to_end = {m["name"] for m in harness.cell_metrics(spec, cell["name"], False)}
        assert "setup_s" in end_to_end and len(end_to_end) >= 2
        per_layer = harness.cell_metrics(spec, cell["name"], True)
        assert per_layer and all(m["moves"] in end_to_end for m in per_layer)
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", [])) <= cells
    for m in spec["per_layer"]:
        for cell in m.get("workloads", []):
            assert m in harness.cell_metrics(spec, cell, True)


def test_device_metrics_read_the_busy_time():
    """device_mpix_s and device_mfu divide by the union of the traced steps'
    device intervals, overlaps counted once and idle gaps not at all."""
    from benchmark import bounds, trace
    from benchmark.metrics import device_mfu, device_mpix_s

    device = [("a", 1.000, 1.004), ("b", 1.003, 1.006), ("c", 1.008, 1.010), ("d", 1.030, 1.040)]
    t = trace.Trace(steps=2, window=(1.0, 1.020), issued=1.015, device=device, kernels=device, runtime=[], host=[],
                    captures={})
    run = harness.Run(setup_s=10.0, window_s=51.0, steps=1000, pixels_per_step=1600 * 1024, cameras_per_step=1,
                      param_elements=100, device_kind="NVIDIA H100 80GB HBM3", trace=t, operations_per_step=4.0e9)
    assert device_mpix_s.TRACE is True
    assert abs(t.busy_s() - 0.008) < 1e-12
    assert device_mpix_s.read(run) == 1600 * 1024 * 2 / t.busy_s() / 1e6
    peak = bounds.PEAKS["NVIDIA H100 80GB HBM3"]["f32_flops"]
    assert device_mfu.read(run) == 100.0 * 4.0e9 * 2 / (peak * t.busy_s())
    idle = trace.Trace(steps=2, window=(1.0, 1.020), issued=1.015, device=[], kernels=[], runtime=[], host=[],
                       captures={})
    run.trace = idle
    assert device_mpix_s.read(run) is None and device_mfu.read(run) is None


def test_command_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "refine.sphere160.b1", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "refine.sphere160.b1", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
