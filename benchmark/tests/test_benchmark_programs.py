"""A configuration names its program (benchmark/programs/<program>.py): a
program other than the refine step, and a new cell of the refine step, run
through the harness from new files alone, each with its program's count of a
step's work and the per-layer metrics its program gives something to read;
the refine step's count is the one step_mfu made before programs were
named."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import bounds, harness, scene, spans, trace
from benchmark.metrics import step_mfu
from benchmark.programs import refine_step
from benchmark.tests.small import CELLS, small_config

REPO = Path(__file__).resolve().parents[2]
REFINE_ONLY = {"blend_fwd_roofline", "blend_bwd_roofline", "geometry_device_ms", "raster_fwd_device_ms",
               "pixel_loss_device_ms", "pixel_loss_bwd_device_ms", "mesh_loss_device_ms", "backward_device_ms",
               "adam_device_ms", "pairs_per_render"}
ANY_PROGRAM = {"device_idle_pct", "kernel_launches_per_iter", "host_syncs_per_iter", "step_mfu"}
CPU_PEAK = {"f32_flops": 1e9, "bytes_s": 1e9}  # a made-up peak, so that step_mfu reads on the CPU

# A second program: the plain reference in the program's place (TF32 off),
# training a quarter of each camera's pixels by its own count, at 1000
# operations a pixel.
SECOND_PROGRAM = '''"""The plain reference as a program, with its own count of a step's work."""

import functools

from benchmark.calibrate import ReferenceAsProgram

Program = functools.partial(ReferenceAsProgram, tf32=False)
SEEN = []


def pixels_per_step(inputs, config, mix):
    return inputs.rig.width * inputs.rig.height * mix["cameras_per_step"] // 4


def step_operations(run):
    SEEN.append({"steps": run.steps, "window_s": run.window_s})
    return 1000.0 * run.pixels_per_step
'''

# Runs of the second program's cell, untraced and traced, and a traced run
# of a new refine cell; each Run train_mpix_s got, and what the second
# program counted.
DRIVER = '''
import json, sys
import torch
torch.set_num_threads(1)
from benchmark import bounds, harness
from benchmark.metrics import train_mpix_s
bounds.PEAKS["cpu"] = %r
seen, read = [], train_mpix_s.read
def recording(run):
    seen.append({"steps": run.steps, "window_s": run.window_s, "pixels": run.pixels_per_step})
    return read(run)
train_mpix_s.read = recording
quiet = lambda *a: None
out = [harness.run_cell("second.sphere.b1", 2**31 + 21, 0.3, traced, device="cpu", log=quiet)
       for traced in (False, True)]
out.append(harness.run_cell("refine.sphere160.b4", 2**31 + 22, 0.3, True, device="cpu", log=quiet,
                            config=json.loads(sys.argv[1])))
from benchmark.programs import second_step
print(json.dumps({"runs": out, "pixels": seen, "operations": second_step.SEEN}))
''' % (CPU_PEAK,)


def test_a_second_program_runs_from_new_files_alone(tmp_path):
    """BENCHMARK.json and the benchmark's files as they are, plus new files
    (the program's module, a configuration that names it, the new cells'
    limits) and new entries (two cells, on train_mpix_s's `workloads` and
    listed in no per-layer metric's). The second program's train_mpix_s and step_mfu come from
    its own counts, and the refine-only metrics' readers find nothing to
    read for it; the new refine cell reads them."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "benchmark/programs/second_step.py").write_text(SECOND_PROGRAM)
    config = small_config("gaustar_sphere160")
    config.update(name="second_sphere", program="second_step")
    (tmp_path / "benchmark/configs/second_sphere.json").write_text(json.dumps(config))
    for cell in ("second.sphere.b1", "refine.sphere160.b4"):
        shutil.copy(REPO / "benchmark/limits/refine.sphere160.b1.json", tmp_path / f"benchmark/limits/{cell}.json")
    spec = harness.benchmark_spec()
    spec["configs"].append({"name": "second_sphere", "source": "test", "file": "benchmark/configs/second_sphere.json",
                            "reduced": [], "why": "a second program"})
    spec["workloads"] += [{"name": "second.sphere.b1", "config": "second_sphere", "traffic": "b1", "chips": 1,
                           "why": "a second program"},
                          {"name": "refine.sphere160.b4", "config": "gaustar_sphere160", "traffic": "b4", "chips": 1,
                           "why": "a new cell of the refine step"}]
    next(m for m in spec["end_to_end"] if m["name"] == "train_mpix_s")["workloads"] += [
        "second.sphere.b1", "refine.sphere160.b4"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    env = dict(os.environ, PYTHONPATH=str(REPO))  # the port; the copy's benchmark/ comes first
    proc = subprocess.run([sys.executable, "-c", DRIVER, json.dumps(small_config("gaustar_sphere160"))], cwd=tmp_path,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    plain, traced, refine = got["runs"]
    assert plain["correct"] is True and traced["correct"] is True and refine["correct"] is True

    rec = got["pixels"][0]
    rig = config["rig"]
    assert rec["pixels"] == rig["width"] * rig["height"] // 4
    assert plain["metrics"]["train_mpix_s"]["value"] == rec["pixels"] * rec["steps"] / rec["window_s"] / 1e6

    assert set(traced["metrics"]) <= ANY_PROGRAM and not REFINE_ONLY & set(traced["metrics"])
    (ops,) = got["operations"]
    assert traced["metrics"]["step_mfu"]["value"] == (
        100.0 * (1000.0 * rec["pixels"]) * ops["steps"] / (CPU_PEAK["f32_flops"] * ops["window_s"]))
    # What the CPU reads of the ten: not the blend rooflines, which need kernels.
    assert set(spans.LAYERS) | {"pairs_per_render", "step_mfu"} <= set(refine["metrics"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_refine_step_count_is_unchanged(cell, monkeypatch):
    """On a small traced run the refine step's count reads the traced
    window's blend calls, and step_mfu divides that count by the peak."""
    runs, count = [], refine_step.step_operations

    def recording(run):
        runs.append(run)
        return count(run)

    monkeypatch.setattr(refine_step, "step_operations", recording)
    monkeypatch.setitem(bounds.PEAKS, "cpu", CPU_PEAK)
    config = small_config(CELLS[cell])
    out = harness.run_cell(cell, 2**31 + 23, 0.3, True, device="cpu", config=config, log=lambda *a: None)
    (run,) = runs
    assert bounds.blend_calls(run.trace), "the traced window captured no blend call"
    rig = config["rig"]
    mix = next(w["traffic"] for w in harness.benchmark_spec()["workloads"] if w["name"] == cell)
    assert run.pixels_per_step == rig["width"] * rig["height"] * scene.load_json("mixes", mix)["cameras_per_step"]
    assert run.operations_per_step == count(run) > 0
    assert step_mfu.read(run) == (
        100.0 * run.operations_per_step * run.steps / (CPU_PEAK["f32_flops"] * run.window_s))
    if "step_mfu" in out["metrics"]:  # the cells whose throughput is train_mpix_s
        assert out["metrics"]["step_mfu"]["value"] == step_mfu.read(run)
    read = {name.split(".")[0] for name in out["metrics"]}
    assert set(spans.LAYERS) | {"pairs_per_render"} <= read  # what the CPU reads of the ten


def test_refine_step_mfu_reads_as_before_programs_were_named():
    """step_mfu of the refine step's count on a hand-built trace of three
    blend calls in four steps, against the value the former step_mfu
    (which counted the step itself) read from the same run."""
    t = trace.Trace(steps=4, window=(0.0, 1.0), issued=1.0, device=[], kernels=[], runtime=[], host=[], captures={},
                    memo={"blend_counts": [{"fwd_ops": 1.5e9, "bwd_ops": 3.25e9}, {"fwd_ops": 2.0e9, "bwd_ops": 4.0e9},
                                           {"fwd_ops": 1.75e9, "bwd_ops": 3.5e9}]})
    run = harness.Run(setup_s=10.0, window_s=51.25, steps=1234, pixels_per_step=4 * 1600 * 1024, cameras_per_step=4,
                      param_elements=600_000 * 62, device_kind="NVIDIA H100 80GB HBM3", trace=t)
    run.operations_per_step = refine_step.step_operations(run)
    assert step_mfu.read(run) == 0.5031790671772843
