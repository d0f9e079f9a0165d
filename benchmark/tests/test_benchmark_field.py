"""The field cell (ngp_body160, program and reference field_step) on a small
scene on the CPU: it runs end to end and reads correct, its new per-layer
metrics read there and nowhere else, a refine cell's traced run works with
a port that lacks the field step (as at the commit before it), the
roofline's distinct rows equal a brute-force count, the step's operations
are the configuration's, and a state left unchanged is not correct."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from benchmark import bounds, field_bounds, harness, scene
from benchmark.programs import field_step as field_program
from benchmark.reference import field_step as ref
from benchmark.tests.small import small_config

CELL = "field.body160.r8192"
FIELD_METRICS = {"field_encode_device_ms", "field_mlp_device_ms", "field_composite_device_ms",
                 "field_backward_device_ms", "field_adam_device_ms", "field_samples_per_step", "hash_encode_roofline"}
CPU_PEAK = {"f32_flops": 1e9, "bytes_s": 1e9}  # a made-up peak, so that the roofline reads on the CPU


def small_field_config() -> dict:
    """ngp_body160 at 8 cameras of 64x48 (the body inside the frame), 4
    levels of 2^12 rows, 8 samples a ray, a 16^3 occupancy grid; the mix's
    8,192 rays a step."""
    c = copy.deepcopy(scene.load_json("configs", "ngp_body160"))
    c["mesh"]["n_lat"], c["mesh"]["n_lon"] = 9, 12
    rig = c["rig"]
    rig["focal"] = rig["focal"] * 64 / rig["width"]
    rig["width"], rig["height"] = 64, 48
    for ring in rig["rings"]:
        ring["cameras"] = 4
    c["field"].update(n_levels=4, table_size=1 << 12, base_res=4, max_res=32, n_samples=8)
    c["train"].update(occupancy_res=16)
    return c


@pytest.mark.parametrize("traced", [False, True], ids=["trace0", "trace1"])
def test_field_cell_runs_end_to_end_on_cpu(traced, capsys, monkeypatch):
    monkeypatch.setitem(bounds.PEAKS, "cpu", CPU_PEAK)
    config = small_field_config()
    out = harness.run_cell(CELL, 2**31 + 5, 0.3, traced, device="cpu", config=config)
    harness.emit(out)
    stdout = capsys.readouterr().out
    line = json.loads(stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["checks"]["loss_gap"]["value"] <= line["checks"]["loss_gap"]["limit"]
    if not traced:
        assert not FIELD_METRICS & set(line["metrics"])
        return
    assert FIELD_METRICS <= set(line["metrics"])
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["field_samples_per_step"] == 8192 * config["field"]["n_samples"]
    assert all(m[k] > 0 for k in FIELD_METRICS)
    assert 0 < m["hash_encode_roofline"]
    assert "kernel_launches_per_iter.device" in m  # device_mfu needs device time: none on the CPU
    assert any(ln.startswith("# field spans:") for ln in stdout.splitlines())
    assert not {"geometry_device_ms.device", "pairs_per_render.device", "blend_fwd_roofline.device"} & set(m)


def test_refine_cell_reads_no_field_metric_and_needs_no_field_step(monkeypatch):
    """A traced refine run lists the field metrics (they move device_mpix_s)
    but reads none of them, also where the port has no field_step."""
    from gaustar_tpu_torch.train import init_mesh

    monkeypatch.delattr(init_mesh, "field_step")
    out = harness.run_cell("refine.sphere160.b1", 2**31 + 6, 0.3, True, device="cpu",
                           config=small_config("gaustar_sphere160"), log=lambda *a: None)
    assert out["correct"] is True
    assert not FIELD_METRICS & set(out["metrics"])
    names = {m["name"] for m in harness.cell_metrics(harness.benchmark_spec(), "refine.sphere160.b1", True)}
    assert FIELD_METRICS <= names


def test_distinct_rows_equal_a_brute_force_count():
    gen = torch.Generator().manual_seed(8)
    pts = torch.rand((300, 3), generator=gen)
    pts[:30] = pts[30:60]  # repeated points share rows
    pts[60:70] = 1.0  # the far corner
    for res, table_size, dense in ((6, 1 << 10, True), (40, 1 << 10, False), (2047, 1 << 19, False)):
        rows = set()
        for p in pts.tolist():
            c0 = [int(torch.floor(torch.tensor(v, dtype=torch.float32) * res)) for v in p]
            for k in range(8):
                c = [c0[a] + ((k >> a) & 1) for a in range(3)]
                if dense:
                    r = c[0] + (res + 1) * c[1] + (res + 1) ** 2 * c[2]
                else:
                    r = (c[0] * 1) ^ ((c[1] * 2654435761) & 0xFFFFFFFF) ^ ((c[2] * 805459861) & 0xFFFFFFFF)
                rows.add(r % table_size)
        assert field_bounds.distinct_rows(pts, res, table_size, dense) == len(rows)


def test_encode_counts_and_step_operations():
    config = scene.load_json("configs", "ngp_body160")
    f = config["field"]
    cfg = field_program.field_config(config)
    pts = torch.rand((1000, 3), generator=torch.Generator().manual_seed(9))
    c = field_bounds.encode_counts((16, 1 << 19, 2), pts, cfg)
    res = ref.level_resolutions(16, 16, 2048)
    assert c["ops"] == 1000 * 16 * 8 * 6
    assert c["bytes"] == 8 * sum(c["rows"]) + 12 * 1000
    assert c["rows"] == [field_bounds.distinct_rows(pts, r, 1 << 19, (r + 1) ** 3 <= 1 << 19) for r in res]
    gemm = 3 * 2 * (32 * 64 + 64 * 16 + 32 * 64 + 64 * 64 + 64 * 3)
    params = 16 * (1 << 19) * 2 + sum(i * o + o for i, o in [(32, 64), (64, 16), (32, 64), (64, 64), (64, 3)])
    want = 8192 * 128 * (16 * 8 * 6 + gemm + field_program.COMPOSITE_OPS_PER_SAMPLE) + 12 * params
    assert field_program.operations(f, 8192, params) == want


class Unchanged(field_program.Program):
    """A step that leaves the state as it was."""

    def step(self, cams, iteration):
        return torch.zeros(())


def test_state_left_unchanged_is_not_correct():
    out = harness.run_cell(CELL, 2**31 + 11, 0.2, False, device="cpu", config=small_field_config(),
                           make_program=Unchanged, log=lambda *a: None)
    assert out["correct"] is False
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", ["control_tf32", "bf16_encoding", "wrong_prime"])
def test_control_and_faults_are_not_correct(fault):
    """The reference in TF32 in the program's place, the encoding in
    bfloat16, and one hashed level's rows under a wrong prime each fail the
    cell's limits (benchmark/calibrate_field.py plants them)."""
    import contextlib

    from benchmark import calibrate, calibrate_field

    config = small_field_config()
    make, ctx = field_program.Program, contextlib.nullcontext
    if fault == "control_tf32":
        make = calibrate.ReferenceAsProgram
    elif fault == "bf16_encoding":
        ctx = calibrate_field.encoding_in_bf16
    else:
        ctx = calibrate_field.wrong_prime(3, config["field"])
    with ctx():
        out = harness.run_cell(CELL, 2**31 + 12, 0.2, False, device="cpu", config=config, make_program=make,
                               log=lambda *a: None)
    assert out["correct"] is False
    assert out["checks"]["grad_gap"]["value"] > out["checks"]["grad_gap"]["limit"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [CELL, "refine.sphere160.b4"])
def test_new_cell_on_the_card(cell):
    """The new cells' command on a card: a short run that exits 0 with
    `correct` true. Run with `python -m pytest --noconftest -m gpu
    benchmark/tests/test_benchmark_field.py`."""
    import subprocess
    import sys
    from pathlib import Path

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", "78", "--seconds", "2",
                          "--trace", "0"], cwd=Path(__file__).resolve().parents[2], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
