"""The field initializer's reference-scale run and the ray-batch sweep
(refscale/field_init.py, refscale/field_batch.py) against the JAX
repository's examples/refscale_field_init.py and
examples/profile_field_batch.py, on the CPU at small sizes."""

import ast
import json
import types

import numpy as np
import pytest
import torch

from gaustar_tpu.utils.synthetic import ring_cameras as jax_ring_cameras
from gaustar_tpu_torch.refscale import field_batch, field_init
from gaustar_tpu_torch.utils.synthetic import ring_cameras
from port_examples import ROOT, load_example
from port_helpers import one_thread  # noqa: F401  (autouse)

W, H, FOCAL, CAMS = 64, 40, 64.0, 3


def test_analytic_views_match_the_script():
    """RGB and masks equal the script's analytic_views exactly."""
    ns = load_example("refscale_field_init", W=W, H=H)
    want = ns["analytic_views"](jax_ring_cameras(CAMS, w=W, h=H, focal=FOCAL))
    got = field_init.analytic_views(ring_cameras(CAMS, w=W, h=H, focal=FOCAL, device="cpu"))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert 0 < want[1].mean() < 1


def _script_iso(dens, cap):
    """The script's own expression for the iso level (main's `iso = ...`)."""
    path = ROOT / "examples" / "refscale_field_init.py"
    main = next(n for n in ast.parse(path.read_text()).body if isinstance(n, ast.FunctionDef) and n.name == "main")
    node = next(n for n in ast.walk(main) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "iso")
    return eval(compile(ast.Expression(node.value), str(path), "eval"),
                {"np": np, "float": float, "dens": dens, "mcfg": types.SimpleNamespace(iso_level=cap)})


@pytest.mark.parametrize("inside", [0.5, 3.9, 4.0, 17.94, 39.9, 40.0, 250.0])
def test_iso_rule_matches_the_script(inside):
    """A quarter of the interior density clipped to [1, 10], below, inside
    and above the band."""
    dens = np.array([16.0, inside, 20.0, 0.0], np.float32)
    assert field_init.iso_level(float(dens[1])) == _script_iso(dens, field_init.ISO_CAP)


def test_field_init_record_holds_the_script_keys(monkeypatch):
    """A small run (4 cameras at 64x40, 20 iterations of 128 rays, grid 32)
    writes every key of the JAX record FIELD_INIT.json, with finite values."""
    for name, value in (("W", W), ("H", H), ("FOCAL", FOCAL)):
        monkeypatch.setattr(field_init, name, value)
    report, out = field_init.run(20, 32, 128, 4, device="cpu", log=lambda *_: None)
    want = json.load(open(ROOT / "FIELD_INIT.json"))
    assert set(want) <= set(report), set(want) - set(report)
    assert set(want["density_probe"]) == set(report["density_probe"])
    assert report["backend"] == "cpu" and report["grid_res"] == 32 and report["n_cams"] == 4
    assert 1.0 <= report["density_probe"]["iso_level"] <= field_init.ISO_CAP
    assert np.isfinite(report["train_s"]) and np.isfinite(report["step_ms_median"])
    assert report["mesh_faces"] == len(out["mesh"].faces) <= field_init.TARGET_FACES


def test_field_batch_record_format(monkeypatch):
    """Two tiny batches: one point each, with positive times and rates."""
    monkeypatch.setattr(field_batch, "STEPS", 2)
    report = field_batch.run([64, 128], device="cpu", log=lambda *_: None)
    assert report["backend"] == "cpu" and report["n_samples_per_ray"] == 128 and report["steps"] == 2
    assert [p["rays_per_batch"] for p in report["results"]] == [64, 128]
    for p in report["results"]:
        assert p["ms_per_step"] > 0 and p["first_step_ms"] > 0 and p["loss_finite"]
        assert p["rays_per_s"] == pytest.approx(p["rays_per_batch"] / (p["ms_per_step"] * 1e-3))


def test_field_batch_records_oom_and_goes_on(monkeypatch):
    """A batch out of device memory is recorded and the sweep goes on; any
    other error ends the run."""
    point = field_batch.batch_point

    def oom_at_128(n, rng, dev):
        if n == 128:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return point(n, rng, dev)

    monkeypatch.setattr(field_batch, "STEPS", 1)
    monkeypatch.setattr(field_batch, "batch_point", oom_at_128)
    report = field_batch.run([128, 64], device="cpu", log=lambda *_: None)
    assert report["results"][0] == {"rays_per_batch": 128, "error": "out of memory"}
    assert report["results"][1]["rays_per_batch"] == 64 and "error" not in report["results"][1]
    monkeypatch.setattr(field_batch, "batch_point", lambda *a: (_ for _ in ()).throw(ValueError("bad input")))
    with pytest.raises(ValueError):
        field_batch.run([64], device="cpu", log=lambda *_: None)
