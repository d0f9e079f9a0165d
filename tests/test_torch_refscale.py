"""The reference-scale runs' scenes and measurements (gaustar_tpu_torch/
refscale/) against the JAX repository's scripts (examples/refscale_*.py),
loaded without their import-time side effects (tests/port_examples.py)
and run with their module constants set small: the frame's rig and GT, the
sequence's analytic frames and on-disk dataset, the real capture's meshes,
texture, rig, masks, GT renders and surface distance, its precision / recall
and region selection, and the 160-camera warp at 8 cameras. The frame
itself is tests/test_torch_refscale_frame.py. Depths and images at 1e-6
relative, masks and draws exactly."""

import dataclasses
import importlib
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu_torch.io import image_codec
from gaustar_tpu_torch.io.meshio import read_obj
from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.refscale import real, scenes, warp160
from gaustar_tpu_torch.utils import synthetic
from port_examples import jax_cache_options, load_example, nested_function
from port_helpers import one_thread  # noqa: F401  (autouse)

JAX_RCFG = JaxRasterConfig(max_pairs=1 << 16, chunk=32, max_per_tile=4096, impl="jax")
W, H = 64, 48
RTOL = 1e-6


def _close(a, b, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol, atol=0)


def test_loading_the_examples_changes_no_jax_config():
    before = jax_cache_options()
    for name in ("refscale_frame", "refscale_seq", "refscale_real", "refscale_warp160"):
        ns = load_example(name)
        assert callable(ns["main"])
    assert jax_cache_options() == before


def widen_rig_at(ns, data, monkeypatch, focal):
    """The script's widen_rig with the JAX package's ring_cameras at
    `focal`: widen_rig asks for its full-width 1600, which at 64 px sees
    only the sphere's middle."""
    from gaustar_tpu.utils import synthetic as jsyn

    ring = jsyn.ring_cameras
    monkeypatch.setattr(jsyn, "ring_cameras", lambda n, w, h, **_: ring(n, w=w, h=h, focal=focal))
    return ns["widen_rig"](data)


def test_reference_rig_equals_widen_rig(monkeypatch):
    from gaustar_tpu.utils.synthetic import synthetic_frame as jax_frame

    ns = load_example("refscale_frame", W=W, H=H, N_CAMS=8)
    jdata = widen_rig_at(ns, jax_frame(n_cams=4, w=W, h=H)[2], monkeypatch, 120.0)
    tdata = scenes.reference_rig(synthetic.synthetic_frame(n_cams=4, w=W, h=H, device="cpu")[2], 8, W, H, 120.0)
    for f in ("R", "T", "fx", "fy", "cx", "cy"):
        np.testing.assert_array_equal(getattr(tdata.cameras, f).numpy(), np.asarray(getattr(jdata.cameras, f)))
    jd, td = np.asarray(jdata.gt_depths), tdata.gt_depths.numpy()
    _close(td, jd)
    _close(tdata.gt_images.numpy(), np.asarray(jdata.gt_images))
    np.testing.assert_array_equal(td == scenes.FRAME_MISS, jd == 10.5)
    dent = (np.asarray(jdata.gt_images)[..., 0] == np.float32(0.15))
    assert dent.any() and (dent == (tdata.gt_images.numpy()[..., 0] == np.float32(0.15))).all()
    np.testing.assert_array_equal(tdata.margins.numpy(), np.asarray(jdata.margins))


@pytest.mark.parametrize("dent", [False, True])
def test_analytic_frame_equals_script(dent):
    ns = load_example("refscale_seq", W=W, H=H)
    seen_dent = False
    for cam in synthetic.ring_cameras(6, w=W, h=H, focal=120.0, device="cpu"):
        view = cam.view.numpy()
        want = ns["_analytic_frame"](view, 120.0, 120.0, dent)
        got = scenes.analytic_frame(view, 120.0, W, H, dent)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        _close(got[2], want[2])
        seen_dent |= bool((want[0] == 38).any())
    assert seen_dent == dent


def _pil_write(path, img, quality=95):
    Image.fromarray(img.cpu().numpy()).save(path, quality=quality)


def test_sequence_dataset_equals_script(tmp_path, monkeypatch):
    monkeypatch.setattr(image_codec, "write_jpeg", _pil_write)
    ns = load_example("refscale_seq", W=W, H=H, N_CAMS=3)
    n_j = ns["build_dataset"](str(tmp_path / "jax"))
    n_t = scenes.write_sequence_dataset(str(tmp_path / "port"), 3, W, H, device="cpu")
    assert n_t == n_j == 100_000
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), tmp_path / "port")
                           for d, _, fs in os.walk(tmp_path / "port") for f in fs)
    for rel in files:
        a, b = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".npz"):
            za, zb = np.load(a), np.load(b)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                _close(zb[k], za[k]) if "depth" in rel else np.testing.assert_array_equal(zb[k], za[k])
        elif rel.endswith((".jpg", ".png")):
            np.testing.assert_array_equal(np.asarray(Image.open(b)), np.asarray(Image.open(a)))
        else:
            (va, fa, ca), (vb, fb, cb) = read_obj(str(a)), read_obj(str(b))
            np.testing.assert_array_equal(vb, va)
            np.testing.assert_array_equal(fb, fa)
            np.testing.assert_array_equal(cb, ca)


def _real(**consts):
    return load_example("refscale_real", W=W, H=H, FOCAL=scenes.real_focal(W), N_CAMS=4,
                        RNG=np.random.default_rng(7), **consts)


def test_real_meshes_texture_rig_and_masks_equal_script():
    ns = _real()
    jv, jf = ns["ellipsoid_mesh"](2000)
    tv, tf = scenes.ellipsoid_mesh(2000)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    for a, b in zip(scenes.blob_mesh(), ns["blob_mesh"]()):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    for verts in (tv, scenes.blob_mesh()[0]):  # the script's order: body, then blob
        np.testing.assert_array_equal(scenes.texture(verts, rng), ns["texture"](verts))
    for n in (4, 6):
        for jc, tc in zip(ns["rig_cameras"](n), scenes.real_rig(n, W, H, "cpu")):
            np.testing.assert_array_equal(tc.view.numpy(), np.asarray(jc.view))
            assert (float(tc.fx), float(tc.cx), float(tc.cy)) == (float(jc.fx), float(jc.cx), float(jc.cy))
    valid = np.zeros((H, W), bool)
    valid[10:30, 20:45] = True
    np.testing.assert_array_equal(scenes.imperfect_mask(valid, np.random.default_rng(3)),
                                  ns["imperfect_mask"](valid, np.random.default_rng(3)))
    pts = np.random.default_rng(5).normal(size=(500, 3)) * 0.3 + scenes.BODY_C
    for a, b in zip(scenes.surface_distance(pts), ns["surface_distance"](pts)):
        np.testing.assert_array_equal(a, b)


def test_real_gt_render_equals_script():
    """render_gt of a small textured body: the port's render (plain blend)
    and mesh z-buffer against the JAX package's, the same noise draws."""
    from gaustar_tpu.models import sugar as jsugar

    ns = _real()
    v, f = scenes.ellipsoid_mesh(300)
    c = scenes.texture(v, np.random.default_rng(1))
    jp, jc = jsugar.init_sugar(v, f, vertex_colors=c)
    tp, tc = sugar.init_sugar(v, f, vertex_colors=c, device="cpu")
    want = ns["render_gt"](jp, jc, ns["rig_cameras"](4), JAX_RCFG, np.random.default_rng(2))
    got = scenes.render_gt(tp, tc, scenes.real_rig(4, W, H, "cpu"), RasterConfig(), np.random.default_rng(2))
    np.testing.assert_array_equal(got[2], want[2])  # masks
    assert want[2].any()
    _close(got[1], want[1])  # depths
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=1e-6)  # images in [0, 1]


def test_real_detection_truth_and_selection_equal_script():
    ns = _real()
    v, f = scenes.ellipsoid_mesh(20_000)
    adj = build_topology(f, len(v)).adj_faces
    centers = v[f].mean(axis=1)
    changed = np.linalg.norm(centers - scenes.BLOB_C[None], axis=1) < (scenes.BLOB_R + 0.05)
    np.testing.assert_array_equal(real.changed_faces(v, f), changed)
    assert changed.any()
    cc_select = nested_function(ns, "main", "cc_select", adj=adj)
    pr = nested_function(ns, "main", "pr", changed=changed)
    rng = np.random.default_rng(0)
    # flags: the truth grown by noise, scattered false positives, small islands
    near = np.linalg.norm(centers - scenes.BLOB_C[None], axis=1) < scenes.BLOB_R + 0.08
    for p_in, p_out in ((0.9, 0.01), (0.6, 0.05), (1.0, 0.0)):
        flag = np.where(near, rng.uniform(size=len(f)) < p_in, rng.uniform(size=len(f)) < p_out)
        sel = real.cc_select(flag, f, adj)
        np.testing.assert_array_equal(sel, cc_select(flag))
        for mine, theirs in ((real.precision_recall(flag, changed), pr(flag)),
                             (real.precision_recall(sel, changed), pr(sel))):
            assert mine["flagged"] == theirs["flagged"]
            assert round(mine["precision"], 4) == theirs["precision"]
            assert round(mine["recall"], 4) == theirs["recall"]


def test_warp160_sphere_depth_equals_script():
    ns = load_example("refscale_warp160", W=W, H=H)
    for cam in synthetic.rig_cameras(5, rows=5, dist=2.5, w=W, h=H, focal=80.0, device="cpu"):
        view = cam.view.numpy()
        for center in (scenes.CENTER, scenes.CENTER + scenes.WARP_SHIFT):
            d, hit, (vx, vy) = scenes.sphere_depth(view, 80.0, 80.0, W, H, center)
            jd, jhit, (jvx, jvy) = ns["sphere_depth"](view, 80.0, 80.0, center)
            _close(d, jd)
            np.testing.assert_array_equal(hit, jhit)
            assert hit.any()
            np.testing.assert_array_equal(vx, jvx)


def test_warp160_matches_jax_at_40_cameras(tmp_path, monkeypatch):
    """The script's main at 40 cameras on a uv_sphere(41, 50) (it writes its
    record into the test's directory) against warp160.run: the warped
    vertices within 1e-5, the record's numbers alike. The warp's gates
    admit near-frontal pixels at the rig's 1.25 mm/px footprint only, so
    the image stays at full resolution: at half of it, or with 20 cameras,
    no vertex is observed by the 4 cameras the warp requires."""
    from gaustar_tpu.mesh import primitives as jprim
    from gaustar_tpu.tools import warp_mesh as jwarp
    from gaustar_tpu_torch.mesh.primitives import uv_sphere

    seen = {}
    jax_warp, jax_sphere = jwarp.warp_mesh_using_flow, jprim.uv_sphere

    def capture(*args, **kwargs):
        seen["out"] = jax_warp(*args, **kwargs)
        return seen["out"]

    monkeypatch.setattr(jwarp, "warp_mesh_using_flow", capture)
    monkeypatch.setattr(jprim, "uv_sphere", lambda n_lat, n_lon, **kw: jax_sphere(41, 50, **kw))
    monkeypatch.setattr(warp160, "uv_sphere", lambda n_lat, n_lon, **kw: uv_sphere(41, 50, **kw))
    monkeypatch.chdir(tmp_path)
    ns = load_example("refscale_warp160", N_CAMS=40)
    ns["main"]()
    report, warped = warp160.run(40, log=lambda *_: None)
    np.testing.assert_allclose(warped, seen["out"][0], rtol=0, atol=1e-5)
    assert 0.1 < report["observed_vert_pct"] / 100 < 1.0
    want = json.load(open(tmp_path / "WARP160.json"))
    for k in ("observed_vert_pct", "motion_err_mean_mm", "motion_err_p95_mm"):
        assert round(report[k], 2 if "mm" in k else 1) == want[k]


@pytest.mark.parametrize("name", ["frame", "seq", "real", "warp160", "field_init", "field_batch", "demo"])
def test_entry_points_refuse_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module("gaustar_tpu_torch.demo" if name == "demo" else f"gaustar_tpu_torch.refscale.{name}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(["--out", os.devnull])


def test_reference_rig_keeps_the_reference_scene_fields():
    """reference_rig replaces the rig, GT and margins and nothing else."""
    p, c, d, _, _ = synthetic.synthetic_frame(n_cams=4, w=W, h=H, device="cpu")
    out = scenes.reference_rig(d, 5, W, H, 120.0)
    changed = {f.name for f in dataclasses.fields(d)
               if not (getattr(out, f.name) is getattr(d, f.name))}
    assert changed == {"cameras", "gt_images", "gt_depths", "margins"}
    assert out.gt_images.shape == (5, H, W, 3) and out.margins.shape == (5, 4)
