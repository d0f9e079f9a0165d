"""The port's fusion pass and TSDF mesh extraction (train/mesh_update.py)
against the JAX package's on identical params: one fused RGB+depth render,
the fused mesh from 60 orbit views plus 8 ring cameras (48x48, a subdiv-2
icosphere, 1,920 gaussians), and subset_sugar_faces."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from gaustar_tpu.cameras import index_camera as jindex
from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu.train import mesh_update as jmu
from gaustar_tpu.utils import synthetic as jsynth
from gaustar_tpu.utils.general import inverse_sigmoid
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.cameras import index_camera
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.train import mesh_update as tmu
from port_helpers import one_thread  # noqa: F401  (autouse)
from port_native import jax_native


JAX_RCFG = JaxRasterConfig(max_pairs=1 << 16, chunk=32, max_per_tile=4096, impl="jax")
VOXEL = 0.04


@pytest.fixture(scope="module")
def scene():
    _, jc, jd, target, _ = jsynth.synthetic_frame(n_cams=8, w=48, h=48, subdiv=2, raster_cfg=JAX_RCFG)
    target = dataclasses.replace(target, densities=jnp.full_like(target.densities, inverse_sigmoid(0.999)))
    tp = bridge.sugar_params_from_numpy({f.name: np.array(getattr(target, f.name))
                                         for f in dataclasses.fields(target)}, "cpu")
    tc = bridge.sugar_config_from_numpy(
        dict(faces=np.array(jc.faces), bary=np.array(jc.bary), thickness=np.array(jc.thickness),
             n_gaussians_per_face=jc.n_gaussians_per_face, sh_levels=jc.sh_levels, min_scale=jc.min_scale,
             max_scale=jc.max_scale), "cpu")
    cams = bridge.camera_from_numpy(*(np.array(getattr(jd.cameras, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")),
                                    jd.cameras.width, jd.cameras.height, device="cpu")
    return dict(jax=(target, jc, jd.cameras), port=(tp, tc, cams))


def test_render_rgbd_for_fusion_matches_jax(scene):
    """One fused pass. Colours within the golden image tolerance (3e-5);
    depth = blend(z) / alpha on the pixels both keep, within 1e-4 (the
    division by alpha scales the tolerance of the depth channel); the pixels
    zeroed (background, depth edges) agree on 99.5%."""
    jp, jc, jcams = scene["jax"]
    tp, tc, tcams = scene["port"]
    for i in (0, 3):
        jrgb, jdepth = jmu.render_rgbd_for_fusion(jp, jc, jindex(jcams, i), JAX_RCFG, 2)
        trgb, tdepth = tmu.render_rgbd_for_fusion(tp, tc, index_camera(tcams, i), RasterConfig(), 2)
        np.testing.assert_allclose(trgb.numpy(), jrgb, atol=3e-5)
        tz, jz = tdepth.numpy() > 0, jdepth > 0
        assert (tz == jz).mean() >= 0.995 and jz.mean() > 0.03
        both = tz & jz
        np.testing.assert_allclose(tdepth.numpy()[both], jdepth[both], atol=1e-4)


def _mean_nn(a, b):
    return float(cKDTree(b).query(a)[0].mean())


def test_extract_mesh_fusion_matches_jax(scene):
    """68 views (60 orbit + 8 rig) fused on a 4 cm grid by both packages: the
    meshes' symmetric Chamfer distance (mean nearest-vertex distance, each
    way) under half a voxel."""
    jp, jc, jcams = scene["jax"]
    tp, tc, tcams = scene["port"]
    kw = dict(voxel_size=VOXEL, sdf_trunc=3 * VOXEL, use_orbit_cameras=True, max_dim=64)
    jm = jmu.extract_mesh_fusion(jp, jc, jcams, JAX_RCFG, **kw)
    tm = tmu.extract_mesh_fusion(tp, tc, tcams, RasterConfig(), **kw)
    assert tmu.last_fusion["views"] == 68 and tmu.last_fusion["faces"] == len(tm.faces)
    assert len(tm.faces) > 50 and abs(len(tm.faces) - len(jm.faces)) <= 0.05 * len(jm.faces)
    for a, b in ((tm.verts, jm.verts), (jm.verts, tm.verts)):
        assert _mean_nn(a, b) < 0.5 * VOXEL
    r = np.linalg.norm(tm.verts - np.array([0, 0, 4.0]), axis=-1)
    assert 0.4 < np.median(r) < 0.8


def test_native_options_raise(scene, monkeypatch, tmp_path):
    """The native options (Laplacian smooth, quadric decimation) run in the
    port as in the JAX package: the decimated fused meshes keep at most the
    target's faces, within 5% of the JAX package's count, on the same
    sphere: their median radii within a quarter voxel (vertex-to-vertex
    distances are set by the 300-face spacing, not by the fit). Without a
    compiler for the native library they raise: there is no fallback."""
    jax_native()  # the JAX side smooths and decimates natively
    jp, jc, jcams = scene["jax"]
    tp, tc, tcams = scene["port"]
    kw = dict(voxel_size=VOXEL, sdf_trunc=3 * VOXEL, use_orbit_cameras=True, max_dim=64, smooth=True,
              simplify_face_num=300)
    jm = jmu.extract_mesh_fusion(jp, jc, jcams, JAX_RCFG, **kw)
    tm = tmu.extract_mesh_fusion(tp, tc, tcams, RasterConfig(), **kw)
    assert 0.9 * 300 <= len(tm.faces) <= 300 and abs(len(tm.faces) - len(jm.faces)) <= 0.05 * len(jm.faces)
    tr, jr = (np.linalg.norm(v - np.array([0, 0, 4.0]), axis=-1) for v in (tm.verts, jm.verts))
    assert abs(np.median(tr) - np.median(jr)) < 0.25 * VOXEL and 0.4 < np.median(tr) < 0.8
    np.testing.assert_array_equal(tm.face_colors, np.zeros((len(tm.faces), 3)))

    monkeypatch.setattr(tmu.native, "_lib", None)
    monkeypatch.setattr(tmu.native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tmu.native.shutil, "which", lambda name: None)
    for opt in (dict(smooth=True), dict(simplify_face_num=100)):
        with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
            tmu.extract_mesh_fusion(tp, tc, tcams, RasterConfig(), **{**kw, "smooth": False,
                                                                      "simplify_face_num": 0, **opt})


def test_subset_sugar_faces_matches_jax(scene):
    jp, jc, _ = scene["jax"]
    tp, tc, _ = scene["port"]
    mask = np.random.default_rng(0).random(jc.faces.shape[0]) < 0.7
    jsp, jsc = jmu.subset_sugar_faces(jp, jc, mask)
    tsp, tsc = tmu.subset_sugar_faces(tp, tc, mask)
    np.testing.assert_array_equal(tsc.faces.numpy(), np.asarray(jsc.faces))
    for name, p in tsp.named():
        np.testing.assert_array_equal(p.detach().numpy(), np.asarray(getattr(jsp, name)), err_msg=name)
        assert p.requires_grad
    # the subset renders: its gather tables follow the new faces
    img, _ = tmu.sugar.render(tsp, tsc, index_camera(scene["port"][2], 0), raster_config=RasterConfig())
    assert torch.isfinite(img).all()
