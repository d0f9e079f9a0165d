"""The port's GT depth fusion and point splatting (tools/depth_fusion.py)
against the JAX package's, on the analytic depth maps of a sphere seen by a
ring of cameras."""

import numpy as np
import pytest
import torch

from gaustar_tpu.tools import depth_fusion as jdf
from gaustar_tpu_torch.tools import depth_fusion as tdf
from gaustar_tpu_torch.utils.synthetic import ring_cameras, sphere_depth
from port_helpers import one_thread  # noqa: F401  (autouse)

CENTER, RADIUS = (0.0, 0.0, 4.0), 0.5


def _scene(n=6, w=80, h=64, focal=70.0):
    views = [c.view.numpy().astype(np.float64) for c in ring_cameras(n, w=w, h=h, focal=focal, device="cpu")]
    depths = np.stack([sphere_depth(v, focal, (h, w), CENTER, RADIUS) for v in views])
    cmr = {"intrinsics": np.stack([np.diag([focal, focal, 1.0])] * n), "extrinsics": np.stack(views)}
    return depths, cmr


@pytest.mark.parametrize("with_rgb", [False, True], ids=["depth", "rgbd"])
def test_fuse_gt_depths_matches_jax(with_rgb):
    """The same mesh: equal face and vertex counts, the same faces, vertices
    within 1e-5 m and face colours within 1e-4 (each voxel's running colour
    average rounds in another order); the surface on the sphere within one
    voxel."""
    depths, cmr = _scene()
    rgbs = np.random.default_rng(0).uniform(size=depths.shape + (3,)).astype(np.float32) if with_rgb else None
    kw = dict(voxel_size=0.02, sdf_trunc=0.05, rgbs=rgbs)
    jm = jdf.fuse_gt_depths(depths, cmr, **kw)
    tm = tdf.fuse_gt_depths(depths, cmr, device="cpu", **kw)
    assert len(tm.faces) == len(jm.faces) > 500 and len(tm.verts) == len(jm.verts)
    np.testing.assert_array_equal(tm.faces, jm.faces)
    np.testing.assert_allclose(tm.verts, jm.verts, atol=1e-5)
    np.testing.assert_allclose(tm.face_colors, jm.face_colors, atol=1e-4)
    dist = np.abs(np.linalg.norm(tm.verts - CENTER, axis=1) - RADIUS)
    assert np.median(dist) < 0.02


def test_points_to_depth_map_matches_jax():
    """The z-buffer splat of a seeded point cloud, radius 1 and 2: equal."""
    depths, cmr = _scene(n=2)
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(3000, 3)) * 0.4 + CENTER
    for radius in (1, 2):
        for intr, extr in zip(cmr["intrinsics"], cmr["extrinsics"]):
            np.testing.assert_array_equal(tdf.points_to_depth_map(pts, intr, extr, (64, 80), radius),
                                          jdf.points_to_depth_map(pts, intr, extr, (64, 80), radius))


def test_fusion_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    depths, cmr = _scene(n=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdf.fuse_gt_depths(depths, cmr)
