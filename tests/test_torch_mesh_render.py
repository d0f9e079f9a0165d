"""The port's mesh depth renderer (tools/mesh_render.py) against the JAX
package's render_mesh_depth: equal mask and pair total and depth within
rtol 1e-6 on tests/test_components.py:67's scene and on seeded random meshes
whose tiles stay under the JAX caps, the same against an uncapped JAX render
where the default caps drop faces, and close to a sphere's analytic depth.

The depth tolerance: XLA's CPU code fuses the edge functions' and the 1/z
sum's multiply-adds into fused multiply-adds, eager PyTorch rounds each
product, so a covered pixel's depth can differ in its last 1-3 bits (within
3e-7 relative on these scenes). The projected vertices themselves are
equal."""

import numpy as np
import pytest
import torch

from gaustar_tpu.mesh.primitives import icosphere as j_icosphere
from gaustar_tpu.tools import mesh_render as jmr
from gaustar_tpu.utils.synthetic import ring_cameras as j_ring
from gaustar_tpu_torch.mesh.primitives import uv_sphere
from gaustar_tpu_torch.tools import mesh_render as tmr
from gaustar_tpu_torch.utils.synthetic import ring_cameras as t_ring, sphere_depth
from port_helpers import one_thread  # noqa: F401  (autouse)


def _both(verts, faces, n=1, w=64, h=64, focal=80.0, **caps):
    jc = j_ring(n, w=w, h=h, focal=focal)
    tc = t_ring(n, w=w, h=h, focal=focal, device="cpu")
    for jcam, tcam in zip(jc, tc):
        yield jmr.render_mesh_depth(verts, faces, jcam, **caps), tmr.render_mesh_depth(verts, faces, tcam)


def _assert_equal(j, t):
    (dj, mj, nj), (dt, mt, nt) = j, t
    np.testing.assert_array_equal(mt, mj)
    assert nt == nj
    np.testing.assert_allclose(dt, dj, rtol=1e-6, atol=0)


def test_icosphere_scene_equals_jax():
    """tests/test_components.py:67: the subdivision-2 icosphere at z = 4."""
    verts, faces = j_icosphere(2, radius=0.5, center=(0, 0, 4.0))
    for j, t in _both(verts, faces, max_pairs=1 << 14, max_per_tile=512):
        _assert_equal(j, t)
        depth, mask, _ = t
        assert abs(depth[32, 32] - 3.5) < 0.05 and depth[0, 0] == tmr.INVALID_DEPTH
        assert mask[32, 32] and not mask[0, 0] and 250 < mask.sum() < 400


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_meshes_equal_jax(seed):
    """Seeded random triangle soups in front of 3 ring cameras at 100x70 (a
    partial tile row and column), some faces behind the near limit or off
    screen, tiles under the JAX caps: equal depth, mask and pair total."""
    rng = np.random.default_rng(seed)
    n = 300
    centers = np.concatenate([rng.uniform(-1.2, 1.2, (n, 2)), rng.uniform(2.0, 6.0, (n, 1))], 1)
    verts = (centers[:, None, :] + rng.normal(0, 0.15, (n, 3, 3))).reshape(-1, 3).astype(np.float32)
    verts[:5, 2] = -1.0  # behind the cameras of the ring's first view
    faces = np.arange(3 * n).reshape(n, 3)
    for j, t in _both(verts, faces, n=3, w=100, h=70, focal=90.0):
        assert t[2] > 0 and t[1].any()
        _assert_equal(j, t)


def test_faces_beyond_the_jax_caps_are_kept():
    """4,000 faces stacked in one tile: the JAX package's default cap (2048 a
    tile) drops the nearest ones; the port renders all of them, equal to a
    JAX render with the cap raised."""
    rng = np.random.default_rng(3)
    n = 4000
    z = rng.uniform(3.0, 5.0, n)
    base = np.array([[-0.02, -0.02, 0.0], [0.03, -0.02, 0.0], [0.0, 0.03, 0.0]])
    verts = (base[None] * z[:, None, None] / 4.0 + np.stack([np.zeros(n), np.zeros(n), z], -1)[:, None]).reshape(-1, 3)
    verts[:, :2] += np.array([0.05, 0.05])  # off the tile corners
    faces = np.arange(3 * n).reshape(n, 3)
    (j_capped, t), = _both(verts.astype(np.float32), faces, w=48, h=48, focal=60.0)
    (j_full, _), = _both(verts.astype(np.float32), faces, w=48, h=48, focal=60.0, max_per_tile=8192)
    _assert_equal(j_full, t)
    assert (t[0] < j_capped[0]).any()  # the cap lost the nearest faces


def test_uv_sphere_close_to_the_analytic_depth():
    """A uv_sphere(41, 50) against utils/synthetic.sphere_depth: masks at IoU
    >= 0.98, median |depth difference| on the common pixels under the
    facets' sagitta (2.4 mm at this tessellation)."""
    center, radius, w, h, focal = (0.0, 0.0, 4.0), 0.6, 160, 96, 160.0
    verts, faces = uv_sphere(41, 50, radius=radius, center=center)
    for cam in t_ring(4, w=w, h=h, focal=focal, device="cpu"):
        depth, mask, _ = tmr.render_mesh_depth(verts, faces, cam)
        ref = sphere_depth(cam.view.numpy().astype(np.float64), focal, (h, w), center, radius)
        ref_mask = ref < tmr.INVALID_DEPTH - 1
        iou = (mask & ref_mask).sum() / (mask | ref_mask).sum()
        both = mask & ref_mask
        assert iou >= 0.98 and np.median(np.abs(depth[both] - ref[both])) < 2.4e-3, iou


def test_render_runs_on_the_cameras_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ring(1)
