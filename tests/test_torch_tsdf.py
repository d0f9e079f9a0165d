"""The port's TSDF fusion (mesh/tsdf.py) against the JAX package's: the same
frames integrated by both, the port's marching tetrahedra on the JAX
package's own blocks, and the tiled plan's seamlessness (the cases of
tests/test_tsdf_tiled.py, run through the port)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gaustar_tpu.mesh import tsdf as jtsdf
from gaustar_tpu_torch.mesh import tsdf as ttsdf
from port_helpers import one_thread  # noqa: F401  (autouse)


def _sphere_views(center, radius, n=6, w=64, h=64, focal=60.0, dist=3.0, seed=0):
    """A ring of analytic sphere depth maps with seeded colours: (depth, rgb,
    intr, extr) in float32."""
    rng = np.random.default_rng(seed)
    views = []
    intr = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]], np.float32)
    for i in range(n):
        a = 2 * np.pi * i / n
        fwd = np.array([-np.sin(a), 0.0, np.cos(a)])
        eye = np.asarray(center) - fwd * dist
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        upv = np.cross(fwd, right)
        R = np.stack([right, upv, fwd])  # w2c rotation
        extr = np.eye(4, dtype=np.float32)
        extr[:3, :3] = R
        extr[:3, 3] = -R @ eye
        ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
        d = np.stack([(xs - w / 2) / focal, (ys - h / 2) / focal, np.ones_like(xs, np.float64)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        dw = d @ R
        oc = eye - np.asarray(center)
        b = (dw * oc).sum(-1)
        c = (oc * oc).sum() - radius**2
        disc = b * b - c
        tt = -b - np.sqrt(np.maximum(disc, 0))
        depth = np.where((disc > 0) & (tt > 0), tt * d[..., 2], 0.0).astype(np.float32)
        rgb = rng.uniform(size=(h, w, 3)).astype(np.float32)
        views.append((depth, rgb, intr, extr))
    return views


def _port_blocks(plan, views, depth_trunc=10.0):
    blocks = []
    for b in range(plan.n_blocks):
        vol = plan.make_block(b, "cpu")
        for depth, rgb, intr, extr in views:
            ttsdf.integrate(vol, *(torch.as_tensor(a) for a in (depth, rgb, intr, extr)), depth_trunc=depth_trunc)
        blocks.append((vol.tsdf.numpy(), vol.weight.numpy(), vol.color.numpy()))
    return blocks


def _jax_blocks(plan, views, depth_trunc=10.0):
    blocks = []
    for b in range(plan.n_blocks):
        vol = plan.make_block(b)
        for depth, rgb, intr, extr in views:
            vol = jtsdf.integrate(vol, *(jnp.asarray(a) for a in (depth, rgb, intr, extr)), depth_trunc=depth_trunc)
        blocks.append((np.asarray(vol.tsdf), np.asarray(vol.weight), np.asarray(vol.color)))
    return blocks


def _canon(verts):
    v = np.asarray(verts, np.float64)
    return v[np.lexsort((v[:, 2], v[:, 1], v[:, 0]))]


def _plans(pts, vs, max_block):
    tp = ttsdf.fit_tiled_volume(pts, vs, 3 * vs, pad=0.1, max_block=max_block)
    jp = jtsdf.fit_tiled_volume(pts, vs, 3 * vs, pad=0.1, max_block=max_block)
    for name in ("origin", "offsets", "owned_lo", "owned_hi"):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name), err_msg=name)
    assert (tp.global_dims, tp.block_dims) == (jp.global_dims, jp.block_dims)
    return tp, jp


@pytest.mark.parametrize("max_block", [512, 24], ids=["one_block", "tiled"])
def test_integrate_matches_jax(max_block):
    """Every block after six frames. The view-space coordinates are float32
    products whose sums the two packages order differently, so they may
    differ by an ulp. A voxel whose projection lands on a half-pixel tie may
    then sample another pixel: at most 1e-4 of the voxels. The rest agree to
    the rounding of the depth difference: 4 ulps of a depth below 4 m over
    sdf_trunc for the TSDF (3.2e-5), 1e-6 for the colour. The focal length
    and distance are not round numbers: with round ones the axis-aligned
    views put whole rows of voxels exactly on ties."""
    center = np.array([0.013, -0.007, 0.011])
    vs = 0.02
    tol = 4 * float(np.spacing(np.float32(4.0))) / (3 * vs)
    views = _sphere_views(center, 0.4, focal=61.7, dist=3.03)
    tp, jp = _plans(center + np.array([[-0.4] * 3, [0.4] * 3]), vs, max_block)
    observed = 0
    for (tt, tw, tc), (jt, jw, jc) in zip(_port_blocks(tp, views), _jax_blocks(jp, views)):
        tie = (tw != jw) | (np.abs(tt - jt) > tol) | (np.abs(tc - jc) > 1e-6).any(-1)
        assert tie.mean() <= 1e-4, f"{tie.sum()} of {tie.size} voxels differ"
        observed += int((tw > 0).sum())
    assert observed > 0.05 * np.prod(tp.global_dims)  # the frames do observe the grid


def test_extraction_on_jax_blocks_equals_jax():
    """The port's marching tetrahedra on the JAX package's integrated blocks
    give the JAX package's mesh exactly, tiled and single-volume."""
    views = _sphere_views((0.0, 0.0, 0.0), 0.4)
    for max_block in (512, 24):
        tp, jp = _plans(np.array([[-0.4] * 3, [0.4] * 3]), 0.02, max_block)
        blocks = _jax_blocks(jp, views)
        for got, want in zip(ttsdf.extract_mesh_tiled(tp, blocks), jtsdf.extract_mesh_tiled(jp, blocks)):
            np.testing.assert_array_equal(got, want)
    vol = jtsdf.make_volume(jp.origin, jp.block_dims, 0.02, 0.06)
    for depth, rgb, intr, extr in views:
        vol = jtsdf.integrate(vol, *(jnp.asarray(a) for a in (depth, rgb, intr, extr)), depth_trunc=10.0)
    tvol = ttsdf.make_volume(jp.origin, jp.block_dims, 0.02, 0.06, device="cpu")
    tvol.tsdf, tvol.weight, tvol.color = (torch.as_tensor(np.array(a)) for a in (vol.tsdf, vol.weight, vol.color))
    for got, want in zip(ttsdf.extract_mesh(tvol), jtsdf.extract_mesh(vol)):
        np.testing.assert_array_equal(got, want)


def test_single_block_plan_matches_dense_volume():
    """A scene that fits one block gives the single dense volume's mesh."""
    center, radius, vs = (0.1, 0.0, 0.05), 0.4, 0.02
    views = _sphere_views(center, radius)
    pts = np.asarray(center) + np.array([[-radius] * 3, [radius] * 3])
    plan = ttsdf.fit_tiled_volume(pts, vs, 3 * vs, pad=0.1, max_block=512)
    assert plan.n_blocks == 1
    v_t, f_t, _ = ttsdf.extract_mesh_tiled(plan, _port_blocks(plan, views))
    vol = ttsdf.make_volume(plan.origin, plan.block_dims, vs, 3 * vs, device="cpu")
    for depth, rgb, intr, extr in views:
        ttsdf.integrate(vol, *(torch.as_tensor(a) for a in (depth, rgb, intr, extr)), depth_trunc=10.0)
    v_s, f_s, _ = ttsdf.extract_mesh(vol)
    assert len(f_t) == len(f_s)
    np.testing.assert_allclose(_canon(v_t), _canon(v_s), atol=1e-6)


def test_tiled_fusion_seamless_and_complete(monkeypatch):
    """A sphere spanning several blocks fuses with no dropped geometry and no
    seams: the tiled mesh equals the one-block mesh of the same global grid
    exactly, and lies on the sphere. Integration runs in chunks of a few
    x-planes here, so chunk edges cross the blocks too."""
    monkeypatch.setattr(ttsdf, "INTEGRATE_CHUNK_VOXELS", 3000)
    center, radius, vs = (0.0, 0.0, 0.0), 0.4, 0.02
    views = _sphere_views(center, radius)
    pts = np.asarray(center) + np.array([[-radius] * 3, [radius] * 3])
    plan = ttsdf.fit_tiled_volume(pts, vs, 3 * vs, pad=0.1, max_block=24)
    assert plan.n_blocks >= 8
    v_t, f_t, _ = ttsdf.extract_mesh_tiled(plan, _port_blocks(plan, views))
    big = ttsdf.fit_tiled_volume(pts, vs, 3 * vs, pad=0.1, max_block=4096)
    assert big.n_blocks == 1 and big.global_dims == plan.global_dims
    v_s, f_s, _ = ttsdf.extract_mesh_tiled(big, _port_blocks(big, views))
    assert len(f_t) == len(f_s)
    np.testing.assert_allclose(_canon(v_t), _canon(v_s), atol=1e-6)
    r = np.linalg.norm(v_t - np.asarray(center), axis=1)
    assert np.abs(r - radius).max() < 2 * vs
    for axis in range(3):
        assert v_t[:, axis].min() < -0.3 and v_t[:, axis].max() > 0.3


def test_fit_volume_to_points_matches_jax():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-2.0, 2.0, size=(100, 3)) * [1.0, 0.6, 1.0]
    for max_dim in (512, 96):
        with pytest.warns(UserWarning) if max_dim == 96 else _no_warning():
            tv = ttsdf.fit_volume_to_points(pts, 0.016, 0.04, max_dim=max_dim, device="cpu")
        jv = jtsdf.fit_volume_to_points(pts, 0.016, 0.04, max_dim=max_dim)
        assert tv.tsdf.shape == jv.tsdf.shape and tv.truncated == jv.truncated
        np.testing.assert_array_equal(tv.origin.numpy(), np.asarray(jv.origin))


class _no_warning:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
