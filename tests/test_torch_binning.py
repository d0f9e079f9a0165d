"""Port tile binning vs the JAX package: each tile's ordered gaussian list."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.ops.binning import bin_gaussians as j_bin, gather_pair_data as j_gather
from gaustar_tpu.ops.projection import Gaussians2D as JG
from gaustar_tpu_torch.ops.binning import bin_gaussians as t_bin, gather_pair_data as t_gather
from gaustar_tpu_torch.ops.projection import Gaussians2D as TG


def _gaussians(rng, n, grid_x, grid_y, tie_depths):
    rx0 = rng.integers(0, grid_x, size=n)
    ry0 = rng.integers(0, grid_y, size=n)
    rx1 = np.minimum(rx0 + rng.integers(1, 4, size=n), grid_x)
    ry1 = np.minimum(ry0 + rng.integers(1, 4, size=n), grid_y)
    culled = rng.random(n) < 0.3
    rx1 = np.where(culled, rx0, rx1)
    ry1 = np.where(culled, ry0, ry1)
    touched = (rx1 - rx0) * (ry1 - ry0)
    depth = rng.uniform(1.0, 9.0, size=n).astype(np.float32)
    if tie_depths:
        depth = np.round(depth * 2.0) / 2.0  # many exact ties
    fields = dict(
        mean2d=rng.normal(size=(n, 2)).astype(np.float32),
        depth=depth,
        conic=rng.normal(size=(n, 3)).astype(np.float32),
        opacity=rng.uniform(0.1, 1.0, size=n).astype(np.float32),
        color=rng.normal(size=(n, 3)).astype(np.float32),
        radius=np.where(touched > 0, 3, 0).astype(np.int32),
        rect_min=np.stack([rx0, ry0], -1).astype(np.int32),
        rect_max=np.stack([rx1, ry1], -1).astype(np.int32),
        tiles_touched=touched.astype(np.int32),
    )
    jg = JG(**{k: jnp.asarray(v) for k, v in fields.items()})
    tg = TG(**{k: torch.as_tensor(v) for k, v in fields.items()})
    return jg, tg, fields


def _tile_lists_jax(b, n_tiles, n):
    gi, order = np.asarray(b.gauss_idx), np.asarray(b.depth_order)
    st, ct = np.asarray(b.tile_start), np.asarray(b.tile_count)
    return [list(order[gi[st[t]: st[t] + ct[t]]]) for t in range(n_tiles)]


def _tile_lists_port(b, n_tiles):
    gi, order = b.gauss_idx.numpy(), b.depth_order.numpy()
    st, ct = b.tile_start.numpy(), b.tile_count.numpy()
    return [list(order[gi[st[t]: st[t] + ct[t]]]) for t in range(n_tiles)]


@pytest.mark.parametrize("tie_depths", [False, True])
def test_tile_lists_match_jax(tie_depths):
    rng = np.random.default_rng(3 + tie_depths)
    grid_x, grid_y, n = 5, 4, 60
    jg, tg, fields = _gaussians(rng, n, grid_x, grid_y, tie_depths)
    total = int(fields["tiles_touched"].sum())
    jb = j_bin(jg, grid_x, grid_y, max_pairs=total + 16, chunk=8)
    tb = t_bin(tg, grid_x, grid_y)
    assert tb.num_pairs == int(jb.num_pairs) == total
    np.testing.assert_array_equal(tb.tile_count.numpy(), np.asarray(jb.tile_count))
    assert _tile_lists_port(tb, grid_x * grid_y) == _tile_lists_jax(jb, grid_x * grid_y, n)
    # compact layout: the tiles' ranges tile [0, P) in tile order
    st, ct = tb.tile_start.numpy(), tb.tile_count.numpy()
    np.testing.assert_array_equal(st, np.cumsum(ct) - ct)


def test_gather_pair_data_vjp_matches_jax():
    rng = np.random.default_rng(9)
    grid_x, grid_y, n = 6, 5, 80
    jg, tg, fields = _gaussians(rng, n, grid_x, grid_y, tie_depths=True)
    total = int(fields["tiles_touched"].sum())
    jb = j_bin(jg, grid_x, grid_y, max_pairs=total + 16, chunk=8)
    tb = t_bin(tg, grid_x, grid_y)
    j_lists = np.asarray(jb.gauss_idx)
    keep = j_lists < n  # the JAX layout pads each tile to the chunk
    ct = rng.normal(size=(9, total)).astype(np.float32)
    ct_j = np.zeros((16, j_lists.shape[0]), np.float32)
    ct_j[:9, keep] = ct  # both layouts list the pairs in tile order

    def jf(mean2d, conic, opacity, color):
        g = jg._replace(mean2d=mean2d, conic=conic, opacity=opacity, color=color)
        return (j_gather(g, jb) * ct_j).sum()

    import jax

    jgrads = jax.grad(jf, argnums=(0, 1, 2, 3))(jg.mean2d, jg.conic, jg.opacity, jg.color)
    leaves = [tg.mean2d.clone().requires_grad_(), tg.conic.clone().requires_grad_(),
              tg.opacity.clone().requires_grad_(), tg.color.clone().requires_grad_()]
    g2 = tg._replace(mean2d=leaves[0], conic=leaves[1], opacity=leaves[2], color=leaves[3])
    pd = t_gather(g2, tb)
    np.testing.assert_array_equal(pd.detach().numpy(), np.asarray(j_gather(jg, jb))[:9, keep])
    (pd * torch.as_tensor(ct)).sum().backward()
    # The JAX backward takes each segment sum as a difference of one running
    # cumsum over all pairs, so its error grows with the running total (~1e-6
    # of it); the port sums each segment on its own.
    for a, b in zip(leaves, jgrads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_pair_demand_at_reference_width_matches_jax():
    """bench.py's autocaps probe (pairs and non-empty tiles, the maximum over
    the 4 ring cameras at 1600x1024) on a coarser sphere than bench.py's."""
    from gaustar_tpu.cameras import stack_cameras as j_stack
    from gaustar_tpu.mesh.primitives import uv_sphere as j_uv_sphere
    from gaustar_tpu.models import sugar as j_sugar
    from gaustar_tpu.ops.rasterizer import RasterConfig, probe_pair_demand
    from gaustar_tpu.utils.synthetic import ring_cameras as j_ring
    from gaustar_tpu_torch.mesh.primitives import uv_sphere
    from gaustar_tpu_torch.models import sugar
    from gaustar_tpu_torch.utils.synthetic import REF_FOCAL, REF_H, REF_W, blend_inputs, ring_cameras

    verts, faces = uv_sphere(21, 25, radius=0.6, center=(0.0, 0.0, 4.0))
    colors = np.random.default_rng(0).uniform(0.2, 0.9, size=(len(verts), 3)).astype(np.float32)
    jv, jf = j_uv_sphere(21, 25, radius=0.6, center=(0.0, 0.0, 4.0))
    jp, jc = j_sugar.init_sugar(jv, jf, vertex_colors=colors)
    j_cams = j_stack(j_ring(4, w=REF_W, h=REF_H, focal=REF_FOCAL))
    j_pairs, _, j_active = probe_pair_demand(j_sugar.gaussian_centers(jp, jc), j_sugar.cov3d(jp, jc),
                                             j_sugar.strengths(jp), j_cams, RasterConfig(max_pairs=1 << 17))
    params, config = sugar.init_sugar(verts, faces, vertex_colors=colors, device="cpu")
    pos, cov = sugar.geom_primitives(params, config)
    demand = []
    for cam in ring_cameras(4, w=REF_W, h=REF_H, focal=REF_FOCAL, device="cpu"):
        pd, _, count, *_ = blend_inputs(pos, cov, sugar.strengths(params), torch.zeros_like(pos), cam, 3)
        demand.append((pd.shape[1], int((count > 0).sum())))
    assert 0 < j_pairs < 1 << 17
    assert (max(p for p, _ in demand), max(a for _, a in demand)) == (j_pairs, j_active)
