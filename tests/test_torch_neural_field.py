"""The port's hash-grid field (models/neural_field.py) against the JAX
package's: the same initial values from one seed, equal hash indices, the
encoding, densities, colours and volume rendering with their gradients, the
occupancy grids and tightened ray bounds (equal), the density grid, and the
4D field. Small tables (2^10-2^12 entries) keep each case fast."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.models import neural_field as jnf
from gaustar_tpu.utils.synthetic import ring_cameras as j_ring
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.models import neural_field as tnf
from gaustar_tpu_torch.utils.synthetic import ring_cameras as t_ring
from port_helpers import one_thread  # noqa: F401  (autouse)

SMALL = dict(n_levels=4, table_size=1 << 10, base_res=4, max_res=32, aabb_min=(-1.0, -1.0, 3.0),
             aabb_max=(1.0, 1.0, 5.0), n_samples=48)


def _cfgs(**kw):
    j = jnf.FieldConfig(**kw)
    return j, tnf.FieldConfig(**dataclasses.asdict(j))


def _as_numpy(p) -> dict:
    return {f.name: jax.tree_util.tree_map(np.asarray, getattr(p, f.name)) for f in dataclasses.fields(p)}


def _random_field(jcfg, seed, scale=0.5):
    """A JAX field whose tables are far from their tiny initial values (so
    the encoding matters), and the same field in the port."""
    p = jnf.init_field(jcfg, seed)
    rng = np.random.default_rng(seed + 100)
    p = dataclasses.replace(p, tables=jnp.asarray(rng.normal(0, scale, p.tables.shape).astype(np.float32)))
    return p, bridge.field_params_from_numpy(_as_numpy(p), "cpu")


def _sphere_masks(wh=32, n_cams=4, focal=40.0, center=(0.0, 0.0, 4.0), radius=0.5):
    """Ring cameras of both packages and the analytic sphere's masks."""
    jc = j_ring(n_cams, w=wh, h=wh, focal=focal)
    tc = t_ring(n_cams, w=wh, h=wh, focal=focal, device="cpu")
    masks = []
    for cam in jc:
        view = np.asarray(cam.view, np.float64)
        c = view[:3, :3] @ np.asarray(center) + view[:3, 3]
        yy, xx = np.mgrid[0:wh, 0:wh] + 0.5
        d = np.stack([(xx - wh / 2) / focal, (yy - wh / 2) / focal, np.ones_like(xx)], -1)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        b = d @ c
        masks.append((b * b - (c @ c - radius**2) > 0).astype(np.float32))
    return jc, tc, np.stack(masks)


def test_init_field_equals_jax():
    """Both packages draw the tables in [L, T, F] order from one numpy seed."""
    jcfg, tcfg = _cfgs(**SMALL)
    jp, tp = jnf.init_field(jcfg, 3), tnf.init_field(tcfg, 3, "cpu")
    ref = bridge.field_params_from_numpy(_as_numpy(jp), "cpu")
    assert np.array_equal(np.asarray(jp.tables).transpose(0, 2, 1), tp.tables.detach().numpy())
    for a, b in zip(tp.parameters(), ref.parameters(), strict=True):
        assert torch.equal(a, b)
    j4, t4 = jnf.init_field4d(jcfg, vector_res=8, seed=2), tnf.init_field4d(tcfg, vector_res=8, seed=2, device="cpu")
    for a, b in zip(t4.parameters(), bridge.field_params_from_numpy(_as_numpy(j4), "cpu").parameters(), strict=True):
        assert torch.equal(a, b)


def test_hash_indices_equal_on_grid_vertices_and_far_face():
    """Equal indices for every integer corner, the far faces (pts01 = 1,
    corner res + 1) included. Probed through the JAX encoding: with table
    row t holding the value t and each point on a grid vertex of one level
    (power-of-two resolutions, so pts01 * res is exact), only corner 0 has
    weight, and that level's feature IS its row index."""
    jcfg, tcfg = _cfgs(**SMALL)
    t = jcfg.table_size
    tab = np.zeros((jcfg.n_levels, jcfg.n_features, t), np.float32)
    tab[:, 0] = np.arange(t)
    tab[:, 1] = np.arange(t) + 0.5
    rng = np.random.default_rng(0)
    for lvl, res in enumerate(tnf.level_resolutions(tcfg)):
        k = rng.integers(0, res + 2, size=(600, 3))
        k[:6] = [[res, res, res], [res + 1] * 3, [0, 0, 0], [res, 0, res + 1], [0, res + 1, res], [1, res, 0]]
        pts = (k / res).astype(np.float32)
        assert np.array_equal(pts * np.float32(res), k.astype(np.float32))
        enc = np.asarray(jnf.hash_encode(jnp.asarray(tab), jnp.asarray(pts), jcfg))
        idx = tnf.hash_indices(torch.as_tensor(pts), tcfg)[lvl, :, 0].numpy()
        np.testing.assert_array_equal(enc[:, jcfg.n_features * lvl].astype(np.int64), idx)
        np.testing.assert_array_equal(enc[:, jcfg.n_features * lvl + 1], idx + 0.5)


def test_hash_indices_equal_at_default_resolutions():
    """At FieldConfig's own level resolutions (growth 1.38), the rows each
    random point reads in the port equal the rows its JAX gradient touches."""
    jcfg, tcfg = _cfgs(table_size=1 << 12)
    pts = np.random.default_rng(1).uniform(size=(48, 3)).astype(np.float32)
    tables = jnp.zeros((jcfg.n_levels, jcfg.n_features, jcfg.table_size), jnp.float32)
    grads = jax.vmap(jax.grad(lambda tb, p: jnf.hash_encode(tb, p[None], jcfg).sum()), (None, 0))(
        tables, jnp.asarray(pts))
    touched = np.asarray(grads)[:, :, 0] != 0  # [N, L, T]
    idx = tnf.hash_indices(torch.as_tensor(pts), tcfg).numpy()  # [L, N, 8]
    for n in range(len(pts)):
        for lvl in range(jcfg.n_levels):
            assert set(np.flatnonzero(touched[n, lvl])) == set(idx[lvl, n].tolist())


def test_hash_encode_density_color_values_and_gradients():
    """Encoding, density and colour values within 1e-6 relative; gradients
    of a scalar of density and colour wrt the tables and every MLP layer
    within rtol 1e-4, atol 1e-6 x the gradient's inf-norm (the tables'
    gradient is an index-accumulate in another summation order)."""
    jcfg, tcfg = _cfgs(**SMALL)
    jp, tp = _random_field(jcfg, 4)
    rng = np.random.default_rng(5)
    pts = np.concatenate([rng.uniform(-1.1, 1.1, (400, 2)), rng.uniform(2.9, 5.1, (400, 1))], 1).astype(np.float32)
    dirs = rng.normal(size=(400, 3)).astype(np.float32)
    w = rng.normal(size=(400, 3)).astype(np.float32)

    enc_j = np.asarray(jnf.hash_encode(jp.tables, jnp.asarray(np.clip((pts - [-1, -1, 3]) / 2, 0, 1)), jcfg))
    enc_t = tnf.hash_encode(tp.tables, torch.as_tensor(np.clip((pts - [-1, -1, 3]) / 2, 0, 1).astype(np.float32)),
                            tcfg).detach().numpy()
    np.testing.assert_allclose(enc_t, enc_j, rtol=1e-6, atol=1e-6 * np.abs(enc_j).max())

    def loss_j(p):
        s, geo = jnf.query_density(p, jnp.asarray(pts), jcfg)
        c = jnf.query_color(p, geo, jnp.asarray(dirs))
        return (jnp.log1p(s) * 0.1).sum() + (c * w).sum(), (s, c)

    (lj, (sj, cj)), gj = jax.value_and_grad(loss_j, has_aux=True)(jp)
    s, geo = tnf.query_density(tp, torch.as_tensor(pts), tcfg)
    c = tnf.query_color(tp, geo, torch.as_tensor(dirs))
    lt = (torch.log1p(s) * 0.1).sum() + (c * torch.as_tensor(w)).sum()
    lt.backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(c.detach().numpy(), np.asarray(cj), rtol=1e-5, atol=1e-6)
    assert abs(float(lt.detach()) - float(lj)) <= 1e-5 * abs(float(lj))
    ref = bridge.field_params_from_numpy(_as_numpy(gj), "cpu")
    for got, want in zip(tp.parameters(), ref.parameters(), strict=True):
        g, r = got.grad.numpy(), want.detach().numpy()
        np.testing.assert_allclose(g, r, rtol=1e-4, atol=1e-6 * np.abs(r).max())


@pytest.mark.parametrize("occupied", [False, True], ids=["no_occupancy", "occupancy"])
@pytest.mark.parametrize("jitter", [False, True], ids=["centres", "shared_jitter"])
def test_render_rays_matches_jax(jitter, occupied):
    """render_rays with the step centres or the JAX package's jitter draws
    handed to the port, with and without the carved occupancy grid: rgb,
    alpha and depth within 1e-5 (depth relative), and the gradient of a
    scalar of them wrt the tables within rtol 1e-3, atol 1e-5 x inf-norm."""
    jcfg, tcfg = _cfgs(**SMALL)
    jp, tp = _random_field(jcfg, 6, scale=2.0)
    jc, tc, masks = _sphere_masks()
    occ_j = jnf.occupancy_from_masks(jc, masks, jcfg, res=16) if occupied else None
    occ_t = tnf.occupancy_from_masks(tc, masks, tcfg, res=16) if occupied else None
    rng = np.random.default_rng(7)
    o = np.tile(np.asarray(jc[0].camera_center, np.float32), (64, 1))
    d = np.asarray([0.0, 0.0, 4.0], np.float32) + rng.uniform(-0.8, 0.8, (64, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    key = jax.random.PRNGKey(3) if jitter else None
    jit_t = torch.as_tensor(np.array(jax.random.uniform(key, (64, jcfg.n_samples)))) if jitter else None

    def loss_j(p):
        rgb, a, dep = jnf.render_rays(p, jnp.asarray(o), jnp.asarray(d), jcfg, key, occupancy=occ_j)
        return (rgb.sum() + a.sum() + 0.1 * dep.sum()), (rgb, a, dep)

    (_, (rgb_j, a_j, dep_j)), gj = jax.value_and_grad(loss_j, has_aux=True)(jp)
    rgb, a, dep = tnf.render_rays(tp, torch.as_tensor(o), torch.as_tensor(d), tcfg, jit_t, occupancy=occ_t)
    (rgb.sum() + a.sum() + 0.1 * dep.sum()).backward()
    np.testing.assert_allclose(rgb.detach().numpy(), np.asarray(rgb_j), atol=1e-5)
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(a_j), atol=1e-5)
    np.testing.assert_allclose(dep.detach().numpy(), np.asarray(dep_j), rtol=1e-5, atol=1e-5)
    assert float(a.detach().max()) > 0.1  # the rays see the field
    gt = np.asarray(gj.tables).transpose(0, 2, 1)
    np.testing.assert_allclose(tp.tables.grad.numpy(), gt, rtol=1e-3, atol=1e-5 * np.abs(gt).max())


def test_occupancy_dilation_and_tightened_bounds_are_equal():
    """occupancy_from_masks (with and without dilation), dilate_occupancy and
    tighten_ray_bounds: equal to the JAX package's."""
    jcfg, tcfg = _cfgs(**SMALL)
    jc, tc, masks = _sphere_masks(wh=40, n_cams=6)
    for dilate in (0, 1, 2):
        occ_j = np.asarray(jnf.occupancy_from_masks(jc, masks, jcfg, res=24, dilate=dilate))
        occ_t = tnf.occupancy_from_masks(tc, masks, tcfg, res=24, dilate=dilate)
        np.testing.assert_array_equal(occ_t.numpy(), occ_j)
    assert 0.02 < occ_j.mean() < 0.5
    raw = np.array(jnf.occupancy_from_masks(jc, masks, jcfg, res=24, dilate=0))
    np.testing.assert_array_equal(tnf.dilate_occupancy(torch.as_tensor(raw)).numpy(),
                                  np.asarray(jnf.dilate_occupancy(jnp.asarray(raw))))

    rng = np.random.default_rng(8)
    o = rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32) + np.float32([0, 0, 0.5])
    d = (np.float32([0, 0, 4]) + rng.uniform(-1, 1, (300, 3)).astype(np.float32)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tmin = rng.uniform(2.0, 3.0, 300).astype(np.float32)
    tmax = tmin + rng.uniform(0.5, 3.0, 300).astype(np.float32)
    lo_j, hi_j = jnf.tighten_ray_bounds(jnp.asarray(raw), jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin),
                                        jnp.asarray(tmax), jcfg)
    lo_t, hi_t = tnf.tighten_ray_bounds(torch.as_tensor(raw), *(torch.as_tensor(a) for a in (o, d, tmin, tmax)),
                                        tcfg)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))
    assert (hi_t - lo_t < torch.as_tensor(tmax - tmin) - 1e-3).any()  # some rays did tighten
    pts = torch.as_tensor(rng.uniform(-1.2, 1.2, (500, 3)).astype(np.float32) + np.float32([0, 0, 4]))
    np.testing.assert_array_equal(tnf._occ_lookup(torch.as_tensor(raw), pts, tcfg).numpy(),
                                  np.asarray(jnf._occ_lookup(jnp.asarray(raw), jnp.asarray(pts.numpy()), jcfg)))


def test_density_grid_and_occupancy_from_density_match_jax():
    """The dense sigma grid within rtol 1e-4 (its axes, from torch.linspace,
    lie within 2 float32 ulps of jnp.linspace's, and sigma = 25 exp(out)
    amplifies that), equal whatever the port's slice batching; the occupancy
    thresholded from it equal."""
    jcfg, tcfg = _cfgs(**SMALL)
    jp, tp = _random_field(jcfg, 9, scale=3.0)
    for lo, hi, n in ((-1.0, 1.0, 20), (3.0, 5.0, 512), (-0.8, 0.8, 1024), (3.2, 4.8, 256)):
        got = torch.linspace(torch.tensor(lo), torch.tensor(hi), n).numpy()
        want = np.asarray(jnp.linspace(np.float32(lo), np.float32(hi), n))
        assert np.abs(got - want).max() <= 2 * np.spacing(np.float32(max(abs(lo), abs(hi))))
    g_j = np.asarray(jnf.density_grid(jp, jcfg, res=20))
    g_t = tnf.density_grid(tp, tcfg, res=20)
    np.testing.assert_allclose(g_t.numpy(), g_j, rtol=1e-4, atol=1e-6 * np.abs(g_j).max())
    assert torch.equal(tnf.density_grid(tp, tcfg, res=20, chunk=1), g_t)
    thr = float(np.median(g_j))
    np.testing.assert_array_equal(tnf.occupancy_from_density(tp, tcfg, res=20, threshold=thr).numpy(),
                                  np.asarray(jnf.occupancy_from_density(jp, jcfg, res=20, threshold=thr)))


def test_field4d_and_temporal_partition_match_jax():
    """The 4D field's composed encoding and density within 1e-5, its
    gradient wrt the tables and vectors within rtol 1e-4; the adaptive
    temporal partition equal."""
    jcfg, tcfg = _cfgs(n_levels=3, table_size=1 << 10, base_res=4, max_res=16)
    jp = jnf.init_field4d(jcfg, vector_res=8, seed=1)
    rng = np.random.default_rng(10)
    jp = dataclasses.replace(jp, tables=jnp.asarray(rng.normal(0, 0.5, jp.tables.shape).astype(np.float32)),
                             vectors=jnp.asarray(rng.uniform(0.5, 1.5, jp.vectors.shape).astype(np.float32)))
    tp = bridge.field_params_from_numpy(_as_numpy(jp), "cpu")
    pts = rng.uniform(-1.05, 1.05, (200, 3)).astype(np.float32)
    t01 = rng.uniform(0, 1, 200).astype(np.float32)

    def loss_j(p):
        s, geo = jnf.query_density_4d(p, jnp.asarray(pts), jnp.asarray(t01), jcfg)
        return jnp.log1p(s).sum() + geo.sum(), s

    (_, s_j), gj = jax.value_and_grad(loss_j, has_aux=True)(jp)
    s, geo = tnf.query_density_4d(tp, torch.as_tensor(pts), torch.as_tensor(t01), tcfg)
    (torch.log1p(s).sum() + geo.sum()).backward()
    np.testing.assert_allclose(s.detach().numpy(), np.asarray(s_j), rtol=1e-5, atol=1e-6)
    enc_j = np.asarray(jnf.hash_encode_4d(jp, jnp.asarray(np.clip(pts, 0, 1)), jnp.asarray(t01), jcfg))
    enc_t = tnf.hash_encode_4d(tp, torch.as_tensor(np.clip(pts, 0, 1)), torch.as_tensor(t01), tcfg)
    np.testing.assert_allclose(enc_t.detach().numpy(), enc_j, rtol=1e-5, atol=1e-6)
    for got, want in ((tp.tables.grad, np.asarray(gj.tables).transpose(0, 1, 3, 2)),
                      (tp.vectors.grad, np.asarray(gj.vectors))):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())

    for motion, budget, max_len in (([0.1] * 10 + [2.0] + [0.1] * 5, 1.0, 100),
                                    (list(rng.uniform(0, 1, 40)), 3.0, 7), ([], 1.0, 100)):
        assert tnf.adaptive_temporal_partition(motion, budget, max_len) == \
            jnf.adaptive_temporal_partition(motion, budget, max_len)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tnf.init_field(tnf.FieldConfig(table_size=16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tnf.init_field4d(tnf.FieldConfig(table_size=16))
