"""The port's field at Instant-NGP's published options (models/neural_field.py
instant_ngp: 1:1 coarse levels, the SH-4 direction encoding, the colour net
fed all 16 density outputs) and its step (train/init_mesh.py:field_step) on
rays of several cameras, against the benchmark's plain reference
(benchmark/reference/field_step.py) on seeded random weights: the loss and
every leaf's gradient, each table level's included; the coarse levels' 1:1
rows; the SH values; the tightened ray bounds. The defaults (FieldConfig())
render as before, and train_field steps through field_step. Small sizes: 4
levels of 2^10 rows, 16 samples, 4 cameras at 32x32."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from benchmark import field_rays, scene as scene_mod
from benchmark.programs import field_step as field_program
from benchmark.reference import field_step as ref
from gaustar_tpu_torch.models import neural_field as nf
from gaustar_tpu_torch.ops.sh import sh_basis
from gaustar_tpu_torch.train import init_mesh
from port_helpers import one_thread  # noqa: F401  (autouse)

SEED = 2**31 + 77


def small_config(rays=64, tables_init=0.5) -> dict:
    """ngp_body160 at 4 cameras of 32x32 (two rings of 2), 4 levels of 2^10
    rows (two of them 1:1), 16 samples a ray, `rays` rays a step, tables
    uniform in +-tables_init (so that the encoding moves the loss)."""
    c = copy.deepcopy(scene_mod.load_json("configs", "ngp_body160"))
    c["mesh"]["n_lat"], c["mesh"]["n_lon"] = 9, 12
    rig = c["rig"]
    rig["focal"] = rig["focal"] * 32 / rig["width"]
    rig["width"] = rig["height"] = 32
    for ring in rig["rings"]:
        ring["cameras"] = 2
    c["field"].update(n_levels=4, table_size=1 << 10, base_res=4, max_res=16, n_samples=16)
    c["train"].update(rays_per_batch=rays, occupancy_res=16, tables_init=tables_init)
    return c


@pytest.fixture(scope="module")
def frame():
    config = small_config()
    return config, scene_mod.make_scene(config, SEED, "cpu")


def test_published_widths():
    cfg = nf.instant_ngp(table_size=1 << 10)
    assert nf.level_resolutions(nf.instant_ngp()) == [16, 22, 30, 42, 58, 80, 111, 153, 212, 294, 406, 561, 776,
                                                      1072, 1482, 2047]
    assert nf.level_dense(nf.instant_ngp()) == [True] * 5 + [False] * 11
    field = nf.init_field(cfg, 0, "cpu")
    shapes = [tuple(p.shape) for p in field.parameters()]
    assert shapes == [(16, 1 << 10, 2), (32, 64), (64,), (64, 16), (16,), (32, 64), (64,), (64, 64), (64,),
                      (64, 3), (3,)]
    assert field_rays.layer_widths(dataclasses.asdict(nf.instant_ngp())) == {
        "sigma": [(32, 64), (64, 16)], "color": [(32, 64), (64, 64), (64, 3)]}
    # The benchmark's configuration is this field in the body's AABB.
    block = scene_mod.load_json("configs", "ngp_body160")["field"]
    want = dataclasses.asdict(nf.instant_ngp(aabb_min=tuple(block["aabb_min"]), aabb_max=tuple(block["aabb_max"])))
    assert {k: tuple(v) if isinstance(v, list) else v for k, v in block.items()} == want


def test_coarse_levels_index_one_to_one_as_the_reference():
    cfg = nf.instant_ngp(n_levels=4, table_size=1 << 10, base_res=4, max_res=16)
    assert nf.level_dense(cfg) == [True, True, False, False]
    gen = torch.Generator().manual_seed(3)
    pts = torch.rand((500, 3), generator=gen)
    pts[:20] = torch.floor(pts[:20] * 6) / 6  # on grid vertices of the 6-cell level
    pts[20:40, 0] = 1.0  # on the far face
    pts[40:50] = 1.0
    rows = nf.hash_indices(pts, cfg)
    res = ref.level_resolutions(4, 4, 16)
    assert res == nf.level_resolutions(cfg)
    for lvl, r in enumerate(res):
        want, _ = ref.corner_rows(pts, r, 1 << 10, (r + 1) ** 3 <= 1 << 10)
        assert torch.equal(rows[lvl], want)
    x = pts[100] * res[0]
    c = torch.floor(x).long()
    assert int(rows[0, 100, 0]) == int(c[0] + (res[0] + 1) * c[1] + (res[0] + 1) ** 2 * c[2])
    assert int(rows.max()) < 1 << 10


def test_sh4_encoding_matches_the_reference():
    d = torch.nn.functional.normalize(torch.randn(300, 3, generator=torch.Generator().manual_seed(4)), dim=-1)
    got = sh_basis(3, d)
    assert got.shape == (300, 16)
    torch.testing.assert_close(got, ref.sh16(d), rtol=1e-6, atol=1e-6)


def _port(config, scene):
    return field_program.Program(scene, config, "cpu")


def test_tightened_bounds_equal_the_reference(frame):
    config, scene = frame
    prog, reference = _port(config, scene), ref.Reference(scene, config)
    assert torch.equal(prog.occupancy, reference.occ)
    assert 0 < float(prog.occupancy.mean()) < 1
    cams = [0, 1, 2, 3]
    px, py, _ = field_rays.draw(prog.fg, cams, 1, 256, 16, 32, "cpu")
    rays = [init_mesh.rays_for_pixels(prog.cameras[c], px[k].float() + 0.5, py[k].float() + 0.5)
            for k, c in enumerate(cams)]
    o, d = torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays])
    o_r, d_r = reference.rays(cams, px, py)
    torch.testing.assert_close(o, o_r, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(d, d_r, rtol=1e-6, atol=1e-6)
    tmin, tmax = nf.ray_bounds(o, d, prog.field_cfg, prog.occupancy)
    rmin, rmax = reference.bounds(o, d)
    assert torch.equal(tmin, rmin) and torch.equal(tmax, rmax)
    hits = tmax > tmin
    assert 0 < int(hits.sum()) < hits.numel()


def test_field_step_matches_the_reference(frame):
    """Three steps over the 4 cameras: each loss, the first step's gradient
    of every leaf (each table level apart) and the leaves after the steps,
    which are the reference's bit for bit (the same corner weights, float64
    sums of the tables' gradient, torch.optim.Adam on both sides)."""
    config, scene = frame
    prog, reference = _port(config, scene), ref.Reference(scene, config)
    assert set(prog.leaves()) == set(reference.leaves)
    assert len([k for k in reference.leaves if k.startswith("tables.")]) == 4
    for it in (1, 2, 3):
        loss = float(prog.step([0, 1, 2, 3], it))
        ref_loss, grads = reference.step([0, 1, 2, 3])
        assert loss == pytest.approx(ref_loss, rel=1e-5)
        if it == 1:
            got = prog._split([p.grad for p in prog.field.parameters()])
            for k, g in grads.items():
                scale = float(g.abs().max())
                assert scale > 0, k
                torch.testing.assert_close(got[k], g, rtol=1e-4, atol=1e-4 * scale, msg=k)
    for k, v in reference.leaves.items():
        torch.testing.assert_close(prog.leaves()[k], v, rtol=1e-4, atol=1e-4, msg=k)
        assert torch.equal(prog.leaves()[k], v), k


def test_draws_repeat_and_cover_the_foreground(frame):
    config, scene = frame
    masks = (scene.gt_depths < config["gt"]["miss"]).float()
    fg = field_rays.foreground(masks)
    a = field_rays.draw(fg, [2, 0], 5, 64, 16, 32, "cpu")
    b = field_rays.draw(fg, [2, 0], 5, 64, 16, 32, "cpu")
    c = field_rays.draw(fg, [2, 0], 6, 64, 16, 32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    px, py, jitter = a
    assert jitter.shape == (128, 16) and float(jitter.min()) >= 0 and float(jitter.max()) < 1
    for k, cam in enumerate([2, 0]):
        assert bool((masks[cam][py[k, :32], px[k, :32]] > 0.5).all())


def _former_render_rays(field, origins, dirs, cfg, jitter):
    """render_rays as the port computed it before the published options:
    the same slab, samples and compositing, through query_density and
    query_color(geo, raw dirs)."""
    lo, hi = torch.tensor(cfg.aabb_min), torch.tensor(cfg.aabb_max)
    inv = 1.0 / torch.where(dirs.abs() < 1e-9, torch.full_like(dirs, 1e-9), dirs)
    t0, t1 = (lo[None] - origins) * inv, (hi[None] - origins) * inv
    tmin = torch.clamp_min(torch.minimum(t0, t1).amax(dim=-1), 1e-3)
    tmax = torch.maximum(torch.maximum(t0, t1).amin(dim=-1), tmin + 1e-3)
    n = cfg.n_samples
    frac = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    frac = frac[None] + (jitter - 0.5) / n
    span = tmax - tmin
    ts = tmin[:, None] + frac * span[:, None]
    delta = span[:, None] / n
    pts = origins[:, None, :] + dirs[:, None, :] * ts[..., None]
    sigma, geo = nf.query_density(field, pts.reshape(-1, 3), cfg)
    rgb = nf.query_color(field, geo, dirs[:, None].expand(pts.shape).reshape(-1, 3))
    sigma, rgb = sigma.reshape(ts.shape), rgb.reshape(*ts.shape, 3)
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=-1)
    w = alpha * trans
    acc = w.sum(dim=1)
    return (w[..., None] * rgb).sum(dim=1), acc, (w * ts).sum(dim=1) / torch.clamp_min(acc, 1e-8)


def test_defaults_render_as_before():
    cfg = nf.FieldConfig(aabb_min=(-1.0, -1.0, 3.0), aabb_max=(1.0, 1.0, 5.0), n_samples=32)
    assert (cfg.sh_degree, cfg.feed_density, cfg.dense_coarse, cfg.color_inputs) == (0, False, False, 18)
    assert not any(nf.level_dense(cfg))
    field = nf.init_field(cfg, 1, "cpu")
    with torch.no_grad():
        field.tables.uniform_(-0.5, 0.5, generator=torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(6)
    origins = torch.zeros(40, 3)
    dirs = torch.nn.functional.normalize(torch.randn(40, 3, generator=gen) * 0.2 + torch.tensor([0.0, 0.0, 1.0]),
                                         dim=-1)
    jitter = torch.rand((40, 32), generator=gen)
    got = nf.render_rays(field, origins, dirs, cfg, jitter)
    want = _former_render_rays(field, origins, dirs, cfg, jitter)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_field_steps_through_field_step(monkeypatch):
    """train_field calls field_step once an iteration with its own draw."""
    calls = []
    original = init_mesh.field_step

    def counting(*args):
        calls.append(args[5:8])
        return original(*args)

    monkeypatch.setattr(init_mesh, "field_step", counting)
    from gaustar_tpu_torch.utils.synthetic import ring_cameras

    cams = ring_cameras(2, w=16, h=16, focal=20.0, device="cpu")
    images = np.full((2, 16, 16, 3), 0.5, np.float32)
    masks = np.zeros((2, 16, 16), np.float32)
    masks[:, 4:12, 4:12] = 1.0
    cfg = init_mesh.InitMeshConfig(iterations=2, rays_per_batch=32, occupancy_res=8)
    fcfg = nf.FieldConfig(n_levels=2, table_size=1 << 8, max_res=32, aabb_min=(-1.0, -1.0, 3.0),
                          aabb_max=(1.0, 1.0, 5.0), n_samples=8)
    init_mesh.train_field(cams, images, masks, cfg, fcfg, seed=2)
    assert len(calls) == 2
    cam_idx, px, py = calls[0]
    assert len(cam_idx) == 1 and px.shape == py.shape == (1, 32)
