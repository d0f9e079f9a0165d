"""The port's multi-process training (gaustar_tpu_torch/parallel/) on the
CPU: ranks with gloo, spawned per group with a file:// rendezvous under the
test's temporary directory (tests/port_dist.py).

  - gauss2d on cam=1 x gauss=2 and cam=2 x gauss=2, on tests/test_gauss2d.py's
    scene, against the JAX package's single-device mean of
    jax.grad(compute_losses) at that file's tolerances, and against the
    port's own single-device step;
  - camera DP on 2 ranks against the port's single-device step over 3 SGD
    steps (the parity __graft_entry__.py:dryrun_multichip asserts);
  - render_gauss_sharded against the single-device render;
  - shard_sugar's round trip; the collectives; launch in one process."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import port_dist
from gaustar_tpu.train.refine import RefineConfig as JRefineConfig
from gaustar_tpu.train.refine import compute_losses as jcompute_losses
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
from gaustar_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from gaustar_tpu_torch.parallel import gauss2d, launch
from gaustar_tpu_torch.train.optimizer import sgd
from gaustar_tpu_torch.train.refine import RefineConfig, compute_losses, compute_losses_multi, named_grads
from gaustar_tpu_torch.utils.synthetic import ring_cameras, synthetic_frame
from port_helpers import one_thread  # noqa: F401
from test_gauss2d import _scene

CFG = dict(num_iterations=100, loose_bind_from=10**9, do_sh_warmup=False)
SH_DEG = 1
BG = (0.1, 0.2, 0.3)
LEAVES = ("points", "scales", "complex2d", "densities", "sh_dc", "sh_rest")


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def scene():
    """tests/test_gauss2d.py's scene (icosphere(2), 320 faces, 2 cameras,
    64x64): the JAX package's objects and their numpy fields."""
    params, config, data, rcfg = _scene(impl="jax")
    p_np = {fl.name: _np(getattr(params, fl.name)) for fl in dataclasses.fields(params)}
    c_np = dict(faces=_np(config.faces), bary=_np(config.bary), thickness=_np(config.thickness),
                n_gaussians_per_face=config.n_gaussians_per_face, sh_levels=config.sh_levels,
                min_scale=config.min_scale, max_scale=config.max_scale, n_verts=len(p_np["points"]))
    cams = {k: _np(getattr(data.cameras, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")}
    cams.update(width=data.cameras.width, height=data.cameras.height)
    d_np = {k: _np(getattr(data, k)) for k in ("gt_images", "gt_depths", "margins", "ref_edge_len",
                                               "ref_area", "edges", "adj_faces")}
    d_np["cameras"] = cams
    return dict(jax=(params, config, data, rcfg), params=p_np, config=c_np, data=d_np)


@pytest.fixture(scope="module", autouse=True)
def ranks(scene, tmp_path_factory):
    """Both groups of ranks, started before anything else of the module so
    that they run while the JAX reference computes: two ranks
    (port_dist.two_ranks) and four (gauss2d on cam 2 x gauss 2)."""
    s = scene
    root = tmp_path_factory.mktemp("ranks")
    handles = {
        "two": port_dist.start(port_dist.two_ranks, 2, root, s["params"], s["config"], s["data"], CFG,
                               port_dist.cloud(), BG),
        "four": port_dist.start(port_dist.gauss2d_ranks, 4, root, 2, s["params"], s["config"], s["data"], CFG,
                                SH_DEG),
    }
    results = {}

    def get(name):
        if name not in results:
            results[name] = port_dist.collect(handles[name])
        return results[name]

    yield get
    for name in handles:
        if name not in results:
            port_dist.collect(handles[name])


@pytest.fixture(scope="module")
def two(ranks):
    return ranks("two")


@pytest.fixture(scope="module")
def four(ranks):
    return ranks("four")


@pytest.fixture(scope="module")
def jax_per_cam(scene):
    """jax.grad(compute_losses) of each camera: (loss, {leaf: gradient}).

    Jitted with XLA's backend optimisation off (LLVM -O0), which rounds as
    the op-by-op (eager) gradient does: at the default level, XLA's fused
    CPU code rounds one (pixel, pair) decision of this scene the other way,
    and one gaussian's colour gradient moves by 5% (1.2e-6 of sh_rest's
    3.8e-5). The port's single-device gradient equals the eager one within
    1.3e-9."""
    params, config, data, rcfg = scene["jax"]
    cfg = JRefineConfig(**CFG)
    uw = jnp.zeros((params.scales.shape[0],), jnp.float32)
    pre = params.sh_dc[:, 0, :] * 0.0
    f = jax.jit(jax.value_and_grad(
        lambda p, c: jcompute_losses(p, config, data, c, jnp.int32(1), cfg, rcfg, SH_DEG, uw, pre)[0]))
    f = f.lower(params, jnp.int32(0)).compile(compiler_options={"xla_backend_optimization_level": 0})
    out = []
    for c in range(2):
        loss, g = f(params, jnp.int32(c))
        out.append((float(loss), {k: _np(getattr(g, k)) for k in LEAVES}))
    return out


@pytest.fixture(scope="module")
def port_per_cam(scene):
    """The port's single-device (loss, gradients) of each camera."""
    params, config, data = port_dist.port_scene(scene["params"], scene["config"], scene["data"])
    out = []
    for c in range(2):
        loss, _ = compute_losses(params, config, data, c, 1, RefineConfig(**CFG), RasterConfig(), SH_DEG)
        out.append((loss.item(), {k: g.numpy() for k, g in named_grads(loss, params).items() if k in LEAVES}))
    return out


def _gauss2d_row(ranks, gauss):
    """Cam row 0's gradients, the shards concatenated in gauss order."""
    row = sorted((r for r in ranks if r.get("cam_rank", 0) == 0), key=lambda r: r.get("gauss_rank", 0))
    assert len(row) == gauss
    return {k: row[0]["grads"][k] if k == "points" else np.concatenate([r["grads"][k] for r in row])
            for k in LEAVES}


def _assert_gauss2d_matches(ranks, per_cam, cams, gauss, reference):
    loss_ref = np.mean([per_cam[c][0] for c in cams])
    g_ref = {k: np.mean([per_cam[c][1][k] for c in cams], axis=0) for k in LEAVES}
    for r in ranks:
        np.testing.assert_allclose(r["loss"], loss_ref, rtol=1e-4)
        assert r["num_pairs"] > 0
        # points are replicated: every rank holds the same gradient
        np.testing.assert_array_equal(r["grads"]["points"], ranks[0]["grads"]["points"])
    got = _gauss2d_row(ranks, gauss)
    for name in LEAVES:
        a, b = g_ref[name], got[name]
        scale = np.abs(a).max() + 1e-12
        # tests/test_gauss2d.py:108-118. Its 1e-6 floor on atol covers reading
        # gradients back as params_before - params_after; against the port's
        # own step, whose gradients these are, the floor is 1e-9 (complex2d's
        # gradients at the rest state are rounding noise of about 1e-11).
        floor = 1e-9 if reference == "port" else 1e-6
        np.testing.assert_allclose(b, a, rtol=2e-4, atol=max(2e-4 * scale, floor),
                                   err_msg=f"gradient mismatch in {name}")


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_gauss2d_cam1_gauss2_matches_single_device(jax_per_cam, port_per_cam, two, reference):
    per_cam = port_per_cam if reference == "port" else jax_per_cam
    _assert_gauss2d_matches([r["gauss2d"] for r in two], per_cam, [0], 2, reference)


@pytest.mark.parametrize("reference", ["port", "jax"])
def test_gauss2d_cam2_gauss2_matches_single_device_mean(jax_per_cam, port_per_cam, four, reference):
    assert sorted((r["cam_rank"], r["gauss_rank"]) for r in four) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    per_cam = port_per_cam if reference == "port" else jax_per_cam
    _assert_gauss2d_matches(four, per_cam, [0, 1], 2, reference)
    # the two cam rows hold the same averaged gradients
    by = {(r["cam_rank"], r["gauss_rank"]): r for r in four}
    for g in range(2):
        for name in LEAVES:
            np.testing.assert_array_equal(by[(0, g)]["grads"][name], by[(1, g)]["grads"][name])


def test_camera_dp_matches_single_device_three_sgd_steps(two):
    """Each of three camera-DP SGD steps applies the single-device step's
    gradient (the mean over all four cameras) at tests/test_gauss2d.py's
    rtol, and the parameters after the three steps agree within 2e-4 of their
    move. The gradients are captured as the step applies them: read back as
    a parameter change at lr 1e-2 they would be float32 rounding of the
    parameters."""
    params, config, data, _, rcfg = synthetic_frame(n_cams=4, w=32, h=32, device="cpu")
    cfg = RefineConfig(num_iterations=4, loose_bind_from=10**9, do_sh_warmup=False)
    start = {k: v.detach().clone().numpy() for k, v in params.named()}
    update = sgd(1e-2)
    losses, grads = [], []
    for it in range(1, 4):
        loss, _ = compute_losses_multi(params, config, data, [0, 1, 2, 3], it, cfg, rcfg, 0)
        g = named_grads(loss, params)
        if it == 1:
            # rank 0's cameras alone: what a step that drops rank 1's would apply
            half_loss, _ = compute_losses_multi(params, config, data, [0, 1], it, cfg, rcfg, 0)
            half = {k: v.numpy() for k, v in named_grads(half_loss, params).items()}
        update(params, g)
        losses.append(loss.item())
        grads.append({k: v.numpy() for k, v in g.items()})

    def tol(ref):
        return max(2e-4 * np.abs(ref).max(), 1e-9)

    def move(name):
        return np.abs(getattr(params, name).detach().numpy() - start[name]).max()

    def param_tol(name):
        # 2e-4 of the three steps' move, and no less than 8 ulp of the leaf
        end = np.float32(np.abs(getattr(params, name).detach().numpy()).max())
        return max(2e-4 * move(name), 8 * float(np.spacing(end)))

    # The check resolves a step that drops a rank's cameras or sums over
    # "cam" (twice the mean) on every leaf the step moves. complex2d's
    # gradient at the rest state is rounding noise (about 5e-11) and sh_rest's
    # is zero at SH degree 0.
    for name in ("points", "scales", "densities", "sh_dc"):
        ref = grads[0][name]
        assert np.abs(half[name] - ref).max() > 10 * tol(ref), name
        assert np.abs(ref).max() > 10 * tol(ref), name
    for r in two:
        dp = r["camera_dp"]
        np.testing.assert_allclose(dp["losses"], losses, rtol=1e-4)
        assert len(dp["grads"]) == 3
        for it, (got, ref) in enumerate(zip(dp["grads"], grads), start=1):
            for name in LEAVES:
                np.testing.assert_allclose(got[name], ref[name], rtol=2e-4, atol=tol(ref[name]),
                                           err_msg=f"camera-DP gradient mismatch in {name} at step {it}")
        for name in LEAVES:
            np.testing.assert_allclose(dp["params"][name], getattr(params, name).detach().numpy(), rtol=0,
                                       atol=param_tol(name), err_msg=f"camera-DP 3-step mismatch in {name}")
    for name in ("points", "scales", "densities", "sh_dc"):
        # the parameter check resolves the three steps' move on each leaf that moves
        assert move(name) > 5 * param_tol(name), name
    np.testing.assert_array_equal(two[0]["camera_dp"]["params"]["points"], two[1]["camera_dp"]["params"]["points"])
    assert two[0]["camera_dp"]["num_pairs"] == two[1]["camera_dp"]["num_pairs"] > 0


def test_render_gauss_sharded_matches_single_device(two):
    m, s, q, o, c = (torch.as_tensor(a) for a in port_dist.cloud())
    cam = ring_cameras(1, w=64, h=48, focal=60.0, device="cpu")[0]
    img, aux = rasterize(m, quat_scale_to_cov3d(s, q), o, c, cam, bg=BG, config=RasterConfig())
    assert aux.num_pairs > 0
    for r in two:
        assert r["render"]["num_pairs"] == aux.num_pairs
        np.testing.assert_allclose(r["render"]["img"], img.numpy(), atol=2e-5)


def test_collectives_on_two_ranks(two):
    for rank, r in enumerate(two):
        c = r["collectives"]
        np.testing.assert_array_equal(c["full"], np.repeat([1.0, 2.0], 6).reshape(4, 3))
        # d/dx of sum_r (full * w_r) = (sum_r w_r)[own rows], w_r = arange * (r + 1)
        w = np.arange(12, dtype=np.float32).reshape(4, 3) * 3.0
        np.testing.assert_array_equal(c["grad"], w[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(c["rows"], [0, 1, 10, 11, 12])
        assert c["counts"] == [2, 3]
        np.testing.assert_array_equal(c["flat"][0], [3.0])
        np.testing.assert_array_equal(c["flat"][1], np.full((2, 2), 2.0))
        # sum_r (r + 1) z_r with z_r = r + 1: 1 + 4; each rank's loss reads the
        # sum, so d/dz_k = (k + 1) x 2 arange(3)
        np.testing.assert_array_equal(c["sum"], np.full(3, 5.0))
        np.testing.assert_array_equal(c["sum_grad"], (rank + 1) * 2 * np.arange(3.0))
        # gathers: x's [4, 3] f32, the counts' [2] and the padded rows' [6] i64;
        # reduces: x's cotangent [4, 3], the flat [5], the sum's [3] and its cotangent
        assert c["counted"]["bytes"] == {"all_gather": 48 + 16 + 48, "all_reduce": 48 + 20 + 12 + 12}
        assert all(t > 0 for t in c["counted"]["seconds"].values())
        assert r["info"]["world_size"] == 2 and r["info"]["backend"] == "gloo"


def test_shard_sugar_round_trips(scene):
    params = bridge.sugar_params_from_numpy(scene["params"], "cpu")
    config = bridge.sugar_config_from_numpy(scene["config"], "cpu")
    for d in (2, 4):
        shards = [gauss2d.shard_sugar(params, config, d, g) for g in range(d)]
        faces = torch.cat([c.faces for _, c in shards])
        assert torch.equal(faces, config.faces)
        for name, leaf in params.named():
            if name == "points":
                assert all(torch.equal(p.points, leaf) for p, _ in shards)
            else:
                assert torch.equal(torch.cat([getattr(p, name) for p, _ in shards]), leaf.detach())
        for g, (p, c) in enumerate(shards):
            assert c.faces.shape[0] * c.n_gaussians_per_face == p.scales.shape[0]
            assert all(leaf.is_leaf and leaf.requires_grad for _, leaf in p.named())
            from_np = bridge.sugar_shard_from_numpy(scene["params"], d, g, "cpu")
            for name, leaf in p.named():
                assert torch.equal(getattr(from_np, name), leaf)
    with pytest.raises(ValueError, match="must divide"):
        gauss2d.shard_sugar(params, config, 3, 0)


def test_launch_in_one_process_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert launch.initialize(device="cpu") is False
    mesh = launch.make_mesh(device="cpu")
    assert (mesh.cam, mesh.gauss, mesh.rank, mesh.cam_rank, mesh.gauss_rank) == (1, 1, 0, 0, 0)
    assert mesh.cam_group is None and mesh.gauss_group is None
    with pytest.raises(ValueError):
        launch.make_mesh(gauss=2, device="cpu")
    info = launch.runtime_info()
    assert info["world_size"] == 1 and not info["initialized_distributed"]
