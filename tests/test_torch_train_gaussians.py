"""Vanilla 3DGS in the port against the JAX package on
tests/test_densify.py:60's scene (300 points near the sphere of
synthetic_frame, 4 cameras at 48x48): create_from_pcd, render, the SH
warmup and one training step's loss and gradients. The training runs are in test_torch_train_gaussians_run.py. The
GT is the port's synthetic_frame (equal to the JAX package's within 3e-5,
tests/test_torch_refine.py), handed to both packages. The JAX side renders
with RasterConfig(impl="jax", max_per_tile=4096): the default 512 truncates
long tile lists."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gaustar_tpu.cameras import index_camera as jindex, stack_cameras
from gaustar_tpu.models import gaussians as jg
from gaustar_tpu.ops import losses as jlosses
from gaustar_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from gaustar_tpu.utils.synthetic import ring_cameras
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.cameras import index_camera
from gaustar_tpu_torch.models import gaussians as tg
from gaustar_tpu_torch.train import train_gaussians as ttrain
from gaustar_tpu_torch.utils.synthetic import synthetic_frame
from port_helpers import one_thread, perturbed_gaussians  # noqa: F401  (one_thread: autouse)

FIELDS = [f.name for f in dataclasses.fields(jg.GaussianParams)]
JRC = JRasterConfig(max_pairs=1 << 14, chunk=32, max_per_tile=4096, impl="jax")
# tests/test_densify.py:60's schedule: densify at 19, 39 (10 < it < 50, (it + 1) % 20 == 0).
CFG = dict(iterations=60, densify_from_iter=10, densify_until_iter=50, densification_interval=20,
           opacity_reset_interval=10_000, bucket=256, bg_color=(0.0, 1.0, 0.0), sh_warmup_every=20)


def _np(x):
    return np.array(x)


def make_scene():
    """{pts, cols, the cameras and GT of both packages}."""
    _, _, td, _, _ = synthetic_frame(n_cams=4, w=48, h=48, subdiv=1, device="cpu")
    jcams = stack_cameras(ring_cameras(4, w=48, h=48))
    rng = np.random.default_rng(2)
    pts = rng.normal(scale=0.4, size=(300, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    cols = rng.uniform(size=(300, 3)).astype(np.float32)
    cams = {k: _np(getattr(jcams, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")}
    tcams = bridge.camera_from_numpy(**cams, width=48, height=48, device="cpu")
    return dict(jcams=jcams, jgt=jnp.asarray(td.gt_images.numpy()), pts=pts, cols=cols, tcams=tcams,
                gt=td.gt_images)


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def jax_render(jp, jcam, sh_deg=None):
    """The JAX package's render, jitted (eagerly it dispatches op by op)."""
    return jax.jit(lambda p, c: jg.render(p, c, bg=(0, 1, 0), sh_deg=sh_deg, raster_config=JRC))(jp, jcam)


def _port(jp):
    return bridge.gaussian_params_from_numpy({k: _np(getattr(jp, k)) for k in FIELDS}, "cpu")


def test_create_from_pcd_matches_jax(scene):
    """Every field but the scales within 1e-6 relative. The log-scales are
    log(sqrt(dist2)): at z = 4 dist2 agrees within the KNN tolerance of
    2e-5 (tests/test_torch_knn.py), so they agree within 0.5 x 2e-5 / dist2."""
    jp = jg.create_from_pcd(scene["pts"], scene["cols"])
    tp = tg.create_from_pcd(scene["pts"], scene["cols"], device="cpu")
    for k in FIELDS:
        if k != "scaling":
            np.testing.assert_allclose(getattr(tp, k).numpy(), _np(getattr(jp, k)), rtol=1e-6, atol=1e-7, err_msg=k)
    dist2 = np.exp(2.0 * _np(jp.scaling)[:, 0])
    assert (np.abs(tp.scaling.numpy() - _np(jp.scaling)) <= 0.5 * 2e-5 / dist2[:, None]).all()
    assert (tp.scaling.numpy() == tp.scaling.numpy()[:, :1]).all()  # isotropic
    assert not tp.xyz.requires_grad
    assert tg.get_features(tp).shape == (300, 9, 3)
    np.testing.assert_allclose(tg.get_opacity(tp).numpy(), 0.1, rtol=1e-6)


@pytest.mark.parametrize("sh_deg", [0, 1, None], ids=["deg0", "deg1", "all_bands"])
def test_render_matches_jax(scene, sh_deg):
    """Image within 1e-5 (the golden tolerance), radii exact, on every camera
    of the frame; seeded SH bands so that each degree shows."""
    rng = np.random.default_rng(5)
    jp = jg.create_from_pcd(scene["pts"], scene["cols"])
    jp = dataclasses.replace(jp, features_rest=jnp.asarray(rng.normal(scale=0.2, size=(300, 8, 3)), jnp.float32),
                             opacity=jnp.asarray(rng.normal(size=(300, 1)), jnp.float32))
    tp = _port(jp)
    for c in range(4):
        jimg, jaux = jax_render(jp, jindex(scene["jcams"], c), sh_deg)
        timg, taux = tg.render(tp, index_camera(scene["tcams"], c), bg=(0, 1, 0), sh_deg=sh_deg)
        np.testing.assert_allclose(timg.numpy(), _np(jimg), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(taux.radii.numpy(), _np(jaux.radii))


def test_sh_warmup_truncation_equals_masked_bands(scene):
    """The JAX loop zeroes the bands above the active degree; the port
    truncates the degree. Equal images, and the port's gradient of the
    bands above the degree is exactly 0."""
    rng = np.random.default_rng(6)
    jp = jg.create_from_pcd(scene["pts"], scene["cols"])
    jp = dataclasses.replace(jp, features_rest=jnp.asarray(rng.normal(scale=0.2, size=(300, 8, 3)), jnp.float32))
    masked = dataclasses.replace(jp, features_rest=jp.features_rest.at[:, 3:].set(0.0))
    cam = jindex(scene["jcams"], 1)
    jimg, _ = jax_render(masked, cam)
    tp = ttrain._leaves(_port(jp))
    timg, _ = tg.render(tp, index_camera(scene["tcams"], 1), bg=(0, 1, 0), sh_deg=1)
    np.testing.assert_allclose(timg.detach().numpy(), _np(jimg), rtol=0, atol=1e-5)
    cfg = ttrain.GSTrainConfig(**CFG)
    _, grads, _, _ = ttrain._grad_step(tp, index_camera(scene["tcams"], 1), scene["gt"][1], 1, cfg,
                                       ttrain.RasterConfig())
    assert not grads["features_rest"][:, 3:].any() and grads["features_rest"][:, :3].any()
    _, grads0, _, _ = ttrain._grad_step(tp, index_camera(scene["tcams"], 1), scene["gt"][1], 0, cfg,
                                        ttrain.RasterConfig())
    assert grads0["features_rest"].shape == (300, 8, 3) and not grads0["features_rest"].any()




@pytest.fixture(scope="module")
def jax_grad_step(scene):
    """The JAX package's training loss and its value_and_grad, as
    train_gaussians' grad_step computes them (gaustar_tpu/train/
    train_gaussians.py:112-134): the bands above sh_deg zeroed, L1 + DSSIM
    against the camera's GT, gradients of the params and of means2d_dummy."""
    cfg = ttrain.GSTrainConfig(**CFG)

    def loss_fn(p, dummy, cam_idx, sh_deg):
        deg_of = jnp.floor(jnp.sqrt(jnp.arange(1, p.features_rest.shape[1] + 1).astype(jnp.float32)))
        mask = (deg_of.astype(jnp.int32) <= sh_deg).astype(jnp.float32)[None, :, None]
        p2 = dataclasses.replace(p, features_rest=p.features_rest * mask)
        img, aux = jg.render(p2, jindex(scene["jcams"], cam_idx), bg=cfg.bg_color, raster_config=JRC,
                             means2d_dummy=dummy)
        gt = scene["jgt"][cam_idx]
        loss = (1.0 - cfg.lambda_dssim) * jlosses.l1_loss(img, gt) + cfg.lambda_dssim * (1.0 - jlosses.ssim(img, gt))
        return loss, aux.radii

    @jax.jit
    def step(p, cam_idx, sh_deg):
        dummy = jnp.zeros((p.xyz.shape[0], 2))
        return jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True)(p, dummy, cam_idx, sh_deg)

    return step


@pytest.mark.parametrize("sh_deg", [0, 1, 2], ids=["deg0", "deg1", "deg2"])
def test_grad_step_matches_jax_value_and_grad(scene, jax_grad_step, sh_deg):
    """One training step's loss, radii and gradients (each of the six groups
    and means2d) against the JAX package's on every camera, from seeded
    SH bands, opacities, scales and unnormalised rotations. The loss within
    2e-6 relative, the radii exact, every gradient element within 1e-4 of
    its group's largest |gradient| (float32 sums in another order: 4.1e-5
    at most, in the rotations; a missing or sign-flipped term is off by its
    whole size)."""
    fields = perturbed_gaussians({k: _np(getattr(jg.create_from_pcd(scene["pts"], scene["cols"]), k))
                                  for k in FIELDS}, seed=8)
    jp = jg.GaussianParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    tp = ttrain._leaves(bridge.gaussian_params_from_numpy(fields, "cpu"))
    cfg = ttrain.GSTrainConfig(**CFG)
    for c in range(4):
        (jloss, jradii), (jgrads, jdgrad) = jax_grad_step(jp, c, sh_deg)
        loss, grads, dgrad, radii = ttrain._grad_step(tp, index_camera(scene["tcams"], c), scene["gt"][c], sh_deg,
                                                      cfg, ttrain.RasterConfig())
        np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-6)
        np.testing.assert_array_equal(radii.numpy(), _np(jradii))
        for name, got, ref in [(k, grads[k].numpy(), _np(getattr(jgrads, k))) for k in FIELDS] + [
                ("means2d", dgrad.numpy(), _np(jdgrad))]:
            scale = np.abs(ref).max()
            if name == "features_rest" and sh_deg == 0:
                assert scale == 0 and not got.any()
                continue
            assert scale > 0, name
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale, err_msg=f"camera {c} {name}")
