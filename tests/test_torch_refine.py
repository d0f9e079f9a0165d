"""The port's refine step vs the JAX package on the same 48x48 synthetic frame
(subdiv-1 icosphere, 480 gaussians, 4 cameras): GT renders, step-1 losses
and gradients, and a 5-iteration refine_frame trajectory."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.train import refine as jrefine
from gaustar_tpu.utils import synthetic as jsynth
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.train import refine as trefine
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_lr_fn
from gaustar_tpu_torch.utils import synthetic as tsynth

ITERS = 5


def _np(x):
    return np.array(x)


@pytest.fixture(scope="module")
def frame():
    jp, jc, jd, _, rcfg = jsynth.synthetic_frame()
    # Start both packages off the mesh's rest state: there every face area
    # equals its reference, and the area-iso term |area - ref| sits on its
    # kink, where the gradient's sign is set by float noise (JAX's jitted
    # areas differ from the reference by ULPs, the port's do not).
    rng = np.random.default_rng(11)
    jp = dataclasses.replace(
        jp, points=jp.points + jnp.asarray(rng.normal(scale=2e-3, size=jp.points.shape), jnp.float32))
    params = {f.name: _np(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    config = dict(faces=_np(jc.faces), bary=_np(jc.bary), thickness=_np(jc.thickness),
                  n_gaussians_per_face=jc.n_gaussians_per_face, sh_levels=jc.sh_levels,
                  min_scale=jc.min_scale, max_scale=jc.max_scale, n_verts=len(params["points"]))
    cams = {k: _np(getattr(jd.cameras, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")}
    cams.update(width=jd.cameras.width, height=jd.cameras.height)
    data = {k: _np(getattr(jd, k)) for k in ("gt_images", "gt_depths", "margins", "ref_edge_len",
                                            "ref_area", "edges", "adj_faces")}
    data["cameras"] = cams
    port = (bridge.sugar_params_from_numpy(params, "cpu"), bridge.sugar_config_from_numpy(config, "cpu"),
            bridge.frame_data_from_numpy(data, "cpu"))
    pts = params["points"]
    lr_scale = 10.0 * float(np.linalg.norm(pts.max(0) - pts.min(0)) / 2.0) / np.sqrt(len(config["faces"]))
    return dict(jax=(jp, jc, jd, rcfg), port=port, lr_scale=lr_scale)


def _cfgs():
    kw = dict(num_iterations=ITERS, loose_bind_from=10**9)
    return jrefine.RefineConfig(**kw), trefine.RefineConfig(**kw)


def test_synthetic_frame_matches_jax(frame):
    _, _, jd, _ = frame["jax"]
    _, _, td, _, _ = tsynth.synthetic_frame(device="cpu")
    np.testing.assert_allclose(td.gt_images.numpy(), np.asarray(jd.gt_images), atol=3e-5)
    np.testing.assert_allclose(td.gt_depths.numpy(), np.asarray(jd.gt_depths), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(td.ref_edge_len.numpy(), np.asarray(jd.ref_edge_len), rtol=1e-6)
    np.testing.assert_array_equal(td.margins.numpy(), np.asarray(jd.margins))


@pytest.mark.parametrize("cams", [2, (0, 1, 2, 3)], ids=["one_camera", "camera_batch"])
def test_step_one_losses_and_gradients_match_jax(frame, cams):
    jp, jc, jd, rcfg = frame["jax"]
    tp, tc, td = frame["port"]
    jcfg, tcfg = _cfgs()

    @jax.jit
    def jloss(p):
        if isinstance(cams, tuple):
            return jrefine.compute_losses_multi(p, jc, jd, jnp.asarray(cams, jnp.int32), jnp.int32(1),
                                                jcfg, rcfg, 2)
        return jrefine.compute_losses(p, jc, jd, jnp.int32(cams), jnp.int32(1), jcfg, rcfg, 2)

    (jv, jd_), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    if isinstance(cams, tuple):
        tv, td_ = trefine.compute_losses_multi(tp, tc, td, list(cams), 1, tcfg, RasterConfig(), 2)
    else:
        tv, td_ = trefine.compute_losses(tp, tc, td, cams, 1, tcfg, RasterConfig(), 2)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    for k in ("rgb_loss", "depth_loss", "mask_loss", "nc_loss", "edge_loss", "area_loss", "opacity_reg"):
        np.testing.assert_allclose(float(td_[k].detach()), float(jd_[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    assert td_["num_pairs"] == int(jd_["num_pairs"])
    grads = torch.autograd.grad(tv, [p for _, p in tp.named()], allow_unused=True)
    for (name, p), g in zip(tp.named(), grads):
        ref = np.asarray(getattr(jg, name))
        got = np.zeros_like(ref) if g is None else g.numpy()
        # golden gradient tolerance (tests/test_golden.py)
        atol = max(2e-4, 1e-2 * float(np.abs(ref).max()))
        np.testing.assert_allclose(got, ref, rtol=2e-3, atol=atol, err_msg=name)


def test_refine_trajectory_matches_jax(frame):
    jp, jc, jd, rcfg = frame["jax"]
    tp, tc, td = frame["port"]
    jcfg, tcfg = _cfgs()
    scale = frame["lr_scale"]
    jout, _, jhist = jrefine.refine_frame(jp, jc, jd, jcfg, rcfg, spatial_lr_scale=scale, log_every=1)
    tout, _, thist = trefine.refine_frame(tp, tc, td, tcfg, spatial_lr_scale=scale, log_every=1)
    assert len(thist) == len(jhist) == ITERS
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-3)
    # Adam with eps 1e-15 moves a parameter by about lr per step in the sign of
    # its gradient's direction, even where the gradient is float noise, so two
    # correct trajectories may differ by up to 2 * sum(lr) per group.
    lr_fn = make_lr_fn(OptimizationParams(iterations=ITERS), scale)
    lr_sum = {k: sum(lr_fn(c)[k] for c in range(ITERS)) for k in lr_fn(0)}
    for name, p in tout.named():
        diff = np.abs(p.detach().numpy() - np.asarray(getattr(jout, name))).max()
        assert diff <= 2 * lr_sum[name] * (1 + 1e-5), f"{name}: {diff} > 2 * {lr_sum[name]}"
    # the caller's parameters are untouched
    np.testing.assert_array_equal(tp.points.detach().numpy(), np.asarray(jp.points))
