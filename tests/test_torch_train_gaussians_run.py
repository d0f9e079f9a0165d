"""train_gaussians in the port against the JAX package on
tests/test_densify.py:60's scene (test_torch_train_gaussians.make_scene):
the trajectory up to the first densify event, then the event itself. The
runs stop at iteration 20 so that the JAX package compiles its step for
one gaussian count only."""

import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import index_camera as jindex
from gaustar_tpu.models import gaussians as jg
from gaustar_tpu.ops.losses import psnr as jpsnr
from gaustar_tpu.train import train_gaussians as jtrain
from gaustar_tpu_torch.cameras import index_camera
from gaustar_tpu_torch.models import gaussians as tg
from gaustar_tpu_torch.ops.losses import psnr
from gaustar_tpu_torch.train import train_gaussians as ttrain
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_gs_lr_fn
from port_helpers import one_thread  # noqa: F401  (autouse)
from test_torch_train_gaussians import CFG, FIELDS, JRC, _np, _port, jax_render, make_scene

FIRST_DENSIFY = 19


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _train_both(scene, iterations):
    jp = jg.create_from_pcd(scene["pts"], scene["cols"])
    cfg = {**CFG, "iterations": iterations}
    jev, tev = [], []
    jout, jhist = jtrain.train_gaussians(jp, scene["jcams"], scene["jgt"], jtrain.GSTrainConfig(**cfg), JRC,
                                         spatial_lr_scale=1.0, log_fn=jev.append)
    tout, thist = ttrain.train_gaussians(_port(jp), scene["tcams"], scene["gt"], ttrain.GSTrainConfig(**cfg),
                                         spatial_lr_scale=1.0, log_fn=tev.append)
    return jp, (jout, jhist, jev), (tout, thist, tev)


def test_trajectory_up_to_the_first_densify_matches_jax(scene):
    """Iterations 1..18 (SH degree 0, then 1 from iteration 21 on: not
    reached). Adam with eps 1e-15 turns float noise in a near-zero gradient
    into a step of about lr, so single elements may differ by up to
    2 x sum(lr); the mean difference of each group stays within
    1e-2 x sum(lr) (at most 4.6e-4 x sum(lr), in the rotations), where the
    JAX package moved them a median 0.26-0.70 x sum(lr): a missing or
    sign-flipped gradient is off by about that."""
    iters = FIRST_DENSIFY - 1
    jp, (jout, _, jev), (tout, _, tev) = _train_both(scene, iters)
    assert jev == tev == []
    lr_fn = make_gs_lr_fn(OptimizationParams(iterations=iters), 1.0)
    lr_sum = {k: sum(lr_fn(c)[k] for c in range(iters)) for k in lr_fn(0)}
    for k in FIELDS:
        diff = np.abs(getattr(tout, k).detach().numpy() - _np(getattr(jout, k)))
        assert diff.max() <= 2 * lr_sum[k] * (1 + 1e-5), f"{k}: {diff.max()} > 2 * {lr_sum[k]}"
        assert diff.mean() <= 1e-2 * lr_sum[k], f"{k}: mean {diff.mean()} > 1e-2 * {lr_sum[k]}"
        moved = np.median(np.abs(_np(getattr(jout, k)) - _np(getattr(jp, k))))
        assert (moved > 0.2 * lr_sum[k]) == (k != "features_rest"), k


def test_first_densify_event_matches_jax_and_training_improves(scene):
    """20 iterations: the event at 19 has equal counts in both packages (and
    the port's survivors and pruned rows add up), the gaussian count follows it, and camera 0's PSNR improves in both."""
    jp, (jout, _, jev), (tout, _, tev) = _train_both(scene, FIRST_DENSIFY + 1)
    jd = [{k: (v if k == "event" else int(v)) for k, v in e.items()} for e in jev]
    assert [{k: e[k] for k in jd[0]} for e in tev] == jd and [e["iteration"] for e in tev] == [FIRST_DENSIFY]
    n = tev[0]["n_active"]
    assert tev[0]["n_kept"] == 300 - tev[0]["n_pruned"] and n == tev[0]["n_kept"] + tev[0]["n_clone"] + 2 * tev[0]["n_split"]
    assert tg.n_points(tout) == n and jg.n_points(jout) % CFG["bucket"] == 0
    assert np.isfinite(tout.xyz.detach().numpy()).all() and np.isfinite(_np(jout.xyz)[:n]).all()
    assert len(ttrain.last_train["step_ms"]) == FIRST_DENSIFY + 1 and len(ttrain.last_train["densify_ms"]) == 1

    jcam, tcam = jindex(scene["jcams"], 0), index_camera(scene["tcams"], 0)
    j0 = float(jpsnr(jax_render(jp, jcam)[0], scene["jgt"][0]))
    jN = float(jpsnr(jax_render(jout, jcam)[0], scene["jgt"][0]))
    with torch.no_grad():
        t0 = float(psnr(tg.render(_port(jp), tcam, bg=(0, 1, 0))[0], scene["gt"][0]))
        tN = float(psnr(tg.render(tout, tcam, bg=(0, 1, 0))[0], scene["gt"][0]))
    assert jN > j0 and tN > t0, (j0, jN, t0, tN)
    np.testing.assert_allclose(t0, j0, rtol=1e-5)
