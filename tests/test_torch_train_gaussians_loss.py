"""train_gaussians' logged loss in the port against the JAX package: 100
iterations on tests/test_densify.py:60's scene (test_torch_train_gaussians.
make_scene), the SH degree raised at 21, 41 and 61, no densify event. The
JAX side renders with max_pairs 4096 and max_per_tile 512: 300 gaussians in
nine 16x16 tiles can neither overflow a tile's list nor the pair buffer."""

import numpy as np

from gaustar_tpu.models import gaussians as jg
from gaustar_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from gaustar_tpu.train import train_gaussians as jtrain
from gaustar_tpu_torch.train import train_gaussians as ttrain
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_gs_lr_fn
from port_helpers import one_thread  # noqa: F401  (autouse)
from test_torch_train_gaussians import CFG, FIELDS, _np, _port, make_scene

ITERS = 100
JRC = JRasterConfig(max_pairs=1 << 12, chunk=32, max_per_tile=512, impl="jax")


def test_logged_loss_after_100_iterations_matches_jax():
    """The loss logged at iteration 100 within 1e-4 relative of the JAX
    package's (1.8e-5 measured; the two runs' Adam steps differ only where
    eps 1e-15 amplifies float noise), and each parameter group's mean
    difference within 1e-2 x sum(lr) (3.1e-4 x sum(lr) at most measured, in
    the rotations)."""
    scene = make_scene()
    cfg = {**CFG, "iterations": ITERS, "densify_until_iter": 0}
    jp = jg.create_from_pcd(scene["pts"], scene["cols"])
    jlog, tlog = [], []
    jout, jhist = jtrain.train_gaussians(jp, scene["jcams"], scene["jgt"], jtrain.GSTrainConfig(**cfg), JRC,
                                         spatial_lr_scale=1.0, log_fn=jlog.append)
    tout, thist = ttrain.train_gaussians(_port(jp), scene["tcams"], scene["gt"], ttrain.GSTrainConfig(**cfg),
                                         spatial_lr_scale=1.0, log_fn=tlog.append)
    assert jlog == jhist and tlog == thist and [h["iteration"] for h in thist] == [ITERS]
    np.testing.assert_allclose(thist[0]["loss"], jhist[0]["loss"], rtol=1e-4)
    lr_fn = make_gs_lr_fn(OptimizationParams(iterations=ITERS), 1.0)
    for k in FIELDS:
        lr_sum = sum(lr_fn(c)[k] for c in range(ITERS))
        diff = np.abs(getattr(tout, k).detach().numpy() - _np(getattr(jout, k)))
        assert diff.mean() <= 1e-2 * lr_sum, f"{k}: mean {diff.mean()} > 1e-2 * {lr_sum}"
