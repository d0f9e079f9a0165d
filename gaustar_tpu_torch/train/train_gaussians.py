"""Vanilla 3DGS training (counterpart of gaustar_tpu/train/train_gaussians.py;
gaussian_splatting/train.py).

One camera per iteration in a seeded random order, loss 0.8 L1 + 0.2 DSSIM,
the SH degree raised every `sh_warmup_every` iterations, adaptive density
control (clone / split / prune on the screen-space gradient statistics) with
the Adam moments carried across each event (survivors keep theirs, new
gaussians start at 0; sugar_densifier.py:48-128), and an opacity reset every
`opacity_reset_interval` iterations.

The SH warmup truncates the degree of the render; the JAX package zeroes the
bands above it instead, which gives the same image and zero gradients there.
The bands not rendered reach Adam as zero gradients, so their moments decay
as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, index_camera
from gaustar_tpu_torch.models import gaussians
from gaustar_tpu_torch.models.gaussians import GaussianParams
from gaustar_tpu_torch.ops import losses
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.train import densifier
from gaustar_tpu_torch.train.optimizer import (
    OptimizationParams,
    adam_init,
    adam_step,
    make_gs_lr_fn,
    surgery_opt_state,
)
from gaustar_tpu_torch.utils.general import StepClock, device_ms

#: The last train_gaussians call: "step_ms" (each iteration's render, loss,
#: backward and Adam step; CUDA events on a card) and "densify_ms" (each
#: densify event with its moment surgery).
last_train: dict = {}


@dataclasses.dataclass(frozen=True)
class GSTrainConfig:
    """Hyperparameters of gaussian_splatting/train.py. `bucket` sizes the JAX
    package's dead-slot padding (densifier.py there); it changes nothing
    live, and the port, which sizes arrays exactly, does not read it."""

    iterations: int = 7000
    sh_degree: int = 2
    sh_warmup_every: int = 1000
    lambda_dssim: float = 0.2
    bg_color: tuple = (0.0, 0.0, 0.0)
    densify_from_iter: int = 500
    densify_until_iter: int = 7000
    densification_interval: int = 200
    densify_grad_threshold: float = 0.0002
    prune_opacity_threshold: float = 0.005
    densify_screen_size_threshold: float = 20.0
    percent_dense: float = 0.01
    opacity_reset_interval: int = 3000
    bucket: int = 4096


def _leaves(p: GaussianParams) -> GaussianParams:
    return GaussianParams(**{k: v.detach().clone().requires_grad_() for k, v in p.named()})


def _grad_step(params: GaussianParams, camera: Camera, gt, sh_deg: int, cfg: GSTrainConfig,
               raster_cfg: RasterConfig):
    """(loss, {group: grad}, means2d grad, radii) of one iteration."""
    dummy = torch.zeros((params.xyz.shape[0], 2), dtype=torch.float32, device=params.xyz.device,
                        requires_grad=True)
    img, aux = gaussians.render(params, camera, bg=cfg.bg_color, sh_deg=sh_deg, raster_config=raster_cfg,
                                means2d_dummy=dummy)
    loss = (1.0 - cfg.lambda_dssim) * losses.l1_loss(img, gt) + cfg.lambda_dssim * (1.0 - losses.ssim(img, gt))
    named = params.named()
    out = torch.autograd.grad(loss, [p for _, p in named] + [dummy], allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(named, out)}
    return loss.detach(), grads, out[-1], aux.radii


def train_gaussians(
    params: GaussianParams,
    cameras: Camera,  # batched
    gt_images,  # [C, H, W, 3] tensor on the cameras' device
    cfg: GSTrainConfig = GSTrainConfig(),
    raster_cfg: RasterConfig = RasterConfig(),
    opt_params: OptimizationParams | None = None,
    spatial_lr_scale: float = 1.0,
    seed: int = 0,
    log_fn: Callable | None = None,
):
    """Full 3DGS optimization on the parameters' device. Returns (params,
    history): history holds {"iteration", "loss"} every 100 iterations, and
    `log_fn` gets those and each densify event's {"iteration", "event":
    "densify", "n_active", "n_clone", "n_split"} as the JAX package's, with
    the port's "n_pruned" and "n_kept" besides."""
    opt_params = opt_params or OptimizationParams(iterations=cfg.iterations)
    lr_fn = make_gs_lr_fn(opt_params, spatial_lr_scale)
    params = _leaves(params)
    dev = params.xyz.device
    opt_state = adam_init(params)
    dstate = densifier.init_state(gaussians.n_points(params), dev)

    n_cams = gt_images.shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_cams)
    cursor = 0
    history = []
    extent = spatial_lr_scale
    clock = StepClock(dev)
    densify_ms = []

    for it in range(1, cfg.iterations + 1):
        if cursor >= n_cams:
            order = rng.permutation(n_cams)
            cursor = 0
        cam_idx = int(order[cursor])
        cursor += 1
        sh_deg = min((it - 1) // cfg.sh_warmup_every, cfg.sh_degree)

        clock.mark()
        loss, grads, dgrad, radii = _grad_step(params, index_camera(cameras, cam_idx), gt_images[cam_idx], sh_deg,
                                               cfg, raster_cfg)
        dstate = densifier.update_stats(dstate, dgrad, radii)
        adam_step(params, grads, opt_state, lr_fn)
        clock.mark()

        if cfg.densify_from_iter < it < cfg.densify_until_iter and (it + 1) % cfg.densification_interval == 0:
            def densify():
                new, state, info = densifier.densify_and_prune(
                    params, dstate,
                    max_grad=cfg.densify_grad_threshold,
                    min_opacity=cfg.prune_opacity_threshold,
                    extent=extent,
                    max_screen_size=cfg.densify_screen_size_threshold if it > cfg.opacity_reset_interval else None,
                    percent_dense=cfg.percent_dense,
                    seed=seed + it,
                )
                return _leaves(new), state, info, surgery_opt_state(opt_state, info["keep_mask"], info["n_active"])

            (params, dstate, info, opt_state), ms = device_ms(dev, densify)
            densify_ms.append(ms)
            if log_fn:
                log_fn({"iteration": it, "event": "densify", **{k: v for k, v in info.items() if k != "keep_mask"}})

        if it % cfg.opacity_reset_interval == 0:
            params = _leaves(densifier.reset_opacity(params))

        if it % 100 == 0:
            history.append({"iteration": it, "loss": float(loss)})
            if log_fn:
                log_fn(history[-1])

    last_train.clear()
    last_train.update(step_ms=clock.intervals_ms(), densify_ms=densify_ms)
    return params, history
