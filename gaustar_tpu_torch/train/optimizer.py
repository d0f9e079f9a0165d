"""Adam (eps 1e-15) with named-group learning rates and the exponential
position schedule (counterpart of gaustar_tpu/train/optimizer.py;
sugar_optimizer.py:7-123), for SuGaRParams and for the vanilla 3DGS
GaussianParams (the groups of train_gaussians.make_optimizer).

SuGaR group lrs:
  points     position_lr_init * spatial_lr_scale, exp-decayed to
             position_lr_final * spatial_lr_scale over 30k steps
  sh_dc      feature_lr;  sh_rest  feature_lr / 20
  densities  opacity_lr;  scales   scaling_lr;  complex2d  rotation_lr
  delta_t    position_lr_init * spatial_lr_scale (not scheduled)
  delta_r    rotation_lr
Vanilla 3DGS group lrs (make_gs_lr_fn): xyz scheduled as points; features_dc
feature_lr; features_rest feature_lr / 20; scaling, rotation, opacity their lrs.

Written as the port's own function on tensors, step for step what the JAX
package's optax.multi_transform of optax.adam does, and not torch.optim.Adam:
  - optax hands the schedule the count BEFORE it increments (step 1 uses
    schedule(0));
  - optax steps every group every step, zero gradients included, where
    torch.optim.Adam skips parameters whose .grad is None.
Parameters are updated in place. One step count serves every group, as each
of optax's per-group counts advances on every step; a densify event's moment
surgery (surgery_opt_state) keeps it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.utils.general import get_expon_lr_func
from gaustar_tpu_torch.utils.profiling import span

B1 = 0.9
B2 = 0.999
EPS = 1e-15


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001


@dataclasses.dataclass
class AdamState:
    count: int
    mu: dict
    nu: dict


def spatial_lr_scale_from_cameras(camera_centers) -> float:
    """The 3DGS `spatial_lr_scale`: 1.1 x the largest distance of a camera
    from the rig's centroid (scene/dataset_readers.py getNerfppNorm).
    `camera_centers` is [C, 3], an array or a tensor."""
    centers = np.asarray(camera_centers.cpu() if torch.is_tensor(camera_centers) else camera_centers)
    avg = centers.mean(axis=0, keepdims=True)
    return float(1.1 * np.linalg.norm(centers - avg, axis=-1).max())


def _position_schedule(opt: OptimizationParams, spatial_lr_scale: float):
    return get_expon_lr_func(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )


def make_lr_fn(opt: OptimizationParams, spatial_lr_scale: float):
    """fn(count) -> {SuGaR group: lr}, the per-group learning rates given the
    optimizer's step count before this step."""
    pos_schedule = _position_schedule(opt, spatial_lr_scale)

    def fn(count: int) -> dict:
        return {
            "points": pos_schedule(count),
            "scales": opt.scaling_lr,
            "complex2d": opt.rotation_lr,
            "densities": opt.opacity_lr,
            "sh_dc": opt.feature_lr,
            "sh_rest": opt.feature_lr / 20.0,
            "delta_t": opt.position_lr_init * spatial_lr_scale,
            "delta_r": opt.rotation_lr,
        }

    return fn


def make_gs_lr_fn(opt: OptimizationParams, spatial_lr_scale: float):
    """fn(count) -> {GaussianParams group: lr}, the six groups of the JAX
    package's train_gaussians.make_optimizer."""
    pos_schedule = _position_schedule(opt, spatial_lr_scale)

    def fn(count: int) -> dict:
        return {
            "xyz": pos_schedule(count),
            "features_dc": opt.feature_lr,
            "features_rest": opt.feature_lr / 20.0,
            "scaling": opt.scaling_lr,
            "rotation": opt.rotation_lr,
            "opacity": opt.opacity_lr,
        }

    return fn


def adam_init(params) -> AdamState:
    """Zero moments for every named group of `params` (SuGaRParams or
    GaussianParams: anything with named() -> [(group, tensor)])."""
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.named()},
        nu={k: torch.zeros_like(v) for k, v in params.named()},
    )


@torch.no_grad()
@span("refine.adam")
def adam_step(params, grads: dict, state: AdamState, lr_fn) -> None:
    """One step of every named group, as optax.adam(lr, 0.9, 0.999, eps=1e-15):
    mu_hat / (sqrt(nu_hat) + eps), bias-corrected with the incremented count
    in float32, scaled by -lr(count before the increment)."""
    lrs = lr_fn(state.count)
    count = state.count + 1
    bc1 = 1.0 - torch.tensor(B1, dtype=torch.float32) ** count
    bc2 = 1.0 - torch.tensor(B2, dtype=torch.float32) ** count
    for name, p in params.named():
        g = grads[name]
        mu = state.mu[name].mul_(B1).add_((1.0 - B1) * g)
        nu = state.nu[name].mul_(B2).add_((1.0 - B2) * (g * g))
        direction = (mu / bc1.item()) / (torch.sqrt(nu / bc2.item()) + EPS)
        p.add_(direction * (-lrs[name]))
    state.count = count


def surgery_opt_state(state: AdamState, keep_mask, n_new: int) -> AdamState:
    """Adam moments across a densify event (sugar_densifier.py:48-128): in
    every group the rows where `keep_mask` [N_old] is true keep mu and nu,
    in order, and the n_new - kept new rows start at 0. The step count is
    kept, as optax keeps it."""
    def fix(m):
        keep = torch.as_tensor(np.asarray(keep_mask, bool), device=m.device)
        kept = m[keep]
        return torch.cat([kept, kept.new_zeros((n_new - kept.shape[0], *m.shape[1:]))])

    return AdamState(count=state.count, mu={k: fix(v) for k, v in state.mu.items()},
                     nu={k: fix(v) for k, v in state.nu.items()})


def adam(lr_fn):
    """adam_step as an update fn(params, grads, state), the form the sharded
    steps take (parallel/sharding.py, parallel/gauss2d.py)."""
    def update(params, grads: dict, state: AdamState) -> None:
        adam_step(params, grads, state, lr_fn)

    return update


def sgd(lr: float):
    """Plain gradient descent as an update fn(params, grads, state); the
    state is unused. With lr 1 a step's change is its gradient, which is how
    the sharded steps' gradients are read back."""
    @torch.no_grad()
    def update(params, grads: dict, state=None) -> None:
        for name, p in params.named():
            p.sub_(lr * grads[name])

    return update
