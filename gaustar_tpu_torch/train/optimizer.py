"""SuGaR optimizer: Adam (eps 1e-15) with named-group learning rates and the
exponential position schedule (counterpart of gaustar_tpu/train/optimizer.py;
sugar_optimizer.py:7-123).

Group lrs:
  points     position_lr_init * spatial_lr_scale, exp-decayed to
             position_lr_final * spatial_lr_scale over 30k steps
  sh_dc      feature_lr;  sh_rest  feature_lr / 20
  densities  opacity_lr;  scales   scaling_lr;  complex2d  rotation_lr
  delta_t    position_lr_init * spatial_lr_scale (not scheduled)
  delta_r    rotation_lr

Written as the port's own function on tensors, step for step what the JAX
package's optax.multi_transform of optax.adam does, and not torch.optim.Adam:
  - optax hands the schedule the count BEFORE it increments (step 1 uses
    schedule(0));
  - optax steps every group every step, zero gradients included, where
    torch.optim.Adam skips parameters whose .grad is None.
Parameters are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from gaustar_tpu_torch.models.sugar import SuGaRParams
from gaustar_tpu_torch.utils.general import get_expon_lr_func

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


def make_lr_fn(opt: OptimizationParams, spatial_lr_scale: float):
    """fn(count) -> {group: lr}, the per-group learning rates given the
    optimizer's step count before this step."""
    pos_schedule = get_expon_lr_func(
        lr_init=opt.position_lr_init * spatial_lr_scale,
        lr_final=opt.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt.position_lr_delay_mult,
        max_steps=opt.position_lr_max_steps,
    )

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


def adam_init(params: SuGaRParams) -> AdamState:
    return AdamState(
        count=0,
        mu={k: torch.zeros_like(v) for k, v in params.named()},
        nu={k: torch.zeros_like(v) for k, v in params.named()},
    )


@torch.no_grad()
def adam_step(params: SuGaRParams, grads: dict, state: AdamState, lr_fn) -> None:
    """One step of every group, as optax.adam(lr, 0.9, 0.999, eps=1e-15):
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
