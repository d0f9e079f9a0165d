"""Adaptive density control (counterpart of gaustar_tpu/train/densifier.py;
gaustar_scene/sugar_densifier.py:10-273 and the 3DGS densifier it derives
from).

Two uses, as in the reference:
  - GauSTAR's main path only detects: the screen-space gradient statistics
    and their threshold mask (update_stats, densify_detection);
  - vanilla 3DGS training clones, splits and prunes (densify_and_prune) and
    clamps opacities (reset_opacity).

The JAX package grows its arrays in capacity buckets with dead slots (opacity
logit -30) so that XLA retraces only at a bucket boundary. Eager PyTorch has
nothing to retrace, so every array here is sized exactly: every row is a
live gaussian. The JAX output's live rows are its first `info["n_active"]`
rows, equal to this module's output.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.models.gaussians import GaussianParams
from gaustar_tpu_torch.utils.general import inverse_sigmoid, l2norm, normalize, quaternion_to_matrix


@dataclasses.dataclass
class DensifierState:
    grad_accum: torch.Tensor  # [N] accumulated ||d mean2d_ndc||
    denom: torch.Tensor  # [N] observation counts
    max_radii2d: torch.Tensor  # [N]


def init_state(n: int, device="cuda") -> DensifierState:
    def z():
        return torch.zeros((n,), dtype=torch.float32, device=device)

    return DensifierState(grad_accum=z(), denom=z(), max_radii2d=z())


@torch.no_grad()
def update_stats(state: DensifierState, means2d_grad: torch.Tensor, radii: torch.Tensor) -> DensifierState:
    """Accumulate the screen-space gradient norms of the visible gaussians
    (sugar_densifier.py:156-164). `means2d_grad` is the NDC-space gradient
    the rasterizer's `means2d_dummy` receives."""
    vis = radii > 0
    g = l2norm(means2d_grad[:, :2], keepdim=False)
    zero = g.new_zeros(())
    return DensifierState(
        grad_accum=state.grad_accum + torch.where(vis, g, zero),
        denom=state.denom + vis.to(torch.float32),
        max_radii2d=torch.maximum(state.max_radii2d, torch.where(vis, radii.to(torch.float32), zero)),
    )


def average_grads(state: DensifierState) -> torch.Tensor:
    g = state.grad_accum / torch.clamp_min(state.denom, 1.0)
    return torch.where(state.denom > 0, g, g.new_zeros(()))


def densify_detection(state: DensifierState, max_grad: float):
    """(mask of gaussians whose average gradient reaches `max_grad`, the
    averages): GauSTAR's use for topology-change visualization
    (sugar_densifier.py:235-249)."""
    grads = average_grads(state)
    return grads >= max_grad, grads


@torch.no_grad()
def densify_and_prune(
    params: GaussianParams,
    state: DensifierState,
    max_grad: float = 0.0002,
    min_opacity: float = 0.005,
    extent: float = 1.0,
    max_screen_size: float | None = None,
    percent_dense: float = 0.01,
    n_split: int = 2,
    seed: int = 0,
):
    """Clone small high-gradient gaussians, split large ones into `n_split`
    samples of N(0, scaling) rotated to the world with their scales divided
    by 0.8 n_split, and prune the split originals, the transparent ones and
    (with `max_screen_size`) the huge ones (sugar_densifier.py:173-268).

    The masks and gathers run on the parameters' device. The split samples
    are drawn on the host from np.random.default_rng(seed), as the JAX
    package draws them, and copied up. Returns (params, a fresh state,
    info): rows ordered kept, clones, splits; info holds `keep_mask` [N]
    (numpy bool), `n_active` (the new count), `n_clone`, `n_split`, and
    `n_pruned` / `n_kept` (the rows pruned and surviving, which the JAX
    package's info leaves out)."""
    rng = np.random.default_rng(seed)
    arr = {k: v.detach() for k, v in params.named()}
    dev = arr["xyz"].device
    grads = average_grads(state)
    scaling = torch.exp(arr["scaling"])
    max_scale = scaling.max(dim=1).values

    hot = grads >= max_grad
    small = max_scale <= percent_dense * extent
    clone_mask = hot & small
    split_mask = hot & ~small

    clones = {k: v[clone_mask] for k, v in arr.items()}
    splits = {k: torch.repeat_interleave(v[split_mask], n_split, dim=0) for k, v in arr.items()}
    n_sel = int(split_mask.sum())
    if n_sel:
        stds = torch.repeat_interleave(scaling[split_mask], n_split, dim=0)
        draws = torch.as_tensor(rng.normal(size=tuple(stds.shape)).astype(np.float32), device=dev)
        samples = draws * stds
        rots = quaternion_to_matrix(normalize(splits["rotation"]))
        splits["xyz"] = (rots * samples[:, None, :]).sum(-1) + splits["xyz"]
        splits["scaling"] = torch.log(stds / (0.8 * n_split))

    prune = split_mask | (torch.sigmoid(arr["opacity"][:, 0]) < min_opacity)
    if max_screen_size:
        prune |= (state.max_radii2d > max_screen_size) | (max_scale > 0.1 * extent)

    keep_mask = ~prune
    merged = {k: torch.cat([v[keep_mask], clones[k], splits[k]]) for k, v in arr.items()}
    n_new = merged["xyz"].shape[0]
    info = {"keep_mask": keep_mask.cpu().numpy(), "n_active": n_new, "n_clone": int(clone_mask.sum()),
            "n_split": n_sel, "n_pruned": int(prune.sum()), "n_kept": int(keep_mask.sum())}
    return GaussianParams(**merged), init_state(n_new, dev), info


@torch.no_grad()
def reset_opacity(params: GaussianParams) -> GaussianParams:
    """Clamp every opacity to at most 0.01 (sugar_densifier.py:270-273)."""
    op = params.opacity.detach()
    new = inverse_sigmoid(torch.clamp_max(torch.sigmoid(op), 0.01))
    return dataclasses.replace(params, opacity=new)
