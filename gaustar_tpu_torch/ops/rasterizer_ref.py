"""Dense reference rasterizer, the numerical oracle (counterpart of
gaustar_tpu/ops/rasterizer_ref.py).

Evaluates every (gaussian, pixel) pair, O(N * H * W), with renderCUDA's
blending semantics (forward.cu:261-374) in closed cumulative form, so that
plain autograd gives backward.cu's gradients. Test-only; never on the hot path.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustar_tpu_torch.ops.projection import TILE, Gaussians2D


class RenderOutput(NamedTuple):
    color: torch.Tensor  # [H, W, C] blended features WITHOUT background
    final_T: torch.Tensor  # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32, 1-based index of last contributor
    radii: torch.Tensor  # [N] int32

    def composite(self, bg) -> torch.Tensor:
        """image = color + T * bg (forward.cu:367-373)."""
        bg_t = torch.as_tensor(bg, dtype=torch.float32, device=self.color.device)
        return self.color + self.final_T[..., None] * bg_t


def clamp_alpha_ste(alpha: torch.Tensor) -> torch.Tensor:
    """min(0.99, alpha) with a straight-through gradient: backward.cu emits
    dL/dopacity = G * dL/dalpha and dL/dG = opacity * dL/dalpha even where the
    0.99 clamp is active. The value is exactly min(0.99, alpha) (the added
    term is x - x = 0), so the blend's discrete tests see the kernel's alpha."""
    return torch.minimum(alpha, alpha.new_full((), 0.99)).detach() + (alpha - alpha.detach())


def blend_prefix_ops(a0: torch.Tensor, contrib: torch.Tensor):
    """Closed-form blend over raw alphas a0 [M, P] (zero where not
    contributing) in front-to-back order: returns (a_eff, T_before, included)
    honoring the sticky 1e-4 early stop."""
    one_m = 1.0 - a0
    cp = torch.cumprod(one_m, dim=0)
    t_tilde = torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)
    flag = contrib & (t_tilde * one_m < 1e-4)
    stopped = torch.cumsum(flag.to(torch.int32), dim=0) > 0  # inclusive: stopper excluded
    included = contrib & ~stopped
    a_eff = torch.where(included, a0, torch.zeros_like(a0))
    cp2 = torch.cumprod(1.0 - a_eff, dim=0)
    t_before = torch.cat([torch.ones_like(cp2[:1]), cp2[:-1]], dim=0)
    return a_eff, t_before, included


def rasterize_dense(g: Gaussians2D, width: int, height: int) -> RenderOutput:
    """Blend preprocessed gaussians over the full image (oracle path)."""
    dev = g.mean2d.device
    order = torch.sort(g.depth.detach(), stable=True).indices
    xy = g.mean2d[order]
    conic = g.conic[order]
    opac = g.opacity[order]
    color = g.color[order]
    alive = (g.radius > 0)[order]
    rect_min = g.rect_min[order]
    rect_max = g.rect_max[order]

    px = torch.arange(width, dtype=torch.float32, device=dev)[None, :].repeat(height, 1).reshape(-1)
    py = torch.arange(height, dtype=torch.float32, device=dev)[:, None].repeat(1, width).reshape(-1)
    ptx = (px / TILE).to(torch.int32)
    pty = (py / TILE).to(torch.int32)

    dx = xy[:, 0:1] - px[None, :]
    dy = xy[:, 1:2] - py[None, :]
    power = -0.5 * (conic[:, 0:1] * dx * dx + conic[:, 2:3] * dy * dy) - conic[:, 1:2] * dx * dy
    alpha_raw = clamp_alpha_ste(opac[:, None] * torch.exp(power))

    in_rect = (
        (ptx[None, :] >= rect_min[:, 0:1])
        & (ptx[None, :] < rect_max[:, 0:1])
        & (pty[None, :] >= rect_min[:, 1:2])
        & (pty[None, :] < rect_max[:, 1:2])
    )
    contrib = (power <= 0.0) & (alpha_raw >= 1.0 / 255.0) & alive[:, None] & in_rect
    a0 = torch.where(contrib, alpha_raw, torch.zeros_like(alpha_raw))
    a_eff, t_before, included = blend_prefix_ops(a0, contrib)

    w = a_eff * t_before
    out_c = torch.einsum("np,nc->pc", w, color)
    final_t = torch.prod(1.0 - a_eff, dim=0)
    # CUDA's `contributor` counts the position in the TILE's pair list, which
    # is exactly {alive & in_rect} in depth order.
    in_pair_list = alive[:, None] & in_rect
    pos = torch.cumsum(in_pair_list.to(torch.int32), dim=0)
    n_contrib = torch.where(included, pos, torch.zeros_like(pos)).amax(dim=0)

    c = g.color.shape[-1]
    return RenderOutput(
        color=out_c.reshape(height, width, c),
        final_T=final_t.reshape(height, width),
        n_contrib=n_contrib.reshape(height, width).to(torch.int32),
        radii=g.radius,
    )
