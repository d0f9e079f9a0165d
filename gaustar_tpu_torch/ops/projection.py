"""Gaussian preprocessing: projection, EWA 2D covariance, conic, tile rect
(counterpart of gaustar_tpu/ops/projection.py; preprocessCUDA,
cuda_rasterizer/forward.cu:156-256).

Plain tensor code; autograd gives the hand-derived backward of backward.cu.
The reference's numeric peculiarities are kept: unnormalized quaternions in
cov3D, the 1.3*tanfov clamp, the +0.3 low-pass, the eigenvalue floor, the
near cull at z <= 0.2, ndc2Pix, 16x16 tiles, and the JAX package's exact
anisotropic tile rect and opacity cull (which decide the pair lists and so
`n_contrib`).

Clamps that gradients flow through use torch.minimum/maximum: like JAX's
clip they split the gradient at a tie, where torch.clamp would pass all of it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustar_tpu_torch.cameras import Camera

TILE = 16


class Gaussians2D(NamedTuple):
    """Screen-space Gaussians produced by `preprocess` (all [N, ...])."""

    mean2d: torch.Tensor  # [N, 2] pixel coords
    depth: torch.Tensor  # [N] view-space z
    conic: torch.Tensor  # [N, 3] inverse cov2d (A, B, C)
    opacity: torch.Tensor  # [N]
    color: torch.Tensor  # [N, C] features to blend
    radius: torch.Tensor  # [N] int32 pixel radius (0 => culled)
    rect_min: torch.Tensor  # [N, 2] int32 (tx0, ty0)
    rect_max: torch.Tensor  # [N, 2] int32 (tx1, ty1) exclusive
    tiles_touched: torch.Tensor  # [N] int32


def quat_scale_to_cov3d(scales: torch.Tensor, quats: torch.Tensor, scale_modifier: float = 1.0):
    """Sigma = (S R)^T (S R) with a w-first quaternion used UNNORMALIZED
    (forward.cu:118-152). Returns [N, 6] (xx, xy, xz, yy, yz, zz)."""
    r, x, y, z = quats[..., 0], quats[..., 1], quats[..., 2], quats[..., 3]
    R00 = 1.0 - 2.0 * (y * y + z * z)
    R01 = 2.0 * (x * y - r * z)
    R02 = 2.0 * (x * z + r * y)
    R10 = 2.0 * (x * y + r * z)
    R11 = 1.0 - 2.0 * (x * x + z * z)
    R12 = 2.0 * (y * z - r * x)
    R20 = 2.0 * (x * z - r * y)
    R21 = 2.0 * (y * z + r * x)
    R22 = 1.0 - 2.0 * (x * x + y * y)

    sx = scales[..., 0] * scale_modifier
    sy = scales[..., 1] * scale_modifier
    sz = scales[..., 2] * scale_modifier

    m0x, m0y, m0z = sx * R00, sx * R01, sx * R02
    m1x, m1y, m1z = sy * R10, sy * R11, sy * R12
    m2x, m2y, m2z = sz * R20, sz * R21, sz * R22

    c_xx = m0x * m0x + m1x * m1x + m2x * m2x
    c_xy = m0x * m0y + m1x * m1y + m2x * m2y
    c_xz = m0x * m0z + m1x * m1z + m2x * m2z
    c_yy = m0y * m0y + m1y * m1y + m2y * m2y
    c_yz = m0y * m0z + m1y * m1z + m2y * m2z
    c_zz = m0z * m0z + m1z * m1z + m2z * m2z
    return torch.stack([c_xx, c_xy, c_xz, c_yy, c_yz, c_zz], dim=-1)


def ewa_cov2d(means3d, cov3d, view, focal_x, focal_y, tanfovx, tanfovy):
    """EWA projection of the 3D covariance (forward.cu:74-113). Returns [N, 3]
    (cov_xx, cov_xy, cov_yy) including the +0.3 low-pass."""
    Rv = view[:3, :3]
    tv = view[:3, 3]
    t = means3d @ Rv.T + tv

    limx = 1.3 * tanfovx
    limy = 1.3 * tanfovy
    tz = t[:, 2]
    txtz = t[:, 0] / tz
    tytz = t[:, 1] / tz
    tx = torch.minimum(torch.maximum(txtz, -limx), limx) * tz
    ty = torch.minimum(torch.maximum(tytz, -limy), limy) * tz

    j00 = focal_x / tz
    j02 = -(focal_x * tx) / (tz * tz)
    j11 = focal_y / tz
    j12 = -(focal_y * ty) / (tz * tz)

    u0 = j00[:, None] * Rv[0][None, :] + j02[:, None] * Rv[2][None, :]
    u1 = j11[:, None] * Rv[1][None, :] + j12[:, None] * Rv[2][None, :]

    c_xx, c_xy, c_xz, c_yy, c_yz, c_zz = (cov3d[:, i] for i in range(6))

    def sig_mul(v):
        return torch.stack(
            [
                c_xx * v[:, 0] + c_xy * v[:, 1] + c_xz * v[:, 2],
                c_xy * v[:, 0] + c_yy * v[:, 1] + c_yz * v[:, 2],
                c_xz * v[:, 0] + c_yz * v[:, 1] + c_zz * v[:, 2],
            ],
            dim=-1,
        )

    s_u0 = sig_mul(u0)
    s_u1 = sig_mul(u1)
    cov_xx = (u0 * s_u0).sum(-1) + 0.3
    cov_xy = (u0 * s_u1).sum(-1)
    cov_yy = (u1 * s_u1).sum(-1) + 0.3
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def ndc2pix(v, size):
    return ((v + 1.0) * size - 1.0) * 0.5


def preprocess(means3d, cov3d, opacities, colors, camera: Camera) -> Gaussians2D:
    """Project gaussians to screen space (preprocessCUDA, forward.cu:156-256).
    `colors` are the per-gaussian blend features."""
    view = camera.view
    full_proj = camera.full_proj
    W, H = camera.width, camera.height
    focal_x = W / (2.0 * camera.tanfovx)
    focal_y = H / (2.0 * camera.tanfovy)

    p_view = means3d @ view[:3, :3].T + view[:3, 3]
    depth = p_view[:, 2]
    in_front = depth > 0.2

    p_hom = means3d @ full_proj[:3, :3].T + full_proj[:3, 3]
    p_w_h = means3d @ full_proj[3, :3] + full_proj[3, 3]
    p_w = 1.0 / (p_w_h + 1e-7)
    ndc_xy = p_hom[:, :2] * p_w[:, None]
    mean2d = torch.stack([ndc2pix(ndc_xy[:, 0], W), ndc2pix(ndc_xy[:, 1], H)], dim=-1)

    cov2d = ewa_cov2d(means3d, cov3d, view, focal_x, focal_y, camera.tanfovx, camera.tanfovy)
    det = cov2d[:, 0] * cov2d[:, 2] - cov2d[:, 1] * cov2d[:, 1]
    det_ok = det != 0.0
    # NaN guard exactly as the JAX package: the untaken branch must not be
    # 1/0, or its 0 * inf cotangent poisons autograd.
    det_inv = 1.0 / torch.where(det_ok, det, torch.ones_like(det))
    conic = torch.stack(
        [cov2d[:, 2] * det_inv, -cov2d[:, 1] * det_inv, cov2d[:, 0] * det_inv], dim=-1
    )
    op_flat = opacities.reshape(-1)

    # Everything below is discrete (radius, tile rect, cull): no gradient.
    with torch.no_grad():
        c2 = cov2d.detach()
        dt = det.detach()
        m2 = mean2d.detach()
        mid = 0.5 * (c2[:, 0] + c2[:, 2])
        lam_max = mid + torch.sqrt(torch.clamp_min(mid * mid - dt, 0.1))
        radius_f = torch.ceil(3.0 * torch.sqrt(torch.clamp_min(lam_max, 0.0)))

        # Exact per-axis support shrink (gaustar_tpu/ops/projection.py:182-225):
        # |dx| beyond sqrt(2 ln(255 op) cov_xx) can never reach alpha >= 1/255.
        two_l = 2.0 * torch.log(torch.clamp_min(op_flat.detach(), 1.0 / 255.0) * 255.0)
        hx = torch.ceil(torch.sqrt(torch.clamp_min(two_l * c2[:, 0], 0.0)))
        hy = torch.ceil(torch.sqrt(torch.clamp_min(two_l * c2[:, 2], 0.0)))
        rx_f = torch.minimum(radius_f, hx)
        ry_f = torch.minimum(radius_f, hy)

        grid_x = (W + TILE - 1) // TILE
        grid_y = (H + TILE - 1) // TILE
        # int casts truncate toward zero, as CUDA's getRect does.
        rx0 = torch.clamp(((m2[:, 0] - rx_f) / TILE).to(torch.int32), 0, grid_x)
        ry0 = torch.clamp(((m2[:, 1] - ry_f) / TILE).to(torch.int32), 0, grid_y)
        rx1_cuda = ((m2[:, 0] + radius_f + TILE - 1) / TILE).to(torch.int32)
        ry1_cuda = ((m2[:, 1] + radius_f + TILE - 1) / TILE).to(torch.int32)
        rx1 = torch.clamp(
            torch.minimum(rx1_cuda, ((m2[:, 0] + rx_f + TILE) / TILE).to(torch.int32)), 0, grid_x
        )
        ry1 = torch.clamp(
            torch.minimum(ry1_cuda, ((m2[:, 1] + ry_f + TILE) / TILE).to(torch.int32)), 0, grid_y
        )

        touched = (rx1 - rx0) * (ry1 - ry0)
        # Opacity cull: alpha <= opacity < 1/255 never contributes (exact).
        alive = in_front & det_ok & (touched > 0) & (op_flat.detach() >= 1.0 / 255.0)
        radius = torch.where(alive, radius_f, torch.zeros_like(radius_f)).to(torch.int32)
        touched = torch.where(alive, touched, torch.zeros_like(touched))

    return Gaussians2D(
        mean2d=mean2d,
        depth=depth,
        conic=conic,
        opacity=op_flat,
        color=colors,
        radius=radius,
        rect_min=torch.stack([rx0, ry0], dim=-1),
        rect_max=torch.stack([rx1, ry1], dim=-1),
        tiles_touched=touched,
    )
