"""Small image helpers of the detection and fusion pipelines (counterpart of
gaustar_tpu/ops/image.py).

Tensor versions of the host geometry helpers (tools/geometry.py), so that
full-resolution frames stay on the device: the reference pulls every
rendered frame to the CPU for this processing (refined_mesh.py:742-813,
420-431); here only [V]- or volume-sized results leave the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def box_blur(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box mean with reflect-101 borders (cv2.blur's BORDER_DEFAULT),
    as shifted-slice sums in the JAX package's order."""
    p = k // 2
    xp = F.pad(x[None, None], (p, p, p, p), mode="reflect")[0, 0]
    h, w = x.shape
    acc = xp[0:h, :]
    for i in range(1, k):
        acc = acc + xp[i : i + h, :]
    acc2 = acc[:, 0:w]
    for j in range(1, k):
        acc2 = acc2 + acc[:, j : j + w]
    return acc2 / float(k * k)


def depth_edge(depth: torch.Tensor, ker: int) -> torch.Tensor:
    """Depth-edge map = local variance by box filters (geometry.get_depth_edge,
    warp_mesh.py:120-130), with its data-dependent foreground clamp: the
    largest depth below 10 (10 if there is none), x1.1."""
    fg = torch.where(depth < 10.0, depth, torch.full_like(depth, -torch.inf))
    mx = fg.max()
    max_depth = torch.where(torch.isfinite(mx), mx, mx.new_tensor(10.0)) * 1.1
    d = torch.minimum(depth, max_depth).to(torch.float32)
    return torch.clamp_min(box_blur(d * d, ker) - box_blur(d, ker) ** 2, 0.0)


def query_nearest(image: torch.Tensor, rc: torch.Tensor):
    """Nearest-pixel lookup at float (row, col): trunc(rc + 0.5), like
    geometry.query_at_image. Returns (values, inside-mask)."""
    rounded = torch.trunc(rc + 0.5).to(torch.int64)
    bound = torch.tensor(image.shape[:2], dtype=torch.int64, device=image.device) - 1
    safe = torch.minimum(torch.clamp_min(rounded, 0), bound)
    vals = image[safe[:, 0], safe[:, 1]]
    inside = (rounded >= 0).all(dim=-1) & (rounded <= bound).all(dim=-1)
    return vals, inside


def query_bilinear(image: torch.Tensor, rc: torch.Tensor):
    """Bilinear lookup at float (row, col) (geometry.query_at_image_bilinear).
    Returns (values, inside-mask)."""
    bound = torch.tensor(image.shape[:2], dtype=torch.float32, device=image.device) - 1.0
    pc = torch.minimum(torch.clamp_min(rc, 0.0), bound)
    r0 = torch.floor(pc[:, 0]).to(torch.int64)
    c0 = torch.floor(pc[:, 1]).to(torch.int64)
    r1 = torch.clamp_max(r0 + 1, image.shape[0] - 1)
    c1 = torch.clamp_max(c0 + 1, image.shape[1] - 1)
    fr = pc[:, 0] - r0
    fc = pc[:, 1] - c0
    vals = (
        image[r0, c0] * (1 - fr) * (1 - fc)
        + image[r0, c1] * (1 - fr) * fc
        + image[r1, c0] * fr * (1 - fc)
        + image[r1, c1] * fr * fc
    )
    inside = (rc >= 0).all(dim=-1) & (rc <= bound).all(dim=-1)
    return vals, inside
