"""Scene composition: several SuGaR models in one rasterization pass
(counterpart of gaustar_tpu/models/compositor.py; sugar_compositor.py:12-244
with the per-model rigid transform of internal_use_tools/gstar_edit.py).

Each entry may carry a 4x4 world-to-world transform, a gaussian mask (masked
gaussians get opacity 0) and a colour scale.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.rasterizer import RasterConfig, rasterize


@dataclasses.dataclass
class CompositorEntry:
    params: sugar.SuGaRParams
    config: sugar.SuGaRConfig
    transform: torch.Tensor | None = None  # [4, 4] rigid transform (world -> world)
    mask: torch.Tensor | None = None  # [N] bool gaussian selection
    color_scale: float = 1.0


def _transformed_gaussians(entry: CompositorEntry, camera: Camera, sh_deg: int):
    """(positions [N, 3], cov6 [N, 6], opacities [N], colours [N, 3])."""
    positions = sugar.gaussian_centers(entry.params, entry.config)
    frames = sugar.gaussian_frames(entry.params, entry.config)  # [N, 3, 3], columns are the axes
    s = sugar.scaling(entry.params, entry.config)
    opac = sugar.strengths(entry.params)

    if entry.transform is not None:
        rot = entry.transform[:3, :3]
        positions = (positions[:, None, :] * rot[None]).sum(-1) + entry.transform[:3, 3]
        frames = (rot[None, :, :, None] * frames[:, None, :, :]).sum(-2)  # R @ U

    colors = sugar.points_rgb(entry.params, positions, camera.camera_center, sh_deg) * entry.color_scale
    # Sigma = U diag(s^2) U^T, packed (xx, xy, xz, yy, yz, zz).
    m = frames * (s**2)[:, None, :]
    cov = torch.stack([(m[:, d] * frames[:, e]).sum(-1) for d, e in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))],
                      dim=-1)
    if entry.mask is not None:
        opac = torch.where(entry.mask, opac, opac.new_zeros(()))
    return positions, cov, opac, colors


def render_composite(
    entries: Sequence[CompositorEntry],
    camera: Camera,
    bg=(0.0, 0.0, 0.0),
    sh_deg: int = 2,
    raster_config: RasterConfig = RasterConfig(),
):
    """Concatenate every entry's (selected, transformed) gaussians and
    rasterize once (render_image_gaussian_rasterizer,
    sugar_compositor.py:29-244). Returns (image [H, W, 3], RasterAux)."""
    parts = [_transformed_gaussians(e, camera, sh_deg) for e in entries]
    return rasterize(*(torch.cat([p[i] for p in parts]) for i in range(4)), camera, bg=bg, config=raster_config)
