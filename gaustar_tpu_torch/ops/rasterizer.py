"""Public differentiable rasterizer (counterpart of gaustar_tpu/ops/rasterizer.py).

    preprocess (tensor ops, autograd)     forward.cu:156-256
      -> bin_gaussians (sorts)            rasterizer_impl.cu:270-318
      -> gather_pair_data                 [backward: per-gaussian segment sum]
      -> blend_raw (CUDA kernels on the GPU, plain versions on the CPU)
      -> assemble + background composite  forward.cu:367-373

impl="tiled" is the JAX package's impl="pallas" path; impl="dense" is the
oracle, for tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops import binning
from gaustar_tpu_torch.ops.blend_cuda import blend_raw
from gaustar_tpu_torch.ops.projection import TILE, preprocess
from gaustar_tpu_torch.ops.rasterizer_ref import rasterize_dense
from gaustar_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    impl: str = "tiled"  # 'tiled' | 'dense'
    channels: int = 3


class RasterAux(NamedTuple):
    final_T: torch.Tensor  # [H, W]
    n_contrib: torch.Tensor  # [H, W] int32
    radii: torch.Tensor  # [N] int32
    num_pairs: int
    num_active: Any  # [] int64 tensor: non-empty tiles


def assemble_image_cm(tiles_cm: torch.Tensor, grid_x: int, grid_y: int, width: int, height: int):
    """[T, C, 256] channel-major tile blocks -> [C, H, W] in one relayout."""
    c = tiles_cm.shape[1]
    img = tiles_cm.reshape(grid_y, grid_x, c, TILE, TILE)
    img = img.permute(2, 0, 3, 1, 4).reshape(c, grid_y * TILE, grid_x * TILE)
    return img[:, :height, :width]


@span("render.rasterize")
def rasterize(
    means3d,
    cov3d,
    opacities,
    colors,
    camera: Camera,
    bg: Any = (0.0, 0.0, 0.0),
    config: RasterConfig = RasterConfig(),
    means2d_dummy=None,
    layout: str = "hwc",
):
    """Render gaussian primitives; returns (image, RasterAux), the image
    [H, W, C] or, with layout="cm", channels-major [C, H, W].

    `means2d_dummy` (zeros [N, 2]) receives dL/d(NDC mean2d), the
    reference's screenspace_points trick (sugar_model.py:1266-1276)."""
    W, H = camera.width, camera.height
    with span("render.preprocess"):
        g = preprocess(means3d, cov3d, opacities, colors, camera)
    if means2d_dummy is not None:
        scale = torch.tensor([0.5 * W, 0.5 * H], dtype=torch.float32, device=means3d.device)
        g = g._replace(mean2d=g.mean2d + means2d_dummy * scale)
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)

    if config.impl == "dense":
        out = rasterize_dense(g, W, H)
        img = out.composite(bg_t)
        if layout == "cm":
            img = img.permute(2, 0, 1)
        zero = torch.zeros((), dtype=torch.int64, device=means3d.device)
        return img, RasterAux(out.final_T, out.n_contrib, out.radii, 0, zero)
    if config.impl != "tiled":
        raise ValueError(f"unknown rasterizer impl: {config.impl}")

    grid_x = (W + TILE - 1) // TILE
    grid_y = (H + TILE - 1) // TILE
    with span("render.binning"):
        binned = binning.bin_gaussians(g, grid_x, grid_y)
    with span("render.gather"):
        pair_data = binning.gather_pair_data(g, binned)
    raw = blend_raw(pair_data, binned.tile_start, binned.tile_count, grid_x, W, H, config.channels)
    maps = assemble_image_cm(raw, grid_x, grid_y, W, H)  # [8, H, W]
    if config.channels == 3:
        color_cm = maps[0:3]
    else:
        color_cm = torch.cat([maps[0:3], maps[6:7]], dim=0)
    final_t = maps[3]
    aux = RasterAux(
        final_T=final_t,
        n_contrib=maps[4].to(torch.int32),
        radii=g.radius,
        num_pairs=binned.num_pairs,
        num_active=(binned.tile_count > 0).sum(),
    )
    if layout == "cm":
        return color_cm + final_t[None] * bg_t[:, None, None], aux
    return color_cm.permute(1, 2, 0) + final_t[..., None] * bg_t, aux
