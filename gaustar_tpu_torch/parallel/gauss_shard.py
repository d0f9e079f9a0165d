"""Gaussian-axis model parallelism for one render (counterpart of
gaustar_tpu/parallel/gauss_shard.py): a thin forward over gauss2d's strip
renderer. Rank d of D preprocesses gaussians [d N / D, (d + 1) N / D) of the
padded cloud, the pair keys and blend fields are gathered, and rank d blends
strip d of the tiles; the strips are gathered into the image.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops.projection import preprocess
from gaustar_tpu_torch.parallel import launch
from gaustar_tpu_torch.parallel.gauss2d import render_strip_sharded, shard_bounds


def make_gauss_mesh(device=None) -> launch.Mesh:
    """A mesh of every rank on the "gauss" axis."""
    return launch.make_mesh(gauss=dist.get_world_size() if dist.is_initialized() else 1, cam=1, device=device)


def pad_primitives(means3d, cov3d, opacities, colors, multiple: int):
    """Pad the gaussian axis to a multiple of `multiple` with zero-opacity
    gaussians at the origin, which preprocess's opacity cull removes."""
    pad = (-means3d.shape[0]) % multiple
    if pad == 0:
        return means3d, cov3d, opacities, colors

    def grow(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    return grow(means3d), grow(cov3d), grow(opacities.reshape(-1)), grow(colors)


def render_gauss_sharded(means3d, cov3d, opacities, colors, camera: Camera, mesh: launch.Mesh,
                         bg=(0.0, 0.0, 0.0)):
    """Render the whole cloud (every rank passes all of it) with its
    gaussians sharded over the mesh's gauss axis. Returns (image [H, W, C],
    pair count), equal on every rank and equal to ops.rasterizer.rasterize
    on one device (the same pair order, the same blend)."""
    d = mesh.gauss
    means3d, cov3d, opacities, colors = pad_primitives(means3d, cov3d, opacities, colors, d)
    rows = shard_bounds(means3d.shape[0], d, mesh.gauss_rank)
    g = preprocess(means3d[rows], cov3d[rows], opacities[rows], colors[rows], camera)
    img, final_t, num_pairs = render_strip_sharded(g, camera, mesh, colors.shape[1])
    bg_t = torch.as_tensor(bg, dtype=torch.float32, device=means3d.device)
    return img.permute(1, 2, 0) + final_t[..., None] * bg_t, num_pairs
