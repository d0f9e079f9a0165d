"""Triangle-mesh depth and mask rendering (counterpart of
gaustar_tpu/tools/mesh_render.py).

Replaces the reference's aitviewer depth/mask preprocessing
(data_process/render_depth_from_mesh.py:13-101: HumanRF meshes rendered to
per-camera depth .npz and alpha .png, invalid depth 999) and the ActorsHQ
toolbox's OpenGL mesh rasterizer (mesh_tools/renderer/main.cpp).

Faces are binned to 16x16 tiles with buffers sized exactly, as
ops/binning.py sizes the gaussians' (one host read of the pair count): no
`max_pairs` or `max_per_tile` caps. Each (tile, face) pair tests its tile's
256 pixels with the JAX package's edge functions and perspective-correct
1/z interpolation, and the pairs' depths reduce into the image with a
scatter min. A min is order-independent, so the depths are the JAX
package's wherever its caps (2048 faces a tile, 2^20 pairs) do not drop
faces; beyond them the JAX package silently loses surface and the port does
not. Not differentiable (preprocessing path).
"""

from __future__ import annotations

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops.projection import TILE

INVALID_DEPTH = 999.0
# (tile, face) pairs evaluated at once: bounds the [pairs, 256] temporaries
# (about 40 bytes a pixel test) whatever the mesh.
PAIR_CHUNK = 1 << 16


def _bin_faces(tri2d: torch.Tensor, tri_z: torch.Tensor, grid_x: int, grid_y: int):
    """(face, tile) of every pair, faces in order and each face's tiles in
    row-major order of its rect, and the pair total."""
    dev = tri2d.device
    valid = (tri_z > 0.05).all(dim=1)
    grid = torch.tensor([grid_x, grid_y], device=dev)
    lo = torch.floor(tri2d.amin(dim=1) / TILE)
    hi = torch.floor(tri2d.amax(dim=1) / TILE) + 1
    # Clamped as floats first: the integer cast of an off-screen or invalid
    # face's coordinate is then defined.
    lo = torch.minimum(torch.clamp(lo, 0, None), grid).to(torch.int64)
    hi = torch.minimum(torch.clamp(hi, 0, None), grid).to(torch.int64)
    rw = hi[:, 0] - lo[:, 0]
    touched = torch.where(valid, rw * (hi[:, 1] - lo[:, 1]), 0)
    total = int(touched.sum())  # the one host sync of a render
    fi = torch.repeat_interleave(torch.arange(len(touched), device=dev), touched, output_size=total)
    k = torch.arange(total, device=dev) - (torch.cumsum(touched, 0) - touched)[fi]
    rw_f = rw[fi]
    dy = torch.div(k, rw_f, rounding_mode="floor")
    tile = (lo[fi, 1] + dy) * grid_x + (lo[fi, 0] + k - dy * rw_f)
    return fi, tile, total


def _pair_depths(tri: torch.Tensor, z: torch.Tensor, px: torch.Tensor, py: torch.Tensor) -> torch.Tensor:
    """Depth [P, 256] of each pair's face at its tile's pixels, INVALID_DEPTH
    outside the face (the JAX package's expressions)."""
    a, b, c = tri[:, 0], tri[:, 1], tri[:, 2]

    def edge(p0, p1):
        return (p1[:, None, 0] - p0[:, None, 0]) * (py - p0[:, None, 1]) - (
            p1[:, None, 1] - p0[:, None, 1]) * (px - p0[:, None, 0])

    w0 = edge(b, c)
    w1 = edge(c, a)
    w2 = edge(a, b)
    area = w0 + w1 + w2
    pos = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    neg = (w0 <= 0) & (w1 <= 0) & (w2 <= 0)
    nonzero = area.abs() > 1e-12
    inside = (pos | neg) & nonzero
    area_safe = torch.where(nonzero, area, torch.ones_like(area))
    b0 = w0 / area_safe
    b1 = w1 / area_safe
    b2 = w2 / area_safe
    # Perspective-correct depth: 1/z interpolated barycentrically in screen space.
    inv_z = b0 * (1.0 / z[:, 0:1]) + b1 * (1.0 / z[:, 1:2]) + b2 * (1.0 / z[:, 2:3])
    depth = 1.0 / torch.clamp_min(inv_z, 1e-9)
    return torch.where(inside, depth, torch.full_like(depth, INVALID_DEPTH))


def _focal(size: int, f: torch.Tensor) -> float:
    """size / (2 tan(fov / 2)) with tan(fov / 2) = size / (2 f), rounded to
    float32 at each step as the JAX package's numpy scalars are (a torch
    `scalar / tensor` multiplies by the reciprocal and can differ in the
    last bit)."""
    two = np.float32(2.0)
    return float(np.float32(size) / (two * (np.float32(size) / (two * np.float32(f.item())))))


@torch.no_grad()
def render_mesh_depth(verts, faces, camera: Camera):
    """Render a mesh's depth map [H, W] (INVALID_DEPTH where no surface),
    its alpha mask [H, W] (depth valid) and the (tile, face) pair total, on
    the camera's device. Returns (depth, mask) as numpy arrays, as the JAX
    package does, and the total as an int."""
    dev = camera.device
    v = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    f = torch.as_tensor(np.asarray(faces), dtype=torch.int64, device=dev)
    view = camera.view
    # view @ v term by term, in the order XLA's CPU dot sums it: the JAX
    # package's projected coordinates exactly.
    local = (v[:, 0:1] * view[:3, 0] + v[:, 1:2] * view[:3, 1] + v[:, 2:3] * view[:3, 2]) + view[:3, 3]
    z = local[:, 2]
    fx, fy = _focal(camera.width, camera.fx), _focal(camera.height, camera.fy)
    u = fx * local[:, 0] / z + camera.cx
    vpix = fy * local[:, 1] / z + camera.cy
    tri2d = torch.stack([u, vpix], dim=-1)[f]  # [F, 3, 2]
    tri_z = z[f]  # [F, 3]

    grid_x = (camera.width + TILE - 1) // TILE
    grid_y = (camera.height + TILE - 1) // TILE
    fi, tile, total = _bin_faces(tri2d, tri_z, grid_x, grid_y)
    row = grid_x * TILE
    flat = torch.arange(TILE * TILE, device=dev)
    img = torch.full((grid_y * TILE * row,), INVALID_DEPTH, dtype=torch.float32, device=dev)
    for p0 in range(0, total, PAIR_CHUNK):
        t = tile[p0:p0 + PAIR_CHUNK, None]
        pxi = (t % grid_x) * TILE + flat % TILE
        pyi = torch.div(t, grid_x, rounding_mode="floor") * TILE + torch.div(flat, TILE, rounding_mode="floor")
        fc = fi[p0:p0 + PAIR_CHUNK]
        depth = _pair_depths(tri2d[fc], tri_z[fc], pxi.to(torch.float32), pyi.to(torch.float32))
        img.scatter_reduce_(0, (pyi * row + pxi).reshape(-1), depth.reshape(-1), "amin")
    depth = img.reshape(grid_y * TILE, row)[: camera.height, : camera.width].cpu().numpy()
    return depth, depth < INVALID_DEPTH - 1.0, total
