"""Depth-map fusion and point-cloud depth maps (counterpart of
gaustar_tpu/tools/depth_fusion.py).

internal_use_tools/fusion_depth.py (TSDF-fuse a dataset's GT depth maps into
a mesh) and pcl_to_depth_map.py (splat a point cloud to a camera's depth
map), composed from the port's TSDF volume (integration on the device,
extraction on the host) and tools/geometry's projection.
"""

from __future__ import annotations

import numpy as np
import torch

from gaustar_tpu_torch.mesh import surgery, tsdf
from gaustar_tpu_torch.tools.geometry import project
from gaustar_tpu_torch.utils.general import resolve_device


def fuse_gt_depths(
    depths: np.ndarray,  # [C, H, W], invalid > max_depth or 0
    cmr: dict,  # rgb_cameras.npz arrays
    voxel_size: float = 0.008,
    sdf_trunc: float = 0.02,
    depth_trunc: float = 6.0,
    max_depth: float = 10.0,
    rgbs: np.ndarray | None = None,  # [C, H, W, 3] optional
    max_dim: int = 512,
    device="cuda",
) -> surgery.Mesh:
    """TSDF-fuse ground-truth depth maps into a mesh (fusion_depth.py): the
    volume is fitted to 2,000 lifted samples of each view (seeded by the
    camera index), then every view integrates on `device`."""
    dev = resolve_device(device)
    intr = cmr["intrinsics"]
    extr = cmr["extrinsics"]
    n_cams, h, w = depths.shape

    pts = []
    for ci in range(n_cams):
        d = depths[ci]
        vv, uu = np.nonzero((d > 0) & (d < max_depth))
        if len(vv) == 0:
            continue
        sel = np.random.default_rng(ci).choice(len(vv), min(2000, len(vv)), replace=False)
        vv, uu = vv[sel], uu[sel]
        z = d[vv, uu]
        fx, fy = intr[ci][0, 0], intr[ci][1, 1]
        cx, cy = intr[ci][0, 2] or w / 2, intr[ci][1, 2] or h / 2
        local = np.stack([(uu - cx) / fx * z, (vv - cy) / fy * z, z], -1)
        pts.append((local - extr[ci][:3, 3]) @ extr[ci][:3, :3])
    vol = tsdf.fit_volume_to_points(np.concatenate(pts), voxel_size, sdf_trunc, pad=0.05, max_dim=max_dim,
                                    device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    for ci in range(n_cams):
        d = np.where((depths[ci] > 0) & (depths[ci] < max_depth), depths[ci], 0.0)
        rgb = rgbs[ci] if rgbs is not None else np.zeros((h, w, 3), np.float32)
        fx, fy = intr[ci][0, 0], intr[ci][1, 1]
        cx = intr[ci][0, 2] or w / 2
        cy = intr[ci][1, 2] or h / 2
        K = [[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]]
        vol = tsdf.integrate(vol, t(d), t(rgb), t(K), t(extr[ci]), depth_trunc=depth_trunc)

    verts, faces, colors = tsdf.extract_mesh(vol, with_color=rgbs is not None)
    fc = colors[faces].mean(axis=1) if len(faces) else np.zeros((0, 3))
    return surgery.Mesh(verts.astype(np.float64), faces.astype(np.int64), fc)


def points_to_depth_map(points: np.ndarray, intr, extr, shape, splat_radius: int = 1):
    """Z-buffer splat of a point cloud to a depth map [H, W] (pcl_to_depth_map.py),
    0 where empty. Host numpy."""
    h, w = shape
    pix, local = project(points, intr, extr, shape, return_local_points=True)
    z = local[:, 2]
    ok = z > 0
    rr = np.round(pix[ok, 0]).astype(int)
    cc = np.round(pix[ok, 1]).astype(int)
    zz = z[ok]
    depth = np.full((h, w), np.inf)
    for dr in range(-splat_radius + 1, splat_radius):
        for dc in range(-splat_radius + 1, splat_radius):
            r = np.clip(rr + dr, 0, h - 1)
            c = np.clip(cc + dc, 0, w - 1)
            np.minimum.at(depth, (r, c), zz)
    depth[~np.isfinite(depth)] = 0.0
    return depth
