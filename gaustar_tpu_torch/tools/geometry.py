"""Host-side mesh helpers of topology detection (numpy copy of part of
gaustar_tpu/tools/geometry.py).

Vectorized ports of gaustar_tools/warp_mesh.py:133-213: the reference's
per-vertex Python loops become padded-adjacency array ops with the same
results. Only what detection needs is here; the image helpers that need
OpenCV (get_depth_edge, pad_and_resize_flow) belong to the warp and are not
ported yet.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def mesh_vert_propagate(vert_adj, vert_adj_count, valid_mask, value, max_ite=20):
    """BFS average fill of invalid vertices from valid neighbors
    (warp_mesh.py:133-156), vectorized over the padded adjacency [V, D].
    Each round works on the rows still invalid and gathers the values of the
    rows it fills only: per row the same sums as over all rows, without the
    [V, D, C] temporaries."""
    value = value.copy()
    valid = valid_mask.copy()
    v = len(value)
    adj = np.minimum(vert_adj, v - 1)
    adj_exists = vert_adj < v
    for _ in range(max_ite):
        rows = np.flatnonzero(~valid)
        nb_valid = adj_exists[rows] & valid[adj[rows]]  # [R, D]
        cnt = nb_valid.sum(axis=1)
        hit = cnt > 0
        if not hit.any():
            break
        fill = rows[hit]
        nb_vals = value[adj[fill]]  # [n_fill, D, C]
        sums = (nb_vals * nb_valid[hit][..., None]).sum(axis=1)
        value[fill] = sums / cnt[hit, None]
        valid[fill] = True
    return value


def build_voxel_from_pc(pc_points, pc_values, voxel_size):
    """Voxel-downsample a point cloud, averaging values per cell — o3d
    VoxelGrid.create_from_point_cloud semantics (origin at min corner, value =
    mean of points in the voxel). Returns (centers [M,3], values [M,C])."""
    pts = np.asarray(pc_points, np.float64)
    origin = pts.min(axis=0)
    idx = np.floor((pts - origin) / voxel_size).astype(np.int64)
    dims = idx.max(axis=0) + 1
    lin = (idx[:, 0] * dims[1] + idx[:, 1]) * dims[2] + idx[:, 2]
    uniq, inv = np.unique(lin, return_inverse=True)
    m = len(uniq)
    vals = np.zeros((m, pc_values.shape[-1]))
    cnt = np.zeros(m)
    np.add.at(vals, inv, pc_values)
    np.add.at(cnt, inv, 1)
    vals /= cnt[:, None]
    ci = np.stack([uniq // (dims[1] * dims[2]), (uniq // dims[2]) % dims[1], uniq % dims[2]], axis=1)
    centers = origin + (ci + 0.5) * voxel_size
    return centers, vals


def interpolate_in_voxel(points, voxel_center, voxel_value, voxel_size, knn_k=8):
    """Gaussian-weighted KNN interpolation from voxel centers
    (warp_mesh.py:199-213), vectorized with a KD-tree."""
    k = min(knn_k, len(voxel_center))
    dist, idx = cKDTree(voxel_center).query(points, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    w = np.exp(-(dist**2) / (voxel_size**2)) + 1e-8
    vals = voxel_value[idx]  # [V, k, C]
    return (vals * w[..., None]).sum(axis=1) / w.sum(axis=1)[:, None]
