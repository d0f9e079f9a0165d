"""Host-side projection, image and mesh helpers of detection and the warp
(numpy copy of gaustar_tpu/tools/geometry.py, without OpenCV).

Numerical ports of gaustar_tools/warp_mesh.py:57-213, vectorized: the
reference's per-vertex Python loops (mesh_vert_propagate,
interpolate_in_voxel, remove_outlier) become padded-adjacency array ops with
the same results. The JAX package's two OpenCV calls are replaced:
`get_depth_edge`'s cv2.blur by a reflect-101 box mean summed in float64 as
OpenCV sums float images, and `pad_and_resize_flow`'s cv2.resize
(INTER_NEAREST) by OpenCV's index rule. `resize_linear` is RAFT's
cv2.resize (INTER_LINEAR, tools/raft.py), OpenCV's fixed-point rule on uint8.

Conventions (reference): pixels are (row, col); `intr` is a 3x3 K with principal
point at the image center (images are pre-shifted, cmr_convert.py:26); `extr` is
world-to-camera ([R|t], local = R @ p + t).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def points_to_local_points(points: np.ndarray, extr: np.ndarray) -> np.ndarray:
    return points @ extr[:3, :3].T + extr[:3, 3]


def _rc_focal_center(intr, shape):
    """(focal, center) arranged in (row, col) order for a center-principal-point
    K (images are pre-shifted so cx,cy sit at the center, cmr_convert.py:26)."""
    focal = np.array([intr[1, 1], intr[0, 0]], dtype=np.float64)  # (fy, fx)
    center = 0.5 * np.array([shape[0], shape[1]], dtype=np.float64)
    return focal, center


def project(points: np.ndarray, intr, extr, shape, return_local_points=False):
    """3D world points -> (row, col) pixels (semantics of warp_mesh.py:57-76)."""
    lead = points.shape[:-1]
    cam = points_to_local_points(points.reshape(-1, 3), extr)
    focal, center = _rc_focal_center(intr, shape)
    # perspective divide, then swap xy -> (y/z, x/z) so output is (row, col)
    rc = cam[:, [1, 0]] / cam[:, 2:3] * focal + center
    if return_local_points:
        return rc.reshape(*lead, 2), cam.reshape(*lead, 3)
    return rc.reshape(*lead, 2)


def pixel_to_local_rays(pixels, intr, shape):
    """(row, col) pixels -> camera-space ray directions at z=1."""
    focal, center = _rc_focal_center(intr, shape)
    rc = (np.asarray(pixels) - center) / focal
    return np.stack([rc[..., 1], rc[..., 0], np.ones_like(rc[..., 0])], axis=-1)


def pixels_to_points(pixels, depth, intr, extr, shape):
    """Lift (row, col) pixels with depth to world points (warp_mesh.py:86-94)."""
    cam = pixel_to_local_rays(pixels, intr, shape) * np.asarray(depth)[..., None]
    # invert local = R p + t  ->  p = (local - t) R  (row-vector form of R^T x)
    return (cam - extr[:3, 3]) @ extr[:3, :3]


def query_at_image(image, pix, return_valid=False):
    """Nearest-pixel lookup with edge clamping (warp_mesh.py:106-118).

    Rounding is trunc(pix + 0.5): round-half-up for in-bounds coordinates,
    matching the reference's int cast for its (rare) small-negative inputs."""
    rounded = np.trunc(np.asarray(pix) + 0.5).astype(np.int64)
    bound = np.asarray(image.shape[:2]) - 1
    safe = np.clip(rounded, 0, bound)
    vals = image[safe[:, 0], safe[:, 1]]
    if return_valid:
        inside = (rounded >= 0).all(axis=-1) & (rounded <= bound).all(axis=-1)
        return vals, inside
    return vals


def query_at_image_bilinear(image, pix, return_valid=False):
    """Bilinearly interpolated lookup at float (row, col) coordinates: removes
    the first-order error of nearest-pixel sampling on sloped depth."""
    p = np.asarray(pix, np.float64)
    bound = np.asarray(image.shape[:2], np.float64) - 1
    pc = np.clip(p, 0, bound)
    r0 = np.floor(pc[:, 0]).astype(np.int64)
    c0 = np.floor(pc[:, 1]).astype(np.int64)
    r1 = np.minimum(r0 + 1, image.shape[0] - 1)
    c1 = np.minimum(c0 + 1, image.shape[1] - 1)
    fr = pc[:, 0] - r0
    fc = pc[:, 1] - c0
    vals = (
        image[r0, c0] * (1 - fr) * (1 - fc)
        + image[r0, c1] * (1 - fr) * fc
        + image[r1, c0] * fr * (1 - fc)
        + image[r1, c1] * fr * fc
    )
    if return_valid:
        inside = (p >= 0).all(axis=-1) & (p <= bound).all(axis=-1)
        return vals, inside
    return vals


def box_mean(x: np.ndarray, k: int) -> np.ndarray:
    """k x k box mean of a float32 image with reflect-101 borders, as
    cv2.blur computes it: the window sums in float64, times 1 / k^2, rounded
    to float32 (OpenCV slides its sums; here they are separable shifted-slice
    sums, which can differ in the last float64 bit)."""
    p = k // 2
    xp = np.pad(np.asarray(x, np.float64), p, mode="reflect")  # numpy's "reflect" is reflect-101
    h, w = x.shape
    rows = xp[0:h]
    for i in range(1, k):
        rows = rows + xp[i:i + h]
    acc = rows[:, 0:w]
    for j in range(1, k):
        acc = acc + rows[:, j:j + w]
    return (acc * (1.0 / (k * k))).astype(np.float32)


def get_depth_edge(depth, ker_size=9, max_depth=None):
    """Depth-edge map = local variance via box filters (warp_mesh.py:120-130)."""
    if max_depth is None:
        fg = depth[depth < 10]
        max_depth = (fg.max() if fg.size else 10.0) * 1.1
    d = np.minimum(depth, max_depth).astype(np.float32)
    return np.maximum(box_mean(d * d, ker_size) - box_mean(d, ker_size) ** 2, 0)


def resize_nearest(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=INTER_NEAREST): output
    index i reads src[min(floor(i * s), n - 1)], s = 1 / (dst_n / src_n) in
    float64, as OpenCV's resizeNN computes it."""
    in_h, in_w = img.shape[:2]
    ys = np.minimum(np.floor(np.arange(height) * (1.0 / (height / in_h))).astype(np.int64), in_h - 1)
    xs = np.minimum(np.floor(np.arange(width) * (1.0 / (width / in_w))).astype(np.int64), in_w - 1)
    return img[ys[:, None], xs[None, :]]


def _linear_taps(src: int, dst: int, edge_weight: bool):
    """OpenCV's INTER_LINEAR taps along one axis: the first source index of
    each output, its neighbour (both clamped into the source), and the
    float32 weight of the neighbour. Half-pixel centres, f = (i + 0.5) s -
    0.5 with s = 1 / (dst / src) in float64 rounded to float32. Outside the
    source, the horizontal pass (`edge_weight`) gives the edge sample all the
    weight; the vertical pass keeps the fraction and blends the clamped row
    with itself, which rounds differently in fixed point."""
    f = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0).astype(np.float32)
    if edge_weight:
        f[(i0 < 0) | (i0 >= src - 1)] = 0.0
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), f


def resize_linear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(img, (width, height)) with INTER_LINEAR, up or down. uint8
    follows OpenCV's fixed-point rule exactly: weights rounded to 11 bits,
    the horizontal pass in integers, the vertical one as its vectorized code
    does, ((r0 >> 4) b0 >> 16) + ((r1 >> 4) b1 >> 16) rounded off by 2 bits
    (an exact halving reduces to OpenCV's 2x2 area mean, the same values).
    Float images blend with the float32 weights, as OpenCV's own code does;
    OpenCV hands float32 images of 1, 3 or 4 channels to Intel IPP where its
    build has it, whose sums round otherwise (within 2e-6 of the range)."""
    in_h, in_w = img.shape[:2]
    x0, x1, fx = _linear_taps(in_w, width, True)
    y0, y1, fy = _linear_taps(in_h, height, False)
    col = (slice(None),) + (None,) * (img.ndim - 2)  # a weight per output column
    row = (slice(None),) + (None,) * (img.ndim - 1)  # a weight per output row
    wx0, wy0 = np.float32(1) - fx, np.float32(1) - fy
    if img.dtype == np.uint8:
        ax0, ax1, by0, by1 = (np.rint(a * np.float32(2048)).astype(np.int64) for a in (wx0, fx, wy0, fy))
        src = img.astype(np.int64)
        rows = src[:, x0] * ax0[col] + src[:, x1] * ax1[col]
        out = ((((rows[y0] >> 4) * by0[row]) >> 16) + (((rows[y1] >> 4) * by1[row]) >> 16) + 2) >> 2
        return np.clip(out, 0, 255).astype(np.uint8)
    src = img.astype(np.float32)
    rows = src[:, x0] * wx0[col] + src[:, x1] * fx[col]
    return (rows[y0] * wy0[row] + rows[y1] * fy[row]).astype(img.dtype)


def pad_and_resize_flow(flow, pad, shape):
    """Undo RAFT's half-res crop: zero-pad back to the half-res frame, scale the
    vectors by the resolution ratio, nearest-resize to `shape` (warp_mesh.py:96)."""
    if pad is not None:
        top, bot, left, right = (int(p) for p in np.ravel(pad)[:4])
        flow = np.pad(flow, ((top, bot), (left, right), (0, 0)))
    ratio = shape[0] / flow.shape[0]
    return resize_nearest(flow * ratio, int(shape[0]), int(shape[1]))


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (trimesh-compatible up to normalization)."""
    fv = verts[faces]
    fn = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])  # area-weighted
    vn = np.zeros_like(verts)
    for k in range(3):
        np.add.at(vn, faces[:, k], fn)
    n = np.linalg.norm(vn, axis=-1, keepdims=True)
    return vn / np.maximum(n, 1e-12)


def mesh_vert_propagate(vert_adj, vert_adj_count, valid_mask, value, max_ite=20):
    """BFS average fill of invalid vertices from valid neighbors
    (warp_mesh.py:133-156), vectorized over the padded adjacency [V, D].
    Each round works on the rows still invalid, grouped by degree, and
    gathers only the real neighbours (the prefix of a padded row) of the rows
    it fills: per row the same sums in the same slot order as over the padded
    rows of all vertices, without the [V, D, C] temporaries."""
    value = value.copy()
    valid = valid_mask.copy()
    deg = np.asarray(vert_adj_count)
    for _ in range(max_ite):
        fills = []
        for k in np.unique(deg[~valid]):
            rows = np.flatnonzero(~valid & (deg == k))
            nb = vert_adj[rows, :k]  # [R, k]
            nb_valid = valid[nb]
            cnt = nb_valid.sum(axis=1)
            hit = cnt > 0
            if hit.any():
                sums = (value[nb[hit]] * nb_valid[hit][..., None]).sum(axis=1)
                fills.append((rows[hit], sums / cnt[hit, None]))
        if not fills:
            break
        for rows, vals in fills:
            value[rows] = vals
            valid[rows] = True
    return value


def mesh_value_smoothing(vert_adj, vert_adj_count, value, ite_num=10):
    """Neighbor-average smoothing (warp_mesh.py:158-172), vectorized. Like
    the reference, the vertex itself is excluded from the average.

    Rows are grouped by degree, and each group sums only its real neighbours
    (the prefix of its padded row) in slot order: the sums of the padded
    [V, D] rows, whose padding adds exact zeros, without their [V, D, C]
    temporaries (D is the largest degree, 250 at a uv_sphere's poles)."""
    deg = np.asarray(vert_adj_count)
    groups = [(rows, vert_adj[rows, :k], max(int(k), 1))
              for k in np.unique(deg) for rows in [np.flatnonzero(deg == k)]]
    out = value.copy()
    for _ in range(ite_num):
        new = np.empty_like(out)
        for rows, nb, k in groups:
            new[rows] = out[nb].sum(axis=1) / k
        out = new
    return out


def remove_outlier_mask(data, threshold=2.0, max_std=None):
    """Z-score outlier mask over axis 0 (warp_mesh.py:174-182): keep rows where
    all 3 coords have z < threshold."""
    mean = data.mean(axis=0)
    std = data.std(axis=0)
    if max_std is not None:
        std = np.minimum(std, max_std)
    z = (data - mean) / np.maximum(std, 1e-12)
    return (z < threshold).sum(axis=-1) == data.shape[-1]


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
