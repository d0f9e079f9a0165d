"""Image and mesh losses (counterpart of gaustar_tpu/ops/losses.py).

SSIM: 11x11 Gaussian window, sigma 1.5, zero padding, C1 = 0.01^2,
C2 = 0.03^2 (loss_utils.py:17-63), channels-major [C, H, W]. The separable
window runs as shift-and-add in full float32: no conv2d, so no cuDNN and no
TF32; the refine step's masked SSIM and its other pixel terms run as one CUDA
forward and one backward (ops/pixel_loss.py), with this SSIM as their plain
version. Mesh regularizers: normal consistency and the edge/area isometry terms
of refine.py:678-718, all from one verts[faces] gather.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from gaustar_tpu_torch.ops.segment import gather_rows


def l1_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.abs(pred - gt).mean()


def l2_loss(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return ((pred - gt) ** 2).mean()


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((x - window_size // 2) ** 2) / (2.0 * sigma**2))
    g = (g / g.sum()).astype(np.float32)
    return np.outer(g, g)


@functools.lru_cache(maxsize=8)
def _ssim_factors(window_size: int):
    """(kcol, krow) of the rank-1 SSIM window, as host floats."""
    u, s, vt = np.linalg.svd(_gaussian_window(window_size, 1.5))
    kcol = (u[:, 0] * np.sqrt(s[0])).astype(np.float32)
    krow = (vt[0] * np.sqrt(s[0])).astype(np.float32)
    return tuple(float(k) for k in kcol), tuple(float(k) for k in krow)


def _sep_filter_bhw(x: torch.Tensor, kcol, krow) -> torch.Tensor:
    """Separable zero-'same' filter over [B, H, W] as shift-and-add."""
    h, w = len(kcol), len(krow)
    H, W = x.shape[-2], x.shape[-1]
    xp = F.pad(x, (0, 0, h // 2, h // 2))
    x = sum(kcol[k] * xp[:, k : k + H, :] for k in range(h))
    xp = F.pad(x, (w // 2, w // 2, 0, 0))
    return sum(krow[k] * xp[:, :, k : k + W] for k in range(w))


SSIM_C1 = 0.01**2
SSIM_C2 = 0.03**2


def ssim_moments_cm(img1_cm: torch.Tensor, img2_cm: torch.Tensor, window_size: int = 11):
    """The window's moments of two [C, H, W] images x, y: (mu1, mu2, E[x^2],
    E[y^2], E[xy]), each [C, H, W]."""
    kcol, krow = _ssim_factors(window_size)
    stack = torch.cat(
        [img1_cm, img2_cm, img1_cm * img1_cm, img2_cm * img2_cm, img1_cm * img2_cm], dim=0
    )
    return _sep_filter_bhw(stack, kcol, krow).split(img1_cm.shape[0])


def ssim_from_moments(mu1, mu2, e11, e22, e12) -> torch.Tensor:
    """The SSIM map from the window's moments (ssim_moments_cm)."""
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu1_mu2
    return ((2.0 * mu1_mu2 + SSIM_C1) * (2.0 * sigma12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (sigma1_sq + sigma2_sq + SSIM_C2)
    )


def ssim_map_cm(img1_cm: torch.Tensor, img2_cm: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map of two [C, H, W] images -> [C, H, W]."""
    return ssim_from_moments(*ssim_moments_cm(img1_cm, img2_cm, window_size))


def ssim_map(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Per-pixel SSIM map of two [H, W, C] images -> [H, W, C]."""
    return ssim_map_cm(img1.permute(2, 0, 1), img2.permute(2, 0, 1), window_size).permute(1, 2, 0)


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an [H, W, C] image pair (loss_utils.py:33-63)."""
    return ssim_map(img1, img2, window_size).mean()


def rgb_loss(pred: torch.Tensor, gt: torch.Tensor, dssim_factor: float = 0.2) -> torch.Tensor:
    """0.8*L1 + 0.2*DSSIM on [H, W, C] images (refine.py:107-109, 446-453)."""
    return (1.0 - dssim_factor) * l1_loss(pred, gt) + dssim_factor * (1.0 - ssim(pred, gt))


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = ((pred - gt) ** 2).mean()
    return 20.0 * torch.log10(1.0 / torch.sqrt(mse))


# ---------------------------------------------------------------------------
# Mesh regularizers
# ---------------------------------------------------------------------------


def _safe_norm(sq: torch.Tensor) -> torch.Tensor:
    # Clamp INSIDE the sqrt: a degenerate face gets gradient 0, not 0 * inf.
    return torch.sqrt(torch.maximum(sq, sq.new_full((), 1e-24)))


def _face_corner_comps(verts, faces, tables=None):
    """Face corner coordinates v[k][d], each [F], from one row gather."""
    f = faces.shape[0]
    fv = gather_rows(verts, faces.reshape(-1), tables).reshape(f, 3, 3)
    return [[fv[:, k, d] for d in range(3)] for k in range(3)]


def _cross_comps(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def _area_normal_from_comps(v):
    e1 = [v[1][d] - v[0][d] for d in range(3)]
    e2 = [v[2][d] - v[0][d] for d in range(3)]
    n = _cross_comps(e1, e2)
    nn = _safe_norm(n[0] * n[0] + n[1] * n[1] + n[2] * n[2])
    inv = 1.0 / nn
    return 0.5 * nn, [n[d] * inv for d in range(3)]


def face_areas_normals(verts, faces):
    """Per-face areas [F] and unit normals [F, 3]."""
    areas, n = _area_normal_from_comps(_face_corner_comps(verts, faces))
    return areas, torch.stack(n, dim=-1)


def edge_lengths(verts, edges) -> torch.Tensor:
    ev = verts[edges.reshape(-1)].reshape(-1, 2, 3)
    d = [ev[:, 0, k] - ev[:, 1, k] for k in range(3)]
    return _safe_norm(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])


def mesh_edge_isometry_loss(verts, edges, ref_lengths) -> torch.Tensor:
    """(edge_len - ref_len)^2 mean, refine.py:690-698."""
    return ((edge_lengths(verts, edges) - ref_lengths) ** 2).mean()


def face_edge_tables(faces: np.ndarray, edges: np.ndarray, ref_lengths: np.ndarray):
    """Host tables for the edge-iso loss on the face gather: per face corner
    k, the reference length [F, 3] of edge (faces[:, k], faces[:, (k+1)%3])
    and a weight [F, 3] = 1 / (E * multiplicity), so the weighted sum over
    face edges is the MEAN over unique edges."""
    faces = np.asarray(faces)
    edges = np.asarray(edges)
    nv = int(max(faces.max(), edges.max())) + 1
    fe_a = faces
    fe_b = faces[:, [1, 2, 0]]
    fe_key = np.minimum(fe_a, fe_b).astype(np.int64) * nv + np.maximum(fe_a, fe_b)
    e_key = np.minimum(edges[:, 0], edges[:, 1]).astype(np.int64) * nv + np.maximum(
        edges[:, 0], edges[:, 1]
    )
    order = np.argsort(e_key)
    pos = np.searchsorted(e_key[order], fe_key.reshape(-1))
    edge_id = order[pos].reshape(faces.shape)
    if not (e_key[edge_id] == fe_key).all():
        raise ValueError("face edge not found in the edge list")
    mult = np.bincount(edge_id.reshape(-1), minlength=len(edges))
    w = (1.0 / (mult[edge_id] * float(len(edges)))).astype(np.float32)
    ref = np.asarray(ref_lengths, np.float32)[edge_id]
    return ref, w


def _edge_iso_from_comps(v, face_edge_ref, face_edge_w) -> torch.Tensor:
    total = 0.0
    for k in range(3):
        k2 = (k + 1) % 3
        d = [v[k][dd] - v[k2][dd] for dd in range(3)]
        ln = _safe_norm(d[0] * d[0] + d[1] * d[1] + d[2] * d[2])
        total = total + (face_edge_w[:, k] * (ln - face_edge_ref[:, k]) ** 2).sum()
    return total


def mesh_regularizers(
    verts,
    faces,
    adj_faces,
    ref_area,
    face_edge_ref=None,
    face_edge_w=None,
    edges=None,
    ref_edge_len=None,
    tables=None,
    adj_tables=None,
):
    """The three mesh losses of refine.py:678-718 from ONE verts[faces]
    gather, so autograd adds their cotangents before the one per-vertex
    reduction. Returns {'nc', 'edge', 'area'} (edge = 0 without tables or
    edges)."""
    v = _face_corner_comps(verts, faces, tables)
    areas, n = _area_normal_from_comps(v)
    normals = torch.stack(n, dim=-1)
    nv = gather_rows(normals, adj_faces.reshape(-1), adj_tables).reshape(-1, 2, 3)
    dot = sum(nv[:, 0, d] * nv[:, 1, d] for d in range(3))
    nc = (1.0 - dot).mean()
    if face_edge_ref is not None:
        edge = _edge_iso_from_comps(v, face_edge_ref, face_edge_w)
    elif edges is not None:
        edge = mesh_edge_isometry_loss(verts, edges, ref_edge_len)
    else:
        edge = verts.new_zeros(())
    area = torch.abs(areas - ref_area).mean()
    return {"nc": nc, "edge": edge, "area": area}


def mesh_normal_consistency_loss(verts, faces, adj_faces, tables=None, adj_tables=None):
    """Mean (1 - cos) between the normals of face pairs sharing an edge; on a
    consistently wound manifold equal to pytorch3d's vertex-opposite form."""
    _, n = _area_normal_from_comps(_face_corner_comps(verts, faces, tables))
    normals = torch.stack(n, dim=-1)
    nv = gather_rows(normals, adj_faces.reshape(-1), adj_tables).reshape(-1, 2, 3)
    dot = sum(nv[:, 0, d] * nv[:, 1, d] for d in range(3))
    return (1.0 - dot).mean()


def mesh_laplacian_smoothing_loss(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Uniform-Laplacian smoothing (the reference's default-off
    surface_mesh_laplacian_smoothing_loss, refine.py:117-122, 680-682): mean
    over vertices of ||mean(neighbours) - v||, neighbours from the undirected
    edge list; isolated vertices contribute 0. The norm clamps its square at
    1e-24 inside the sqrt, so a vertex at its neighbours' centroid gets
    gradient 0, not NaN."""
    n = verts.shape[0]
    src = torch.cat([edges[:, 0], edges[:, 1]])
    dst = torch.cat([edges[:, 1], edges[:, 0]])
    nb_sum = verts.new_zeros((n, 3)).index_add(0, src, verts[dst])
    deg = verts.new_zeros(n).index_add(0, src, torch.ones_like(src, dtype=verts.dtype))
    lap = nb_sum / torch.clamp_min(deg, 1.0)[:, None] - verts
    lap = torch.where((deg > 0)[:, None], lap, torch.zeros_like(lap))
    return _safe_norm((lap * lap).sum(-1)).mean()


def mesh_area_reg_loss(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """relu(mean_area / face_area - 2).mean() with the mean area detached:
    the reference's default-off area_reg, penalizing faces that shrink below
    half the average area (refine.py:143-144, 713-718)."""
    areas, _ = face_areas_normals(verts, faces)
    mean_area = areas.mean().detach()
    return torch.relu(mean_area / torch.clamp_min(areas, 1e-12) - 2.0).mean()
