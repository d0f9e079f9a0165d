"""Rigid registration and SuGaR scene editing (counterpart of
gaustar_tpu/tools/registration.py; internal_use_tools/gstar_edit.py).

Kabsch best-fit rigid transform (gstar_edit.py:28 best_fit_transform) and
nearest-neighbour ICP on the host in float64, as the reference computes them;
the model edits (cut by box, select faces, rigid transform, recolour) on the
model's tensors, on its device. Compose with models/compositor.py for merged
scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.spatial import cKDTree

from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import segment
from gaustar_tpu_torch.ops.sh import rgb_to_sh, sh_to_rgb_dc


def best_fit_transform(A: np.ndarray, B: np.ndarray):
    """Least-squares rigid transform mapping A -> B (Kabsch). Returns (T 4x4, R, t)."""
    if A.shape != B.shape:
        raise ValueError(f"point sets differ in shape: {A.shape} vs {B.shape}")
    ca = A.mean(axis=0)
    cb = B.mean(axis=0)
    H = (A - ca).T @ (B - cb)
    U, _, Vt = np.linalg.svd(H)
    R = Vt.T @ U.T
    if np.linalg.det(R) < 0:
        Vt[-1] *= -1
        R = Vt.T @ U.T
    t = cb - R @ ca
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = t
    return T, R, t


def icp(src: np.ndarray, dst: np.ndarray, max_iterations: int = 20, tolerance: float = 1e-7):
    """Point-to-point ICP: returns (T 4x4, rms history)."""
    cur = np.array(src, np.float64)
    T_total = np.eye(4)
    tree = cKDTree(dst)
    prev_err = np.inf
    history = []
    for _ in range(max_iterations):
        d, idx = tree.query(cur)
        T, R, t = best_fit_transform(cur, dst[idx])
        cur = cur @ R.T + t
        T_total = T @ T_total
        err = float(np.sqrt((d**2).mean()))
        history.append(err)
        if abs(prev_err - err) < tolerance:
            break
        prev_err = err
    return T_total, history


@torch.no_grad()
def gaussian_mask_in_box(params, config, bb) -> torch.Tensor:
    """[N] mask of the gaussians whose centres lie inside the AABB bb [2, 3]."""
    centers = sugar.gaussian_centers(params, config)
    lo, hi = (torch.as_tensor(np.asarray(b, np.float32), device=centers.device) for b in bb)
    return ((centers > lo) & (centers < hi)).all(dim=-1)


@torch.no_grad()
def cut_model_by_box(params, config, bb, keep_inside=True):
    """Cut a SuGaR model by an AABB at face granularity (each face by the mean
    of its gaussians' centres), which keeps the mesh binding consistent.
    Returns (params, config) over the kept faces."""
    centers = sugar.gaussian_centers(params, config).cpu().numpy()
    face_centers = centers.reshape(-1, config.n_gaussians_per_face, 3).mean(axis=1)
    inside = ((face_centers > np.asarray(bb[0])) & (face_centers < np.asarray(bb[1]))).all(-1)
    return select_faces(params, config, inside if keep_inside else ~inside)


def select_faces(params, config, face_mask: np.ndarray):
    """The model over the faces of `face_mask` [F], its vertices re-indexed
    (the unused ones dropped) and its gather tables rebuilt."""
    face_mask = np.asarray(face_mask, bool)
    faces_np = config.faces.cpu().numpy()
    faces = faces_np[face_mask]
    used = np.unique(faces)
    remap = np.full(int(faces_np.max()) + 1, -1, np.int64)
    remap[used] = np.arange(len(used))
    new_faces = remap[faces]
    dev = params.points.device
    gmask = torch.as_tensor(np.repeat(face_mask, config.n_gaussians_per_face), device=dev)
    keep = {k: v[gmask] for k, v in params.named() if k != "points"}
    new_params = sugar.fresh_params(params, points=params.points[torch.as_tensor(used, device=dev)], **keep)
    new_config = dataclasses.replace(
        config, faces=torch.as_tensor(new_faces, dtype=torch.int64, device=dev),
        face_gather=segment.gather_tables(new_faces, len(used), dev))
    return new_params, new_config


@torch.no_grad()
def transform_model(params, config, T: np.ndarray):
    """Apply a rigid transform (4x4) to the model's vertices and delta_t."""
    dev = params.points.device
    R = torch.as_tensor(np.asarray(T[:3, :3], np.float32), device=dev)
    t = torch.as_tensor(np.asarray(T[:3, 3], np.float32), device=dev)
    return sugar.fresh_params(params, points=params.points @ R.T + t, delta_t=params.delta_t @ R.T)


@torch.no_grad()
def recolor_model(params, factor=(1.0, 1.0, 1.0), offset=(0.0, 0.0, 0.0)):
    """Linear colour edit in RGB through the SH dc term (gstar_edit.py:295)."""
    dev = params.sh_dc.device
    rgb = sh_to_rgb_dc(params.sh_dc)
    rgb = rgb * torch.as_tensor(factor, dtype=torch.float32, device=dev) + torch.as_tensor(
        offset, dtype=torch.float32, device=dev)
    return sugar.fresh_params(params, sh_dc=rgb_to_sh(rgb))
