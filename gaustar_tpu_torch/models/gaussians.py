"""The vanilla 3DGS model: parameters, initialization from a point cloud,
rendering and the .ply checkpoint format (counterpart of
gaustar_tpu/models/gaussians.py; gaussian_model.py:24-256).

Activations, as the reference's: scaling = exp(log-scales), opacity =
sigmoid(logits), rotation = normalized w-first quaternion; SH features split
into dc [N, 1, 3] and rest [N, K-1, 3].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.io import ply
from gaustar_tpu_torch.ops import sh as sh_ops
from gaustar_tpu_torch.ops.knn import dist2_avg3
from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
from gaustar_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from gaustar_tpu_torch.utils.general import inverse_sigmoid, normalize, resolve_device


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor  # [N, 3]
    features_dc: torch.Tensor  # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor  # [N, 3] log-scales
    rotation: torch.Tensor  # [N, 4] raw quats (normalized at use)
    opacity: torch.Tensor  # [N, 1] logits

    def named(self):
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)]


def n_points(p: GaussianParams) -> int:
    return p.xyz.shape[0]


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.scaling)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return normalize(p.rotation)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.opacity)


def get_features(p: GaussianParams) -> torch.Tensor:
    return torch.cat([p.features_dc, p.features_rest], dim=1)  # [N, K, 3]


def create_from_pcd(points, colors, sh_degree: int = 2, device="cuda") -> GaussianParams:
    """From a coloured point cloud (gaussian_model.py:121-144): isotropic
    log-scales log(sqrt(dist2_avg3)) with dist2 clamped at 1e-7, opacity
    0.1, identity rotations, the colours as the DC band. `points` and
    `colors` are [N, 3] arrays or tensors; the result's tensors lie on
    `device` and do not require grad."""
    dev = resolve_device(device)
    xyz = torch.as_tensor(points, dtype=torch.float32, device=dev).contiguous()
    rgb = torch.as_tensor(colors, dtype=torch.float32, device=dev)
    n, k = xyz.shape[0], (sh_degree + 1) ** 2
    dist2 = torch.clamp_min(dist2_avg3(xyz), 1e-7)
    rotation = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    rotation[:, 0] = 1.0
    return GaussianParams(
        xyz=xyz,
        features_dc=sh_ops.rgb_to_sh(rgb)[:, None, :],
        features_rest=torch.zeros((n, k - 1, 3), dtype=torch.float32, device=dev),
        scaling=torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3),
        rotation=rotation,
        opacity=inverse_sigmoid(torch.full((n, 1), 0.1, dtype=torch.float32, device=dev)),
    )


def render(
    p: GaussianParams,
    camera: Camera,
    bg=(0.0, 0.0, 0.0),
    sh_deg: int | None = None,
    raster_config: RasterConfig = RasterConfig(),
    means2d_dummy=None,
):
    """(image [H, W, 3], RasterAux) through ops/rasterizer.rasterize, SH
    evaluated here at `sh_deg` (all bands when None)
    (gaussian_renderer/__init__.py:18-113)."""
    feats = get_features(p)
    if sh_deg is None:
        sh_deg = int(np.sqrt(feats.shape[1])) - 1
    colors = sh_ops.sh_to_rgb(sh_deg, feats[:, : (sh_deg + 1) ** 2], p.xyz, camera.camera_center)
    cov = quat_scale_to_cov3d(get_scaling(p), get_rotation(p))
    return rasterize(p.xyz, cov, get_opacity(p).reshape(-1), colors, camera, bg=bg, config=raster_config,
                     means2d_dummy=means2d_dummy)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_ply(p: GaussianParams, path: str):
    """The 3DGS .ply layout (gaussian_model.py:191-217): x y z, zero
    normals, f_dc and f_rest channel-major, opacity, scale_0..2, rot_0..3."""
    xyz = _np(p.xyz)
    n = len(xyz)
    f_dc = _np(p.features_dc).transpose(0, 2, 1).reshape(n, -1)  # channel-major
    f_rest = _np(p.features_rest).transpose(0, 2, 1).reshape(n, -1)
    props = {"x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2]}
    for a, name in zip(np.zeros((3, n), np.float32), ["nx", "ny", "nz"]):
        props[name] = a
    for i in range(f_dc.shape[1]):
        props[f"f_dc_{i}"] = f_dc[:, i]
    for i in range(f_rest.shape[1]):
        props[f"f_rest_{i}"] = f_rest[:, i]
    props["opacity"] = _np(p.opacity)[:, 0]
    sc = _np(p.scaling)
    for i in range(3):
        props[f"scale_{i}"] = sc[:, i]
    rot = _np(p.rotation)
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]
    ply.write_ply(path, props)


def load_ply(path: str, device="cuda") -> GaussianParams:
    """GaussianParams of float32 tensors on `device` from a 3DGS .ply."""
    dev = resolve_device(device)
    v = ply.read_ply(path)["vertex"]
    n = len(v["x"])
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)  # [N, 3]
    rest_names = sorted((k for k in v if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1]))
    if rest_names:
        f_rest = np.stack([v[k] for k in rest_names], axis=1).astype(np.float32)
        f_rest = f_rest.reshape(n, 3, len(rest_names) // 3).transpose(0, 2, 1)
    else:
        f_rest = np.zeros((n, 0, 3), np.float32)
    scaling = np.stack([v[f"scale_{i}"] for i in range(3)], axis=1).astype(np.float32)
    rotation = np.stack([v[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float32)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)

    return GaussianParams(
        xyz=t(xyz),
        features_dc=t(f_dc[:, None, :]),
        features_rest=t(f_rest),
        scaling=t(scaling),
        rotation=t(rotation),
        opacity=t(v["opacity"].astype(np.float32)[:, None]),
    )
