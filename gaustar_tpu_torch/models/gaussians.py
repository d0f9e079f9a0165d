"""Vanilla 3DGS parameters and their .ply checkpoint format (counterpart of
part of gaustar_tpu/models/gaussians.py; gaussian_model.py:24-256).

Only what the SuGaR export needs is here: `GaussianParams`, `save_ply` and
`load_ply`. The rest of the JAX module (the vanilla 3DGS model and its
renderer) belongs to the periphery and is not ported yet. Activations, as
the reference's: scaling = exp(log-scales), opacity = sigmoid(logits),
rotation = normalized w-first quaternion; SH features split into dc
[N, 1, 3] and rest [N, K-1, 3].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.io import ply


@dataclasses.dataclass
class GaussianParams:
    xyz: torch.Tensor  # [N, 3]
    features_dc: torch.Tensor  # [N, 1, 3]
    features_rest: torch.Tensor  # [N, K-1, 3]
    scaling: torch.Tensor  # [N, 3] log-scales
    rotation: torch.Tensor  # [N, 4] raw quats (normalized at use)
    opacity: torch.Tensor  # [N, 1] logits


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


def load_ply(path: str, device="cpu") -> GaussianParams:
    """GaussianParams of float32 tensors on `device` from a 3DGS .ply."""
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
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return GaussianParams(
        xyz=t(xyz),
        features_dc=t(f_dc[:, None, :]),
        features_rest=t(f_rest),
        scaling=t(scaling),
        rotation=t(rotation),
        opacity=t(v["opacity"].astype(np.float32)[:, None]),
    )
