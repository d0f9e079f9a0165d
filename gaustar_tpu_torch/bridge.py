"""Carry the JAX package's weights and state into the port.

Every function takes the JAX package's values as numpy arrays (a dict keyed
by the JAX dataclass's field names, or plain arrays) and returns the port's
objects on `device`. This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.models import gaussians, neural_field, sugar
from gaustar_tpu_torch.ops import segment
from gaustar_tpu_torch.parallel import gauss2d
from gaustar_tpu_torch.train.refine import FrameData
from gaustar_tpu_torch.utils.general import resolve_device


def sugar_params_from_numpy(arrays: dict, device="cuda") -> sugar.SuGaRParams:
    """SuGaRParams (fresh leaves requiring grad) from {field: array}."""
    return sugar.make_params(arrays, resolve_device(device))


def sugar_shard_from_numpy(arrays: dict, d_gauss: int, rank: int, device="cuda") -> sugar.SuGaRParams:
    """Rank `rank`'s shard of the gauss axis, cut as parallel/gauss2d.py:
    shard_sugar cuts it (every per-gaussian leaf in d_gauss blocks of whole
    faces, `points` whole), from {field: array} of the JAX SuGaRParams."""
    rows = gauss2d.shard_bounds(len(arrays["scales"]), d_gauss, rank)
    return sugar_params_from_numpy({k: np.asarray(v) if k == "points" else np.asarray(v)[rows]
                                    for k, v in arrays.items()}, device)


def gaussian_params_from_numpy(arrays: dict, device="cuda") -> gaussians.GaussianParams:
    """GaussianParams of float32 copies from {field: array} of the JAX
    GaussianParams (no dead slots expected: pass only its live rows)."""
    dev = resolve_device(device)
    return gaussians.GaussianParams(
        **{f.name: torch.tensor(np.asarray(arrays[f.name], np.float32), device=dev)
           for f in dataclasses.fields(gaussians.GaussianParams)}
    )


def sugar_config_from_numpy(arrays: dict, device="cuda") -> sugar.SuGaRConfig:
    """SuGaRConfig from {field: value} of the JAX SuGaRConfig; the gather
    tables are rebuilt from the faces."""
    dev = resolve_device(device)
    faces = np.asarray(arrays["faces"])
    n_verts = int(arrays["n_verts"]) if "n_verts" in arrays else int(faces.max()) + 1
    return sugar.SuGaRConfig(
        faces=torch.as_tensor(faces, dtype=torch.int64, device=dev),
        bary=torch.as_tensor(np.asarray(arrays["bary"], np.float32), device=dev),
        thickness=torch.as_tensor(np.asarray(arrays["thickness"], np.float32), device=dev),
        n_gaussians_per_face=int(arrays["n_gaussians_per_face"]),
        sh_levels=int(arrays["sh_levels"]),
        min_scale=arrays.get("min_scale"),
        max_scale=arrays.get("max_scale"),
        loose_bind=bool(arrays.get("loose_bind", False)),
        face_gather=segment.gather_tables(faces, n_verts, dev),
    )


def camera_from_numpy(R, T, fx, fy, cx, cy, width: int, height: int, znear=0.01, zfar=100.0,
                      device="cuda") -> Camera:
    """A Camera (or a batched one, with leading axes) from its fields."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return Camera(R=t(R), T=t(T), fx=t(fx), fy=t(fy), cx=t(cx), cy=t(cy),
                  width=int(width), height=int(height), znear=float(znear), zfar=float(zfar))


def frame_data_from_numpy(arrays: dict, device="cuda") -> FrameData:
    """FrameData from {field: array} of the JAX FrameData; `cameras` is a dict
    of the batched camera's fields. Optional tables may be absent or None."""
    dev = resolve_device(device)

    def f32(k):
        return torch.as_tensor(np.asarray(arrays[k], np.float32), device=dev)

    def i64(k):
        return torch.as_tensor(np.asarray(arrays[k]), dtype=torch.int64, device=dev)

    adj_gather = arrays.get("adj_gather")
    if adj_gather is not None:
        adj_gather = tuple(torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev) for a in adj_gather)
    opt = {k: (f32(k) if arrays.get(k) is not None else None) for k in ("face_edge_ref", "face_edge_w")}
    return FrameData(
        cameras=camera_from_numpy(**arrays["cameras"], device=dev),
        gt_images=f32("gt_images"),
        gt_depths=f32("gt_depths"),
        margins=i64("margins"),
        ref_edge_len=f32("ref_edge_len"),
        ref_area=f32("ref_area"),
        edges=i64("edges"),
        adj_faces=i64("adj_faces"),
        adj_gather=adj_gather,
        **opt,
    )


def config_from_fields(cls, fields: dict):
    """A port config dataclass (TopoDetectConfig, SequenceConfig, ...) from
    the fields of the JAX package's namesake (dataclasses.asdict). A field
    the port's class lacks raises."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(fields) - names
    if unknown:
        raise ValueError(f"{cls.__name__} has no fields {sorted(unknown)}")
    return cls(**fields)


def field_params_from_numpy(arrays: dict, device="cuda"):
    """The port's field from {field: array} of the JAX package's
    HashGridParams (tables [L, F, T]) or Field4DParams (tables [4, L, F, T],
    vectors): the tables transposed to the port's [.., T, F] rows, the MLP
    dicts {"l0": {"w", "b"}, ...} in layer order."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, np.float32), device=dev)

    def layers(mlp):
        return [(t(mlp[f"l{i}"]["w"]), t(mlp[f"l{i}"]["b"])) for i in range(len(mlp))]

    tables = t(np.swapaxes(np.asarray(arrays["tables"]), -1, -2))
    sigma, color = layers(arrays["mlp_sigma"]), layers(arrays["mlp_color"])
    if "vectors" in arrays:
        return neural_field.Field4D(tables, t(arrays["vectors"]), sigma, color)
    return neural_field.HashGridField(tables, sigma, color)


def raft_state_dict_from_numpy(arrays: dict, device="cuda") -> dict:
    """A RAFT state dict from the JAX package's parameter dict, whose keys
    are already the torch names (tools/raft.py)."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev) for k, v in arrays.items()}
