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
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import segment
from gaustar_tpu_torch.train.refine import FrameData
from gaustar_tpu_torch.utils.general import resolve_device


def sugar_params_from_numpy(arrays: dict, device="cuda") -> sugar.SuGaRParams:
    """SuGaRParams (fresh leaves requiring grad) from {field: array}."""
    return sugar.make_params(arrays, resolve_device(device))


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
