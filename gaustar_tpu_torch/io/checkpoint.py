"""Checkpoints (counterpart of gaustar_tpu/io/checkpoint.py): SuGaR frame
checkpoints (.npz, the reference's .pt equivalent), the mid-frame refine
state, and the 3DGS .ply export (convert_refined_sugar_into_gaussians,
sugar_model.py:1416-1437).

Frame checkpoints use the JAX package's npz keys and json sidecar, with its
dtypes (faces int32), so that a checkpoint written by either package loads
in the other: the npz holds each SuGaRParams field by name, `faces`, `bary`,
`thickness`, `iteration` and optionally `train_losses`; the sidecar holds
n_gaussians_per_face, sh_levels, min_scale, max_scale and loose_bind.

The refine state (save_refine_state) is the port's own: the parameters, then
the named-group Adam state in a fixed order, `adam_count` and, for each
SuGaRParams field in declaration order, `adam_mu_<field>` and
`adam_nu_<field>`, then `iteration`, `loose_bind` and optionally
`unbind_weight`. It does not load in the JAX package, whose optimizer state
is an optax tree.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from gaustar_tpu_torch.models import gaussians, sugar
from gaustar_tpu_torch.ops import segment
from gaustar_tpu_torch.train.optimizer import AdamState
from gaustar_tpu_torch.utils.general import resolve_device

_PARAM_FIELDS = [f.name for f in dataclasses.fields(sugar.SuGaRParams)]


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_sugar(path: str, params: sugar.SuGaRParams, config: sugar.SuGaRConfig, iteration: int = 0,
               train_losses=None):
    arrays = {name: _np(getattr(params, name)) for name in _PARAM_FIELDS}
    arrays["faces"] = _np(config.faces).astype(np.int32)
    arrays["bary"] = _np(config.bary)
    arrays["thickness"] = _np(config.thickness)
    arrays["iteration"] = np.asarray(iteration)
    if train_losses is not None:
        arrays["train_losses"] = np.asarray(train_losses)
    np.savez_compressed(path, **arrays)
    meta = {
        "n_gaussians_per_face": config.n_gaussians_per_face,
        "sh_levels": config.sh_levels,
        "min_scale": config.min_scale,
        "max_scale": config.max_scale,
        "loose_bind": config.loose_bind,
    }
    with open(os.path.splitext(path)[0] + ".json", "w") as f:
        json.dump(meta, f, indent=2)


def load_sugar(path: str, device="cuda"):
    """(params, config, iteration) on `device`; the params are fresh leaves
    requiring grad."""
    dev = resolve_device(device)
    data = dict(np.load(path))
    with open(os.path.splitext(path)[0] + ".json") as f:
        meta = json.load(f)
    params = sugar.make_params(data, dev)
    faces = data["faces"]
    config = sugar.SuGaRConfig(
        faces=torch.as_tensor(faces, dtype=torch.int64, device=dev),
        bary=torch.as_tensor(data["bary"], device=dev),
        thickness=torch.as_tensor(data["thickness"], device=dev),
        n_gaussians_per_face=int(meta["n_gaussians_per_face"]),
        sh_levels=int(meta["sh_levels"]),
        min_scale=meta["min_scale"],
        max_scale=meta["max_scale"],
        loose_bind=bool(meta["loose_bind"]),
        face_gather=segment.gather_tables(faces, len(data["points"]), dev),
    )
    return params, config, int(data.get("iteration", 0))


def save_refine_state(path: str, params: sugar.SuGaRParams, opt_state: AdamState, iteration: int,
                      unbind_weight=None, loose_bind: bool = False):
    """The mid-frame refine checkpoint (beyond the reference, which restarts
    a frame from its mesh), in the order the module docstring gives."""
    arrays = {name: _np(getattr(params, name)) for name in _PARAM_FIELDS}
    arrays["adam_count"] = np.asarray(opt_state.count)
    for name in _PARAM_FIELDS:
        arrays[f"adam_mu_{name}"] = _np(opt_state.mu[name])
        arrays[f"adam_nu_{name}"] = _np(opt_state.nu[name])
    arrays["iteration"] = np.asarray(iteration)
    arrays["loose_bind"] = np.asarray(int(loose_bind))
    if unbind_weight is not None:
        arrays["unbind_weight"] = _np(unbind_weight)
    np.savez_compressed(path, **arrays)


def load_refine_state(path: str, device="cuda"):
    """(params, opt_state, iteration, unbind_weight or None, loose_bind) on
    `device`."""
    dev = resolve_device(device)
    data = dict(np.load(path))
    params = sugar.make_params(data, dev)

    def t(a):
        return torch.as_tensor(a, device=dev).clone()

    opt_state = AdamState(
        count=int(data["adam_count"]),
        mu={name: t(data[f"adam_mu_{name}"]) for name in _PARAM_FIELDS},
        nu={name: t(data[f"adam_nu_{name}"]) for name in _PARAM_FIELDS},
    )
    uw = t(data["unbind_weight"]) if "unbind_weight" in data else None
    return params, opt_state, int(data["iteration"]), uw, bool(int(data["loose_bind"]))


@torch.no_grad()
def sugar_to_gaussians(params: sugar.SuGaRParams, config: sugar.SuGaRConfig) -> gaussians.GaussianParams:
    """Vanilla 3DGS export (sugar_model.py:1416-1437): positions, opacity
    logits, SH, log of the clamped 3-axis scaling, normalized quaternions."""
    return gaussians.GaussianParams(
        xyz=sugar.gaussian_centers(params, config),
        features_dc=params.sh_dc.detach(),
        features_rest=params.sh_rest.detach(),
        scaling=torch.log(sugar.scaling(params, config)),
        rotation=sugar.quaternions(params, config),
        opacity=params.densities.detach(),
    )


def export_refined_ply(path: str, params: sugar.SuGaRParams, config: sugar.SuGaRConfig):
    """The per-frame NNNN.ply export (refine.py:855-864)."""
    gaussians.save_ply(sugar_to_gaussians(params, config), path)
