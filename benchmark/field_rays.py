"""The field cell's initial weights and ray draws: the benchmark's own code,
which the program (benchmark/programs/field_step.py) and the plain
reference (benchmark/reference/field_step.py) both call, so that both start
from the same weights and see the same rays.

Weights: the hash tables uniform in +-config["train"]["tables_init"]
(Instant-NGP §4: U(-1e-4, 1e-4)), the MLPs' weights normal with standard
deviation sqrt(2 / fan-in) and zero biases, drawn on the device from a
generator seeded by the run's trainee colours (so from --seed).

Rays: for each camera of a step, half its rays uniform over the image and
half uniform over its foreground (the mask), as the port's train_field
draws them; a camera with no foreground draws all of its rays over the
image. The pixels and the [R, S] sample jitter are a function of the
cameras and the iteration alone, drawn on the device from a seeded
torch.Generator.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch


def layer_widths(field: dict) -> dict:
    """{"sigma": [(in, out)], "color": [(in, out)]} of the two MLPs:
    L F -> hidden -> 1 + geo, and (1 + geo where the density output is fed
    whole, else geo) + the direction's encoding -> hidden -> hidden -> 3."""
    geo = field["geo_features"] + (1 if field["feed_density"] else 0)
    dirs = field["sh_degree"] ** 2 if field["sh_degree"] else 3
    h = field["hidden"]
    return {"sigma": [(field["n_levels"] * field["n_features"], h), (h, 1 + field["geo_features"])],
            "color": [(geo + dirs, h), (h, h), (h, 3)]}


def initial_weights(config: dict, scene, device) -> dict:
    """{"tables": [L, T, F], "sigma": [(w [in, out], b [out])], "color": [...]}."""
    f = config["field"]
    seed = zlib.crc32(scene.colors[:64].detach().cpu().numpy().tobytes())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    a = config["train"]["tables_init"]
    shape = (f["n_levels"], f["table_size"], f["n_features"])
    tables = (2.0 * torch.rand(shape, generator=gen, device=device) - 1.0) * a
    out = {"tables": tables}
    for net, widths in layer_widths(f).items():
        out[net] = [(torch.randn((i, o), generator=gen, device=device) * float(np.sqrt(2.0 / i)),
                     torch.zeros(o, device=device)) for i, o in widths]
    return out


@dataclasses.dataclass
class Foreground:
    """Each camera's foreground pixels (y W + x), concatenated."""

    pixels: torch.Tensor  # [P + 1] int64 on the device; the last entry pads an empty camera's lookup
    offsets: list  # [C] where each camera's pixels start
    counts: list  # [C] how many there are
    width: int


def foreground(masks: torch.Tensor) -> Foreground:
    """The pixels of masks [C, H, W] above 0.5, camera by camera."""
    width = masks.shape[2]
    parts, offsets, counts, start = [], [], [], 0
    for c in range(masks.shape[0]):
        idx = torch.nonzero(masks[c].reshape(-1) > 0.5).flatten()
        parts.append(idx)
        offsets.append(start)
        counts.append(int(idx.numel()))
        start += counts[-1]
    parts.append(torch.zeros(1, dtype=torch.int64, device=masks.device))
    return Foreground(torch.cat(parts), offsets, counts, width)


def step_seed(cams, iteration: int) -> int:
    """The draws' seed: a function of the step's cameras and its iteration."""
    return zlib.crc32(np.asarray([iteration, *cams], np.int64).tobytes())


def draw(fg: Foreground, cams, iteration: int, rays_per_camera: int, n_samples: int, height: int, device):
    """(px [K, n] int64, py [K, n] int64, jitter [K n, S] float32 in [0, 1))
    for the K cameras `cams` of a step, n = rays_per_camera: the first n // 2
    of each camera's rays over its foreground, the rest over the image."""
    gen = torch.Generator(device=device)
    gen.manual_seed(step_seed(cams, iteration))
    k, n = len(cams), rays_per_camera
    px = torch.randint(0, fg.width, (k, n), generator=gen, device=device)
    py = torch.randint(0, height, (k, n), generator=gen, device=device)
    u = torch.rand((k, n // 2), generator=gen, device=device, dtype=torch.float64)
    for j, c in enumerate(cams):
        count = fg.counts[c]
        if count == 0:
            continue
        pick = fg.pixels[fg.offsets[c] + torch.clamp((u[j] * count).to(torch.int64), max=count - 1)]
        py[j, : n // 2] = pick // fg.width
        px[j, : n // 2] = pick % fg.width
    jitter = torch.rand((k * n, n_samples), generator=gen, device=device)
    return px, py, jitter
