"""Analytic GT of a grey sphere on a green screen with a dent: ray-sphere
z-depth, `dent_depth` deeper where the surface point lies within
`dent_ball` of the dent's centre; grey `grey` on the sphere, `dent_grey` in
the dent, green off it at depth `miss` (the reference-scale frame's GT,
examples/refscale_frame.py:61-110)."""

from __future__ import annotations

import torch

from benchmark.scene import hit_ellipsoid


def prepare(spec, gen, device):
    return None


def shade(spec, state, eye, d):
    r = spec["radius"]
    t, hit = hit_ellipsoid(eye, d, spec["center"], (r, r, r), spec["miss"])
    dent_c = torch.as_tensor(spec["dent_center"], dtype=torch.float64, device=d.device)
    surface = eye + t[..., None] * d
    dent = hit & (torch.linalg.vector_norm(surface - dent_c, dim=-1) < spec["dent_ball"])
    depth = torch.where(dent, t + spec["dent_depth"], t)
    grey = torch.where(dent, spec["dent_grey"], spec["grey"]).to(torch.float64)
    green = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=d.device)
    img = torch.where(hit[..., None], grey[..., None].expand(*grey.shape, 3), green)
    return img.to(torch.float32), depth.to(torch.float32)
