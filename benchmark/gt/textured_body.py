"""Analytic GT of a textured ellipsoid body on a green screen: ray-ellipsoid
z-depth, `miss` off it; colour from the multi-octave procedural albedo of
the reference-scale real capture (refscale/scenes.py texture) at each ray's
hit point, its 4 x 3 phases drawn from the seed."""

from __future__ import annotations

import math

import torch

from benchmark.scene import hit_ellipsoid


def prepare(spec, gen, device):
    """The octaves' phases [4, 3], uniform in [0, 2 pi)."""
    return 2.0 * math.pi * torch.rand((len(spec["octaves"]), 3), generator=gen, device=device).to(torch.float64)


def shade(spec, phases, eye, d):
    t, hit = hit_ellipsoid(eye, d, spec["center"], spec["semi_axes"], spec["miss"])
    c = torch.as_tensor(spec["center"], dtype=torch.float64, device=d.device)
    p = (eye + t[..., None] * d - c) * spec["frequency"]
    albedo = torch.zeros_like(p)
    for o, (k, amp) in enumerate(spec["octaves"]):
        for ch in range(3):
            albedo[..., ch] += amp * torch.sin(k * (p[..., ch % 3] + 0.7 * p[..., (ch + 1) % 3]) + phases[o, ch])
    base = torch.as_tensor(spec["base"], dtype=torch.float64, device=d.device)
    albedo = torch.clamp(base + albedo, 0.05, 0.95)
    green = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=d.device)
    img = torch.where(hit[..., None], albedo, green)
    return img.to(torch.float32), t.to(torch.float32)
