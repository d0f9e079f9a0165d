"""The benchmark's inputs, made from a configuration file and a seed: the
trainee mesh and its vertex colours, the camera rig and the ground truth.

Everything is the benchmark's own code, so that the program cannot move its
inputs. The mesh and the GT are made on the device; the GT kind named in
the configuration (`gt.kind`) is the module `benchmark/gt/<kind>.py`, whose
`make(spec, rig, rays, gen)` returns (images [C, H, W, 3], depths [C, H, W]).
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import math
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GT_CHUNK = 8  # cameras whose rays are made at once


@dataclasses.dataclass
class Rig:
    w2c: np.ndarray  # [C, 4, 4] float64 world-to-camera
    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    width: int
    height: int

    @property
    def n(self) -> int:
        return self.w2c.shape[0]


@dataclasses.dataclass
class Scene:
    verts: torch.Tensor  # [V, 3] float32
    faces: torch.Tensor  # [F, 3] int64
    colors: torch.Tensor  # [V, 3] float32, the trainee's initial vertex colours
    rig: Rig
    gt_images: torch.Tensor  # [C, H, W, 3] float32
    gt_depths: torch.Tensor  # [C, H, W] float32


def load_json(kind: str, name: str) -> dict:
    """benchmark/<kind>/<name>.json."""
    with open(ROOT / kind / f"{name}.json") as f:
        return json.load(f)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    return gen


def uv_ellipsoid(n_lat: int, n_lon: int, center, semi_axes, device):
    """(verts [V, 3] float32, faces [F, 3] int64) of a latitude-longitude
    ellipsoid with 2 n_lon (n_lat - 1) faces, poles on the y axis, wound
    outward."""
    f64 = dict(dtype=torch.float64, device=device)
    theta = math.pi * torch.arange(1, n_lat, **f64) / n_lat
    phi = 2.0 * math.pi * torch.arange(n_lon, **f64) / n_lon
    st, ct = torch.sin(theta)[:, None], torch.cos(theta)[:, None]
    rings = torch.stack([st * torch.cos(phi), ct.expand(-1, n_lon), st * torch.sin(phi)], -1).reshape(-1, 3)
    unit = torch.cat([torch.tensor([[0.0, 1.0, 0.0]], **f64), rings, torch.tensor([[0.0, -1.0, 0.0]], **f64)])
    verts = unit * torch.tensor(semi_axes, **f64) + torch.tensor(center, **f64)

    rows = n_lat - 1
    c = torch.arange(n_lon, device=device)
    nxt = (c + 1) % n_lon
    north = torch.stack([torch.zeros_like(c), 1 + c, 1 + nxt], -1)
    r = torch.arange(rows - 1, device=device)[:, None]
    a, b = 1 + r * n_lon + c, 1 + r * n_lon + nxt
    d, e = a + n_lon, b + n_lon
    strips = torch.stack([torch.stack([a, d, b], -1), torch.stack([b, d, e], -1)], 2).reshape(-1, 3)
    south_id = verts.shape[0] - 1
    last = 1 + (rows - 1) * n_lon
    south = torch.stack([torch.full_like(c, south_id), last + nxt, last + c], -1)
    faces = torch.cat([north, strips, south]).flip(1).contiguous()
    return verts.to(torch.float32), faces


def rig(spec: dict) -> Rig:
    """Rings of cameras about spec["center"] at spec["distance"], each
    {"cameras", "elevation" (rad), "offset" (of a step)}, looking at the
    centre with image y down; principal points at the image centres."""
    center = np.asarray(spec["center"], np.float64)
    w2cs = []
    for ring in spec["rings"]:
        n, elev = ring["cameras"], ring["elevation"]
        for i in range(n):
            a = 2.0 * np.pi * (i + ring["offset"]) / n
            eye = center + spec["distance"] * np.array([np.sin(a) * np.cos(elev), np.sin(elev),
                                                        -np.cos(a) * np.cos(elev)])
            fwd = center - eye
            fwd /= np.linalg.norm(fwd)
            right = np.cross(np.array([0.0, -1.0, 0.0]), fwd)
            right /= np.linalg.norm(right)
            rot = np.stack([right, np.cross(fwd, right), fwd])
            w2c = np.eye(4)
            w2c[:3, :3] = rot
            w2c[:3, 3] = -rot @ eye
            w2cs.append(w2c)
    c = len(w2cs)
    w, h, f = spec["width"], spec["height"], float(spec["focal"])
    return Rig(np.stack(w2cs), np.full(c, f), np.full(c, f), np.full(c, w / 2.0), np.full(c, h / 2.0), w, h)


def rays(r: Rig, cams, device):
    """(eye [B, 1, 1, 3], dir [B, H, W, 3]) in float64 for the cameras `cams`:
    each pixel's ray (x - W / 2) / fx, (y - H / 2) / fy, 1 in the camera, so
    that a ray's parameter is the view z-depth."""
    f64 = dict(dtype=torch.float64, device=device)
    w2c = torch.as_tensor(r.w2c[cams], **f64)
    rot, t = w2c[:, :3, :3], w2c[:, :3, 3]
    ys, xs = torch.meshgrid(torch.arange(r.height, **f64), torch.arange(r.width, **f64), indexing="ij")
    fx = torch.as_tensor(r.fx[cams], **f64)[:, None, None]
    fy = torch.as_tensor(r.fy[cams], **f64)[:, None, None]
    cx = torch.as_tensor(r.cx[cams], **f64)[:, None, None]
    cy = torch.as_tensor(r.cy[cams], **f64)[:, None, None]
    local = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs - cx)], -1)  # [B, H, W, 3]
    world = torch.einsum("bhwk,bkj->bhwj", local, rot)  # R^T v
    eye = -torch.einsum("bkj,bk->bj", rot, t)
    return eye[:, None, None, :], world


def hit_ellipsoid(eye, d, center, semi_axes, miss: float):
    """(t, hit): the nearest ray parameter where eye + t d meets the
    ellipsoid, `miss` where it does not."""
    dev = d.device
    c = torch.as_tensor(center, dtype=torch.float64, device=dev)
    s = torch.as_tensor(semi_axes, dtype=torch.float64, device=dev)
    o, dd = (eye - c) / s, d / s
    a = (dd * dd).sum(-1)
    b = 2.0 * (o * dd).sum(-1)
    c0 = (o * o).sum(-1) - 1.0
    disc = b * b - 4.0 * a * c0
    hit = disc > 0
    t = torch.where(hit, (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / (2.0 * a), torch.full_like(a, miss))
    return t, hit


def make_scene(config: dict, seed: int, device) -> Scene:
    """The inputs of one run: the mesh, the trainee's vertex colours (uniform
    in config["colors"] from the seed), the rig and the GT."""
    gen = generator(seed, device)
    mesh = config["mesh"]
    verts, faces = uv_ellipsoid(mesh["n_lat"], mesh["n_lon"], mesh["center"], mesh["semi_axes"], device)
    lo, hi = config["colors"]
    colors = lo + (hi - lo) * torch.rand(verts.shape, generator=gen, device=device)
    r = rig(config["rig"])
    gt = importlib.import_module(f"benchmark.gt.{config['gt']['kind']}")
    images = torch.empty((r.n, r.height, r.width, 3), dtype=torch.float32, device=device)
    depths = torch.empty((r.n, r.height, r.width), dtype=torch.float32, device=device)
    state = gt.prepare(config["gt"], gen, device)
    for c0 in range(0, r.n, GT_CHUNK):
        cams = np.arange(c0, min(c0 + GT_CHUNK, r.n))
        eye, d = rays(r, cams, device)
        img, depth = gt.shade(config["gt"], state, eye, d)
        images[cams[0]:cams[-1] + 1] = img
        depths[cams[0]:cams[-1] + 1] = depth
    return Scene(verts, faces, colors, r, images, depths)


def camera_schedule(seed: int, n_cams: int, per_step: int):
    """The cameras of each step, drawn uniformly over the rig from the seed:
    consecutive permutations of the rig, `per_step` indices a step, so that a
    step's cameras differ and the first n_cams // per_step steps see every
    camera at most once. Yields lists."""
    rng = np.random.default_rng(int(seed))
    queue: list[int] = []
    while True:
        while len(queue) < per_step:
            queue.extend(int(i) for i in rng.permutation(n_cams))
        step, queue = queue[:per_step], queue[per_step:]
        yield step
