"""Field training throughput against the ray batch (counterpart of
examples/profile_field_batch.py).

    python -m gaustar_tpu_torch.refscale.field_batch [--batches 2048,8192,16384,32768] [--out PATH]
                                                     [--device cuda]

One training step of the hash-grid field (render_rays, the photometric and
mask losses, Adam) at field_init's FieldConfig, on synthetic rays from the
origin into the +z half space with random GT, for each batch size in turn:
one warm-up step, then STEPS steps between CUDA events; ms a step, rays
a second and peak memory. A batch that runs out of device memory is
recorded as such and the sweep goes on, since finding that ceiling is the
point; any other error ends the run. The record goes to
build/refscale/field_batch.json (`--out`).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gaustar_tpu_torch.models import neural_field as nf
from gaustar_tpu_torch.refscale import common
from gaustar_tpu_torch.refscale.field_init import AABB
from gaustar_tpu_torch.utils.general import device_ms, resolve_device

BATCHES = (2048, 8192, 16384, 32768)
STEPS = 20


def synthetic_rays(n: int, rng: np.random.Generator, dev: torch.device):
    """(origins, unit directions, GT rgb, GT mask) of n rays, drawn as
    profile_field_batch.py:62-67 draws them."""
    o = np.zeros((n, 3), np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:, 2] = np.abs(d[:, 2]) + 1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    gt_rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    gt_mask = (rng.uniform(size=(n,)) > 0.5).astype(np.float32)
    return tuple(torch.as_tensor(a, device=dev) for a in (o, d, gt_rgb, gt_mask))


def batch_point(n: int, rng: np.random.Generator, dev: torch.device) -> dict:
    """One batch size's point of the curve, from a fresh field (seed 0)."""
    field_cfg = nf.FieldConfig(aabb_min=AABB[0], aabb_max=AABB[1])
    field = nf.init_field(field_cfg, 0, dev)
    opt = torch.optim.Adam(field.parameters(), lr=1e-2, betas=(0.9, 0.99), eps=1e-15)
    o, d, gt_rgb, gt_mask = synthetic_rays(n, rng, dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def step():
        rgb, alpha, _ = nf.render_rays(field, o, d, field_cfg, gen)
        loss = ((rgb - gt_rgb) ** 2 * gt_mask[:, None]).mean() + 0.1 * ((alpha - gt_mask) ** 2).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return loss

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loss, first_ms = device_ms(dev, step)
    _, ms = device_ms(dev, lambda: [step() for _ in range(STEPS)])
    point = {"rays_per_batch": n, "ms_per_step": ms / STEPS, "rays_per_s": n * STEPS / (ms * 1e-3),
             "first_step_ms": first_ms, "loss_finite": bool(torch.isfinite(loss))}
    if dev.type == "cuda":
        point["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return point


def run(batches=BATCHES, device="cuda", log=print) -> dict:
    """The sweep. Returns the record."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    report = {"config": "refscale field_init's FieldConfig", "n_samples_per_ray": nf.FieldConfig().n_samples,
              "steps": STEPS, "results": [], "backend": dev.type}
    for n in batches:
        try:
            point = batch_point(n, rng, dev)
        except torch.cuda.OutOfMemoryError:
            point = {"rays_per_batch": n, "error": "out of memory"}
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        report["results"].append(point)
        log(f"batch {n}: {point}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batches", default=",".join(map(str, BATCHES)), help="comma-separated rays per batch")
    ap.add_argument("--out", default=common.default_out("field_batch"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report = run([int(b) for b in args.batches.split(",")], device=dev)
    common.write_report(args.out, {**report, **common.device_record(dev)})


if __name__ == "__main__":
    main()
