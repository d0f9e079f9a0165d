"""The initial-mesh field at the reference's scale (counterpart of
examples/refscale_field_init.py).

    python -m gaustar_tpu_torch.refscale.field_init [--iters 2000] [--grid 512] [--rays 2048] [--cams 40]
                                                    [--out PATH] [--device cuda]

The HumanRF chain (run.py + trainer.py:630-752) at the reference's numbers:
40 ring cameras at 1600x1024 see an analytic sphere of radius 0.6 m (GT
colour 0.6 on the sphere, 0 off it, masks where a pixel's ray meets it);
occupancy carving from the masks at 128^3, occupancy-tightened ray sampling
and hash-grid training for `--iters` iterations of `--rays` rays; a density
probe sets the amplitude-relative iso level, a quarter of the density
inside the sphere clipped to [1, 10]; then the `--grid`^3 density grid
masked by the occupancy, the iso surface, the connected-component filter,
10 Laplacian smoothing rounds and the decimation to 100,000 faces. The
record (the keys of the JAX repository's FIELD_INIT.json, the stage times,
the mesh's centre error and radius against the true 0.6 m, peak memory and
the card) goes to build/refscale/field_init.json (`--out`).
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from gaustar_tpu_torch.models import neural_field as nf
from gaustar_tpu_torch.refscale import common, scenes
from gaustar_tpu_torch.train import init_mesh
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.synthetic import ring_cameras

W, H = 1600, 1024
FOCAL = 1600.0
N_CAMS = 40
CENTER = np.array([0.0, 0.0, 4.0])
RADIUS = 0.6
AABB = ((-0.8, -0.8, 3.2), (0.8, 0.8, 4.8))
ISO_CAP = 10.0
OCCUPANCY_RES = 128
TARGET_FACES = 100_000


def analytic_views(cams) -> tuple[np.ndarray, np.ndarray]:
    """(rgb [C, H, W, 3], mask [C, H, W]) float32 of the analytic sphere:
    0.6 where a pixel's ray meets it (refscale_field_init.py:43-60)."""
    rgbs, masks = [], []
    for cam in cams:
        _, hit, _, _ = scenes.ray_sphere(cam.view.cpu().numpy(), float(cam.fx), float(cam.fy), cam.width,
                                         cam.height, CENTER, RADIUS, miss=0.0)
        rgbs.append(np.where(hit[..., None], 0.6, 0.0).astype(np.float32))
        masks.append(hit.astype(np.float32))
    return np.stack(rgbs), np.stack(masks)


def density_probe(field, field_cfg) -> np.ndarray:
    """The trained density at the centre, halfway out, on the surface and
    half a radius outside, along +x."""
    probe = np.stack([CENTER, CENTER + [0.5 * RADIUS, 0, 0], CENTER + [RADIUS, 0, 0],
                      CENTER + [1.5 * RADIUS, 0, 0]]).astype(np.float32)
    with torch.no_grad():
        return nf.query_density(field, torch.as_tensor(probe, device=field.tables.device), field_cfg)[0].cpu().numpy()


def iso_level(inside_density: float) -> float:
    """A quarter of the interior density, clipped to [1, ISO_CAP]
    (refscale_field_init.py:110-113)."""
    return float(np.clip(0.25 * inside_density, 1.0, ISO_CAP))


def run(iters: int = 2000, grid: int = 512, rays: int = 2048, n_cams: int = N_CAMS, device="cuda",
        log=print) -> tuple[dict, dict]:
    """The whole chain on the rig of W, H, FOCAL. Returns (record,
    {"field", "field_cfg", "occupancy", "mesh", "cams"})."""
    dev = resolve_device(device)
    report = {"n_cams": n_cams, "resolution": [W, H], "grid_res": grid, "occupancy_res": OCCUPANCY_RES,
              "target_faces": TARGET_FACES, "iterations": iters, "rays_per_batch": rays}
    cams = ring_cameras(n_cams, w=W, h=H, focal=FOCAL, device=dev)
    t0 = time.perf_counter()
    rgbs, masks = analytic_views(cams)
    report["gt_build_s"] = time.perf_counter() - t0

    field_cfg = nf.FieldConfig(aabb_min=AABB[0], aabb_max=AABB[1])
    mcfg = init_mesh.InitMeshConfig(iterations=iters, grid_res=grid, occupancy_res=OCCUPANCY_RES,
                                    target_faces=TARGET_FACES, rays_per_batch=rays, iso_level=ISO_CAP)
    losses = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    (field, field_cfg, occ), report["train_s"] = common.clocked(dev, lambda: init_mesh.train_field(
        cams, rgbs, masks, mcfg, field_cfg, log_fn=lambda e: losses.append(e["loss"])))
    tr = init_mesh.last_train
    report["occupancy_fill_pct"] = float(occ.float().mean()) * 100.0
    report["occupancy_ms"] = tr["occupancy_ms"]
    report["step_ms_median"] = statistics.median(tr["step_ms"][3:] or tr["step_ms"])
    report["losses"] = losses
    if dev.type == "cuda":
        report["train_peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    dens = density_probe(field, field_cfg)
    iso = iso_level(float(dens[1]))
    report["density_probe"] = {"center": float(dens[0]), "inside": float(dens[1]), "surface": float(dens[2]),
                               "outside": float(dens[3]), "iso_level": iso}
    log(f"field training ({iters} iterations of {rays} rays, occupancy carving included): {report['train_s']:.1f} s, "
        f"median step {report['step_ms_median']:.2f} ms, occupancy fill {report['occupancy_fill_pct']:.2f}%; "
        f"density probe {report['density_probe']}")

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mesh, report["extract_s"] = common.clocked(dev, lambda: init_mesh.extract_init_mesh(
        field, field_cfg, dataclasses.replace(mcfg, iso_level=iso), occupancy=occ))
    report["extract_ms"] = dict(init_mesh.last_extract)
    if dev.type == "cuda":
        report["extract_peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    report["mesh_faces"] = int(len(mesh.faces))
    report["mesh_verts"] = int(len(mesh.verts))
    if len(mesh.verts):
        c = mesh.verts.mean(axis=0)
        r = np.linalg.norm(mesh.verts - c, axis=1)
        report["center_err_m"] = float(np.linalg.norm(c - CENTER))
        report["radius_mean_m"] = float(r.mean())
        report["radius_std_m"] = float(r.std())
        log(f"extract {grid}^3 -> {len(mesh.faces)} faces in {report['extract_s']:.1f} s; centre error "
            f"{report['center_err_m']:.4f} m, radius {r.mean():.4f} +- {r.std():.4f} m (true {RADIUS})")
    report["backend"] = dev.type
    return report, {"field": field, "field_cfg": field_cfg, "occupancy": occ, "mesh": mesh, "cams": cams}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--grid", type=int, default=512, help="density grid resolution of the extraction")
    ap.add_argument("--rays", type=int, default=2048, help="rays per training batch")
    ap.add_argument("--cams", type=int, default=N_CAMS)
    ap.add_argument("--out", default=common.default_out("field_init"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report, _ = run(args.iters, args.grid, args.rays, args.cams, device=dev)
    common.write_report(args.out, {**report, **common.device_record(dev)})


if __name__ == "__main__":
    main()
