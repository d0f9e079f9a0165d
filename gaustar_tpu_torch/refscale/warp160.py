"""The flow warp at the full ActorsHQ rig's scale: the 100,000-face sphere
seen by 160 cameras at 1600x1024 (counterpart of
examples/refscale_warp160.py).

    python -m gaustar_tpu_torch.refscale.warp160 [--cams 160] [--out PATH]

A five-row multi-elevation rig 2.5 m from the sphere at f = 2000 px (about
1.25 mm/px); the sphere moves rigidly by 2 cm along x between the frames.
Per camera, the analytic depth of both frames and the exact flow of the
visible surface, (row, col) order, made at half resolution and resized back
to full resolution as the dataset loader does with RAFT's flows (the GT is
built on the host, cameras in parallel threads). The port's
warp_mesh_using_flow, with the depth-edge scale 1000 (refscale_warp160.py:
86-94: a sphere's silhouette step, the edge map's normaliser, is about 12x
smaller than a real capture's), warps the sphere; the record holds the
observed fraction, the motion error against the known shift and the host
time per camera, and goes to build/refscale/warp160.json (`--out`).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from gaustar_tpu_torch.mesh.primitives import uv_sphere
from gaustar_tpu_torch.refscale import common, scenes
from gaustar_tpu_torch.tools import warp_mesh
from gaustar_tpu_torch.tools.geometry import pad_and_resize_flow
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.synthetic import REF_H, REF_LAT, REF_LON, REF_W, rig_cameras

EDGE_SCALAR = 1000.0
ROWS = 5


def camera_gt(view):
    """(forward flow, backward flow, depth at t, depth at t+1) of one camera
    (refscale_warp160.py:66-85)."""
    focal, w, h = scenes.WARP_FOCAL, REF_W, REF_H
    d0, hit, (vx, vy) = scenes.sphere_depth(view, focal, focal, w, h, scenes.CENTER)
    d1, _, _ = scenes.sphere_depth(view, focal, focal, w, h, scenes.CENTER + scenes.WARP_SHIFT)
    s_cam = view[:3, :3] @ scenes.WARP_SHIFT  # camera-space motion
    z1 = d0 + s_cam[2]
    fx1 = (vx * d0 + s_cam[0]) / np.maximum(z1, 1e-6) * focal
    fy1 = (vy * d0 + s_cam[1]) / np.maximum(z1, 1e-6) * focal
    fw = np.stack([fy1 - vy * focal, fx1 - vx * focal], axis=-1)
    fw = np.where(hit[..., None], fw, 0.0).astype(np.float32)
    return (pad_and_resize_flow(fw[::2, ::2] * 0.5, None, (h, w)), pad_and_resize_flow(-fw[::2, ::2] * 0.5, None, (h, w)),
            d0, d1)


def build(n_cams: int):
    """(camera dict, verts, faces, [per camera (flow_f, flow_b, depth_t,
    depth_t1)]) on the host, cameras in parallel threads."""
    cams = rig_cameras(n_cams, rows=ROWS, dist=scenes.WARP_DIST, w=REF_W, h=REF_H, focal=scenes.WARP_FOCAL,
                       device="cpu")
    cmr = {"intrinsics": np.stack([np.diag([scenes.WARP_FOCAL, scenes.WARP_FOCAL, 1.0])] * n_cams),
           "extrinsics": np.stack([c.view.numpy().astype(np.float64) for c in cams]),
           "shape": np.stack([[REF_H, REF_W]] * n_cams)}
    verts, faces = uv_sphere(REF_LAT, REF_LON, radius=scenes.RADIUS, center=tuple(scenes.CENTER))
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        gts = list(pool.map(camera_gt, cmr["extrinsics"]))
    return cmr, verts, faces, gts


def run(n_cams: int = 160, log=print) -> dict:
    """Build the GT, warp, and measure. Returns (record, warped verts)."""
    t0 = time.perf_counter()
    cmr, verts, faces, gts = build(n_cams)
    build_s = time.perf_counter() - t0
    flows_f, flows_b, depths_t, depths_t1 = (list(x) for x in zip(*gts))
    cfg = dataclasses.replace(warp_mesh.WarpConfig(), edge_scalar=EDGE_SCALAR)
    t0 = time.perf_counter()
    warped, _, observed = warp_mesh.warp_mesh_using_flow(verts.astype(np.float64), faces, cmr, flows_f, flows_b,
                                                         depths_t, depths_t1, cfg)
    warp_s = time.perf_counter() - t0
    err = np.linalg.norm((warped - verts) - scenes.WARP_SHIFT, axis=1)
    report = {"n_verts": len(verts), "n_faces": len(faces), "n_cams": n_cams, "resolution": [REF_W, REF_H],
              "gt_build_s": build_s, "warp_s": warp_s, "warp_s_per_cam": warp_s / n_cams,
              "observe_ms": warp_mesh.last_warp["observe_ms"], "average_ms": warp_mesh.last_warp["average_ms"],
              "observed_vert_pct": 100.0 * float(np.mean(observed)),
              "motion_err_mean_mm": 1e3 * float(err.mean()), "motion_err_p95_mm": 1e3 * float(np.quantile(err, 0.95)),
              "true_motion_mm": 1e3 * float(np.linalg.norm(scenes.WARP_SHIFT))}
    log(f"warp160: {report}")
    return report, warped


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams", type=int, default=160)
    ap.add_argument("--out", default=common.default_out("warp160"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report, _ = run(args.cams)
    common.write_report(args.out, {**report, **common.device_record(dev)})


if __name__ == "__main__":
    main()
