"""Detection, fusion and the warp at real capture statistics, with the
reference's raw constants (counterpart of examples/refscale_real.py).

    python -m gaustar_tpu_torch.refscale.real [--iters 400] [--cams 32] [--detect-cams 160] [--out PATH]

The capture (scenes.py): a 100,000-face textured ellipsoid body 3.5 m from
a 32-camera rig of two rings at f = 3500 px (about 1 mm/px, ActorsHQ's
footprint); frame 1's GT adds a 12 cm blob; GT images are renders of the
body + blob model (opacity 0.99) composited through imperfect masks with
sensor noise of 1.5/255, GT depths clean mesh z-buffers. The body-only model
is refined against frame 1 for `--iters` iterations; detection runs at the
full rig density (`--detect-cams`, mesh z-buffer GT) under the reference's
mean, the default trim1 and median aggregation, each with precision and
recall of the faces flagged at 0.6 against the analytic truth (faces whose
centre lies within 5 cm of the blob's surface ball), and of the connected
components of more than 80 flagged faces; TSDF fusion at 8 mm / 2 cm, with
its surface distance to the analytic geometry; the flow warp with analytic
flow of a known rigid motion plus 0.6 px of noise, with its motion error.
The record goes to build/refscale/real.json (`--out`). One generator,
`default_rng(7)`, makes every draw, in the script's order.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gaustar_tpu_torch.cameras import stack_cameras
from gaustar_tpu_torch.mesh.topology import build_topology, face_connected_components
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.losses import edge_lengths, face_areas_normals
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.refscale import common, scenes
from gaustar_tpu_torch.tools import warp_mesh
from gaustar_tpu_torch.train import mesh_update, refine, topo_detect
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.synthetic import REF_H, REF_W

N_FACES = 100_000
FLAG = 0.6
CC_MIN_FACES = 80  # the reference's region selection keeps components larger than this
TRUTH_MARGIN = 0.05  # m beyond the blob's radius
GT_OPACITY = 0.99
FLOW_NOISE_PX = 0.6  # RAFT + upsampling residual
# The warp's rigid motion: 1 degree about y through the body's centre, then a shift.
MOVE_ANGLE = np.deg2rad(1.0)
MOVE_SHIFT = np.array([0.005, 0.008, -0.003])
DETECTORS = (("mean (reference_mode)", topo_detect.reference_mode()),
             ("trim1 (default)", topo_detect.TopoDetectConfig()),
             ("median", topo_detect.TopoDetectConfig(aggregate="median")))


def capture(n_cams: int, rng: np.random.Generator, device) -> dict:
    """The N_FACES body, the frame-1 GT model (body + blob, textured,
    opacity GT_OPACITY), the rig and the GT (refscale_real.py:235-266).
    Returns a dict of numpy meshes and colours, `cams`, `gt_images`,
    `gt_depths`, `gt_masks` and `gt_render_s`."""
    body_v, body_f = scenes.ellipsoid_mesh(N_FACES)
    blob_v, blob_f = scenes.blob_mesh()
    body_c = scenes.texture(body_v, rng)
    gt_v = np.concatenate([body_v, blob_v]).astype(np.float32)
    gt_f = np.concatenate([body_f, blob_f + len(body_v)])
    gt_c = np.concatenate([body_c, scenes.texture(blob_v, rng)])
    gt_params, gt_config = sugar.init_sugar(gt_v, gt_f, vertex_colors=gt_c, device=device)
    with torch.no_grad():
        # x / (1 - x) in float64, the log in float32: the JAX script's inverse_sigmoid of a Python float.
        gt_params.densities.fill_(float(torch.log(torch.tensor(GT_OPACITY / (1.0 - GT_OPACITY), dtype=torch.float32))))
    cams = scenes.real_rig(n_cams, REF_W, REF_H, device)
    (imgs, depths, masks), wall = common.clocked(device, lambda: scenes.render_gt(
        gt_params, gt_config, cams, RasterConfig(), rng))
    return {"body_v": body_v, "body_f": body_f, "body_c": body_c, "gt_v": gt_v, "gt_f": gt_f, "cams": cams,
            "gt_images": imgs, "gt_depths": depths, "gt_masks": masks, "gt_render_s": wall}


def refine_body(cap: dict, iters: int, device):
    """The body-only model refined against frame 1's GT (refscale_real.py:
    268-295): (params, config, topology, history)."""
    body_v, body_f = cap["body_v"], cap["body_f"]
    topo = build_topology(body_f, len(body_v))
    v = torch.as_tensor(body_v, device=device)
    edges = torch.as_tensor(topo.edges, dtype=torch.int64, device=device)
    el = edge_lengths(v, edges)
    area, _ = face_areas_normals(v, torch.as_tensor(body_f, dtype=torch.int64, device=device))
    mean_edge = float(el.mean())
    params, config = sugar.init_sugar(body_v, body_f, vertex_colors=cap["body_c"], min_scale=mean_edge * 0.1,
                                      max_scale=mean_edge * 5.0, device=device)
    batch = stack_cameras(cap["cams"])
    margins = refine.compute_margins(batch.cx.cpu().numpy(), batch.cy.cpu().numpy(), batch.width, batch.height)
    data = refine.FrameData(
        cameras=batch, gt_images=torch.as_tensor(cap["gt_images"], device=device),
        gt_depths=torch.as_tensor(cap["gt_depths"], device=device),
        margins=torch.as_tensor(margins, dtype=torch.int64, device=device), ref_edge_len=el, ref_area=area,
        edges=edges, adj_faces=torch.as_tensor(topo.adj_faces, dtype=torch.int64, device=device))
    data = refine.with_face_edge_tables(data, body_f)
    cfg = refine.RefineConfig(num_iterations=iters, loose_bind_from=10**9, do_sh_warmup=True)
    params, config, history = refine.refine_frame(params, config, data, cfg, RasterConfig())
    return params, config, topo, history


def changed_faces(body_v, body_f) -> np.ndarray:
    """The analytic truth: body faces whose centre lies within TRUTH_MARGIN
    of the blob's surface."""
    centers = body_v[body_f].mean(axis=1)
    return np.linalg.norm(centers - scenes.BLOB_C[None], axis=1) < (scenes.BLOB_R + TRUTH_MARGIN)


def cc_select(flag: np.ndarray, faces: np.ndarray, adj_faces: np.ndarray) -> np.ndarray:
    """The reference's region selection (refined_mesh.py:516-530): the
    flagged faces in connected components (over shared edges between
    flagged faces) of more than CC_MIN_FACES faces."""
    labels = face_connected_components(faces, adj_faces[flag[adj_faces[:, 0]] & flag[adj_faces[:, 1]]])
    sizes = np.bincount(labels[flag], minlength=labels.max() + 1)
    return flag & (sizes[labels] > CC_MIN_FACES)


def precision_recall(flag: np.ndarray, changed: np.ndarray) -> dict:
    tp = float((flag & changed).sum())
    return {"flagged": int(flag.sum()), "precision": tp / max(int(flag.sum()), 1),
            "recall": tp / max(int(changed.sum()), 1)}


def detection(params, config, topo, det_cams, det_depths, changed, log=print) -> dict:
    """Each of DETECTORS over the detection rig: precision and recall at
    FLAG and of the cc-selected faces, coverage, observed fraction, wall."""
    dev = params.points.device
    batch = stack_cameras(det_cams)
    faces, adj = config.faces.cpu().numpy(), np.asarray(topo.adj_faces)
    rows = {}
    for label, dcfg in DETECTORS:
        fw, wall = common.clocked(dev, lambda: topo_detect.detect_topo_err(
            params, config, batch, det_depths, topo, RasterConfig(), dcfg))
        tel = topo_detect.last_telemetry
        flag = fw >= FLAG
        rows[label] = {"threshold_0.6": precision_recall(flag, changed),
                       "cc_selected": precision_recall(cc_select(flag, faces, adj), changed),
                       "coverage_mean": float(tel.coverage_per_cam.mean()),
                       "observed_fraction": tel.observed_fraction, "wall_s": wall}
        log(f"detection {label}: {rows[label]}")
    return rows


def fusion(params, config, cams, device) -> dict:
    """TSDF fusion from the rig alone at 8 mm / 2 cm, and the fused
    vertices' distance to the analytic body + blob."""
    fused, wall = common.clocked(device, lambda: mesh_update.extract_mesh_fusion(
        params, config, stack_cameras(cams), RasterConfig(), voxel_size=0.008, sdf_trunc=0.02, depth_trunc=6.0,
        use_orbit_cameras=False))
    lo, ub = scenes.surface_distance(np.asarray(fused.verts))
    return {"wall_s": wall, "verts": len(fused.verts), "faces": len(fused.faces),
            "views": mesh_update.last_fusion["views"] * mesh_update.last_fusion["blocks"],
            "surface_rms_mm_lb": 1e3 * float(np.sqrt((lo**2).mean())),
            "surface_p95_mm_ub": 1e3 * float(np.percentile(ub, 95))}


def move(p):
    """The warp's rigid motion of world points [N, 3]."""
    c, s = np.cos(MOVE_ANGLE), np.sin(MOVE_ANGLE)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    return (p - scenes.BODY_C) @ rot.T + scenes.BODY_C + MOVE_SHIFT


def warp(body_v, body_f, det_cams, rng: np.random.Generator) -> dict:
    """The body at rest -> moved (refscale_real.py:339-408): per detection
    camera the two mesh z-buffers and the analytic full-resolution flow of
    the motion, (row, col) order, plus FLOW_NOISE_PX of noise (backward
    flow its negative); warp_mesh_using_flow with the raw WarpConfig; the
    warped vertices' error against the true motion."""
    flows_f, flows_b, depths0, depths1 = [], [], [], []
    moved = move(body_v).astype(np.float32)
    for cam in det_cams:
        view = cam.view.cpu().numpy().astype(np.float64)
        focal, w, h = float(cam.fx), cam.width, cam.height
        d0 = scenes.mesh_depth(body_v, body_f, cam)[0]
        depths0.append(d0)
        depths1.append(scenes.mesh_depth(moved, body_f, cam)[0])
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
        d0 = d0.astype(np.float64)
        ok = d0 < scenes.REAL_MAX_DEPTH
        pts_l = np.stack([(xs - w / 2) / focal * d0, (ys - h / 2) / focal * d0, d0], -1).reshape(-1, 3)
        loc2 = move((pts_l - view[:3, 3]) @ view[:3, :3]) @ view[:3, :3].T + view[:3, 3]
        px2 = loc2[:, 0] / loc2[:, 2] * focal + w / 2
        py2 = loc2[:, 1] / loc2[:, 2] * focal + h / 2
        fl = np.stack([py2.reshape(ys.shape) - ys, px2.reshape(xs.shape) - xs], -1)
        fl = np.where(ok[..., None], fl, 0.0)
        fl += rng.normal(0, FLOW_NOISE_PX, fl.shape)
        flows_f.append(fl.astype(np.float32))
        flows_b.append((-fl).astype(np.float32))
    warped, _, observed = warp_mesh.warp_mesh_using_flow(
        body_v.astype(np.float64), body_f, scenes.camera_dict(det_cams), flows_f, flows_b, depths0, depths1,
        warp_mesh.WarpConfig())
    err = np.linalg.norm(warped - move(body_v), axis=1)
    true = np.linalg.norm(move(body_v) - body_v, axis=1)
    return {"observed_fraction": float(np.mean(observed)), "motion_rms_mm": 1e3 * float(np.sqrt((err**2).mean())),
            "motion_p95_mm": 1e3 * float(np.percentile(err, 95)),
            "true_motion_rms_mm": 1e3 * float(np.sqrt((true**2).mean())), **warp_mesh.last_warp}


def detection_rig(cap: dict, n_cams: int, device):
    """(cameras, GT depths [C, H, W]) of the detection rig: the frame-1 GT
    mesh's z-buffers."""
    cams = scenes.real_rig(n_cams, REF_W, REF_H, device)
    return cams, np.stack([scenes.mesh_depth(cap["gt_v"], cap["gt_f"], c)[0] for c in cams])


def run(iters: int = 400, n_cams: int = 32, detect_cams: int = 160, device="cuda", log=print) -> dict:
    """The whole capture, in the script's order. Returns the record."""
    dev = resolve_device(device)
    rng = np.random.default_rng(7)
    focal = scenes.real_focal(REF_W)
    report = {"config": {"cams": n_cams, "detect_cams": detect_cams, "res": [REF_W, REF_H], "focal_px": focal,
                         "faces": N_FACES, "footprint_mm_per_px": scenes.REAL_DIST / focal * 1e3, "iters": iters}}
    cap = capture(n_cams, rng, dev)
    report["gt_render_s"] = cap["gt_render_s"]
    (params, config, topo, hist), report["refine_s"] = common.clocked(dev, lambda: refine_body(cap, iters, dev))
    report["refine_final_loss"] = hist[-1]["loss"] if hist else None
    log(f"refine {iters} iterations: {report['refine_s']:.1f} s, final loss {report['refine_final_loss']}")
    (det_cams, det_depths), report["detect_gt_depth_s"] = common.clocked(
        dev, lambda: detection_rig(cap, detect_cams, dev))
    report["detection"] = detection(params, config, topo, det_cams, det_depths,
                                    changed_faces(cap["body_v"], cap["body_f"]), log)
    report["fusion"] = fusion(params, config, cap["cams"], dev)
    log(f"fusion: {report['fusion']}")
    report["warp"], report["warp_s"] = common.clocked(dev, lambda: warp(cap["body_v"], cap["body_f"], det_cams, rng))
    log(f"warp: {report['warp']}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--cams", type=int, default=32, help="refine and fusion rig")
    ap.add_argument("--detect-cams", type=int, default=160, help="detection and warp rig")
    ap.add_argument("--out", default=common.default_out("real"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    report = run(args.iters, args.cams, args.detect_cams, device=dev)
    common.write_report(args.out, {**report, **common.device_record(dev)})


if __name__ == "__main__":
    main()
