"""One reference-scale frame on the card, end to end (counterpart of
examples/refscale_frame.py).

    python -m gaustar_tpu_torch.refscale.frame [--iters 2000] [--cams 40] [--batch 1] [--out PATH]

The reference's config-2 scale: utils/synthetic.reference_scene (a
100,000-face sphere, 600,000 gaussians) on a ring of `--cams` cameras at
1600x1024 with analytic GT and an 8 cm dent (scenes.reference_rig); the
refine for `--iters` iterations with the SH warmup and the position-lr
schedule (named-group Adam, OptimizationParams(iterations=iters)), in four
timed segments; detection over every camera (twice: first call, steady);
the mesh update run_sequence runs on a change (TSDF fusion from the
orbit and rig views at 8 mm, decimated to 150,000 faces; the surgery over
five AABB pads); the half-budget re-refine on the updated mesh. A failed
update raises. `--cams 160 --iters 2000` is the configuration of the JAX
record REFSCALE160.json, `--batch 4` that of GAUSTAR_REFSCALE_BATCH=4. The
native library and the blend kernels are built before the clock starts
(`build_s`); `steady_mpix_s` counts the batch's pixels.

Cameras are drawn as the JAX runner draws them: one
`rng.integers(0, n_cams, size=(50,))` (or (50, B) with a camera batch) per
50-iteration chunk from `default_rng(0)`, after the draw the JAX runner
spends on its compile. The JAX runner's chunks are always 50 iterations,
so the two agree where a segment (iters / 4) is a multiple of 50.
The record goes to build/refscale/frame.json (`--out`).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.losses import edge_lengths
from gaustar_tpu_torch.refscale import common, scenes
from gaustar_tpu_torch.train import mesh_update, refine, topo_detect
from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn
from gaustar_tpu_torch.train.sequence import _face_colors_to_vertex
from gaustar_tpu_torch.utils.synthetic import reference_scene

INNER = 50  # iterations per camera draw (the JAX runner's device call)
# The JAX script's fusion and surgery arguments (refscale_frame.py:322-337).
FUSION = dict(voxel_size=0.008, sdf_trunc=0.02, max_dim=512, simplify_face_num=150_000)
UPDATE = dict(force_watertight=False)
DETECT = topo_detect.TopoDetectConfig()
FLAG = 0.6  # face weight at which update_mesh_topo cuts
DENT_NEAR = 0.25  # m: a flagged face this near the dent centre counts as on it


def train_frame(params, config, data, raster_cfg, cfg: refine.RefineConfig, iters: int, rng, batch: int = 1,
                label: str = "refine", log=print):
    """`iters` refine iterations in four timed segments (train_frame,
    refscale_frame.py:144-220). Returns (params, record): per segment its
    iterations, wall seconds (host clock, the card synchronised), ms per
    iteration, loss sum and the first iteration of a chunk whose loss sum
    is not finite; the mean and spread of the segments' ms per iteration."""
    dev = params.points.device
    n_cams = data.gt_images.shape[0]
    pts = params.points.detach().cpu().numpy()
    radius = float(np.linalg.norm(pts.max(0) - pts.min(0)) / 2.0)
    lr_fn = make_lr_fn(OptimizationParams(iterations=iters), 10.0 * radius / np.sqrt(config.faces.shape[0]))
    params = sugar.fresh_params(params)
    opt_state = adam_init(params)
    pre = params.sh_dc.detach()[:, 0, :] * 0.0
    unbind_w = torch.zeros(params.scales.shape[0], device=dev)
    cam_shape = (INNER, batch) if batch > 1 else (INNER,)
    rng.integers(0, n_cams, size=cam_shape)  # the draw the JAX runner spends on its compile

    seg_len = max(iters // 4, 1)
    segments = []
    for q in range(4):
        it0 = q * seg_len + 1
        common.sync(dev)
        t0 = time.perf_counter()
        acc, first_nan = 0.0, None
        for s0 in range(0, seg_len, INNER):
            draw = rng.integers(0, n_cams, size=cam_shape)
            chunk = torch.zeros((), device=dev)
            for k in range(min(INNER, seg_len - s0)):
                it = it0 + s0 + k
                cam = [int(c) for c in draw[k]] if batch > 1 else int(draw[k])
                loss, _ = refine.train_step(params, opt_state, lr_fn, config, data, cam, it, cfg, raster_cfg,
                                            refine.sh_deg_at(it, cfg), unbind_w, pre)
                chunk += loss
            a = float(chunk)  # the host read synchronises
            if first_nan is None and not np.isfinite(a):
                first_nan = it0 + s0
            acc += a
        common.sync(dev)
        dt = time.perf_counter() - t0
        segments.append({"iters": seg_len, "wall_s": dt, "ms_per_iter": 1e3 * dt / seg_len, "loss_sum": acc,
                         "first_nonfinite_chunk_it": first_nan})
        log(f"[{label}] segment {q}: {seg_len} iterations, {dt:.2f} s ({1e3 * dt / seg_len:.2f} ms/iter), "
            f"loss sum {acc:.5f}")
    ms = [s["ms_per_iter"] for s in segments]
    return params, {
        "segments": segments,
        "train_wall_s": sum(s["wall_s"] for s in segments),
        "ms_per_iter_mean": float(np.mean(ms)),
        "ms_per_iter_spread_pct": 100.0 * (max(ms) - min(ms)) / max(float(np.mean(ms)), 1e-9),
    }


def re_refine_inputs(update: dict, data, device):
    """(params, config, data) of the re-refine on the updated mesh
    (refscale_frame.py:370-395): init_sugar of the updated mesh with its
    face colours on the vertices and scale clamps of 0.1 / 5 x its mean
    edge; the frame's cameras and GT with fresh margins, edges, adjacency,
    reference edge lengths and update_mesh_with_fusion's reference areas."""
    um = update["updated_mesh"]
    verts = um.verts.astype(np.float32)
    faces = um.faces.astype(np.int32)
    topo = build_topology(faces, len(verts))
    edges = torch.as_tensor(topo.edges, dtype=torch.int64, device=device)
    el = edge_lengths(torch.as_tensor(verts, device=device), edges)
    mean_edge = float(el.mean())
    params, config = sugar.init_sugar(verts, faces, vertex_colors=_face_colors_to_vertex(um),
                                      min_scale=mean_edge * 0.1, max_scale=mean_edge * 5.0, device=device)
    cams = data.cameras
    margins = refine.compute_margins(cams.cx.cpu().numpy(), cams.cy.cpu().numpy(), cams.width, cams.height)
    data2 = refine.FrameData(
        cameras=cams, gt_images=data.gt_images, gt_depths=data.gt_depths,
        margins=torch.as_tensor(margins, dtype=torch.int64, device=device), ref_edge_len=el,
        ref_area=torch.as_tensor(np.asarray(update["new_ref_area"], np.float32), device=device),
        edges=edges, adj_faces=torch.as_tensor(topo.adj_faces, dtype=torch.int64, device=device),
    )
    return params, config, data2


def run(params, config, data, raster_cfg, iters: int, batch: int = 1, log=print) -> dict:
    """The frame (refscale_frame.py:223-427) on the scene's device. Returns
    {"report": the record, "params", "face_w", "update", "re_params"}: the
    refined model, the detection's face weights, update_mesh_with_fusion's
    result and the re-refined model (None without an update)."""
    dev = params.points.device
    n_cams = data.gt_images.shape[0]
    faces = config.faces.cpu().numpy()
    report = {"n_gaussians": int(params.scales.shape[0]), "n_faces": len(faces), "n_cams": n_cams,
              "resolution": [data.cameras.width, data.cameras.height], "iterations": iters, "camera_batch": batch}
    report["build_s"] = common.build_libraries(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    rng = np.random.default_rng(0)
    cfg = refine.RefineConfig(num_iterations=iters, loose_bind_from=iters // 2, do_sh_warmup=True)
    t_frame = time.perf_counter()
    params, report["refine"] = train_frame(params, config, data, raster_cfg, cfg, iters, rng, batch, log=log)

    topo = build_topology(faces, params.points.shape[0])
    walls = []
    for _ in range(2):  # first call, then steady
        face_w, wall = common.clocked(dev, lambda: topo_detect.detect_topo_err(
            params, config, data.cameras, data.gt_depths, topo, raster_cfg, DETECT))
        walls.append(wall)
    flagged = face_w >= FLAG
    centroids = params.points.detach().cpu().numpy()[faces].mean(axis=1)
    near = np.linalg.norm(centroids - scenes.DENT_CENTER, axis=1) < DENT_NEAR
    report.update(detect_first_s=walls[0], detect_s=walls[1], detect_flagged_faces=int(flagged.sum()),
                  detect_flagged_near_dent_share=float(near[flagged].mean()) if flagged.any() else None,
                  detect_observed_fraction=topo_detect.last_telemetry.observed_fraction)
    log(f"detection over {n_cams} cameras: {walls[1]:.2f} s (first call {walls[0]:.2f} s), flagged faces "
        f"{int(flagged.sum())}, within {DENT_NEAR} m of the dent {report['detect_flagged_near_dent_share']}")

    fused, report["fusion_s"] = common.clocked(dev, lambda: mesh_update.extract_mesh_fusion(
        params, config, data.cameras, raster_cfg, **FUSION))
    report["fusion_faces"] = len(fused.faces)
    report["fusion_views"] = mesh_update.last_fusion["views"] * mesh_update.last_fusion["blocks"]
    out, report["update_s"] = common.clocked(dev, lambda: mesh_update.update_mesh_with_fusion(
        params, config, fused, face_w, **UPDATE))
    report["cc_update_num"] = int(out.get("cc_update_num", 0))
    log(f"fusion ({report['fusion_views']} views): {report['fusion_s']:.2f} s, {len(fused.faces)} faces; "
        f"update over the AABB pads: {report['update_s']:.2f} s, "
        f"cc_update_num {report['cc_update_num']}")

    re_params = None
    if report["cc_update_num"] > 0:
        report["updated_faces"] = len(out["updated_mesh"].faces)
        p2, c2, d2 = re_refine_inputs(out, data, dev)
        cfg2 = refine.RefineConfig(num_iterations=iters // 2, edge_iso_from=999_999, loose_bind_from=10**9,
                                   do_sh_warmup=True)
        re_params, report["re_refine"] = train_frame(p2, c2, d2, raster_cfg, cfg2, iters // 2, rng, batch,
                                                     label="re_refine", log=log)
    common.sync(dev)
    report["frame_wall_s"] = time.perf_counter() - t_frame
    if dev.type == "cuda":
        report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    steady = report["refine"]["segments"][-1]["ms_per_iter"]
    report["steady_ms_per_iter"] = steady
    # Pixels a second: an iteration renders `batch` cameras (the JAX
    # script's record, refscale_frame.py:418, counts one).
    report["steady_mpix_s"] = data.cameras.width * data.cameras.height * batch / (steady / 1e3) / 1e6
    return {"report": report, "params": params, "face_w": face_w, "update": out, "re_params": re_params}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--cams", type=int, default=40)
    ap.add_argument("--batch", type=int, default=1, help="cameras averaged per iteration")
    ap.add_argument("--out", default=common.default_out("frame"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    params, config, data, raster_cfg = reference_scene(args.device)
    data = scenes.reference_rig(data, args.cams)
    result = run(params, config, data, raster_cfg, args.iters, args.batch)
    common.write_report(args.out, {**result["report"], **common.device_record(params.points.device)})


if __name__ == "__main__":
    main()
