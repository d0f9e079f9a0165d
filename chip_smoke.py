#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (gaustar_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card

Phases, one line of output each (or a few):
  1 card     the device name and `nvidia-smi` name / power limit;
  2 build    nvcc builds of the blend kernels and the nvJPEG binding
             (csrc/*.cu, one nvcc each, all at once), with seconds and the
             -Xptxas -v register / shared-memory report;
    demand   the full-width scene's (gaussian, tile) pairs and non-empty
             tiles at initialisation, per camera; their maximum must equal
             the JAX package's count on the CPU exactly;
  3 fwd      the forward kernel against blend_fwd_plain, channels 3 and 4, on
             a 256x256 scene of 20k gaussians and on the 64 busiest tiles of
             the full-width scene (4 channels also with every opacity at
             0.9): colour / final T within 1e-4, n_contrib and the done flag
             exact;
  4 bwd      the backward kernel against blend_bwd_plain on the same inputs
             and a seeded cotangent: rtol 1e-3, atol 1e-3 x the field's
             inf-norm;
  5 slice    the refine step: a small frame on the card against the same
             frame on the CPU (plain versions), then refine_frame at full
             width (600k gaussians, 1600x1024, 4 cameras) for ITERS
             iterations, with finite losses and one launch of each kernel
             per iteration, then one 4-camera batch step;
  6 kernels  each kernel's time (CUDA events) at full width, at the initial
             opacities and at 0.9 and on the longest tile alone, the CUDA
             kernels it launches and its scratch bytes, its plain version's
             time and its bound, printed as one JSON line;
  7 topo     the topology event on utils/synthetic.topology_scene (the
             600k-gaussian sphere, 8 ring cameras at 1600x1024, a blob in the
             GT): first the forward kernel under no_grad against
             blend_fwd_plain on the 64 busiest tiles of a solid-surface
             detection view and of a fusion view; then refine_one_frame for
             TOPO_ITERS iterations (detection and loose bind at half) and
             update_frame_topology (fusion from 60 orbit views + the rig,
             detection, surgery, recolour, re-refine for TOPO_ITERS / 2). It
             fails unless the model loose-bound, the surgery grafted at least
             one component, the tracked faces stay on the sphere, the graft
             reaches toward the blob, every loss is finite and each kernel
             launched exactly as often as the event implies;
    native   the native mesh library (g++ build of native/meshops.cpp) on the
             event's fused mesh: quadric decimation to NATIVE_FACES faces and
             NATIVE_SMOOTH_ITERS Laplacian iterations, host ms of each; fails
             unless the face count is in [0.9, 1] x NATIVE_FACES, every vertex
             is finite and the decimated vertices lie within a voxel (median
             distance to the fused vertices, scipy KD-tree);
  8 seq      the sequence: utils/synthetic.sequence_dataset writes a two-frame
             dataset in the reference layout (the full-width sphere, moved by
             SEQ_DX along x in frame 1; 8 ring cameras at 1600x1024; JPEG
             frames through nvJPEG, PNG masks, depth npz, analytic flows at
             half resolution) to a temporary directory, then run_sequence
             (frames 0-1, SEQ_ITERS iterations each, no mesh update, the
             warp at utils/synthetic.SEQ_WARP) and
             render_sequence (RGB and depth per camera and frame). Per frame
             it prints the JPEG decodes (CUDA events), the refine's wall and
             median iteration, the warp's host stages and observed fraction,
             the exports; then render_sequence's time and peak memory. It
             fails unless every file of the contract exists, the frame-1
             checkpoint loads equal to the final parameters, the warp moves
             the mesh by 0.5-1.5 x SEQ_DX along x and closer to frame 1's
             sphere, every loss is finite and each kernel launched exactly
             as often as the two entry points imply.
The last line is the JSON result {"ok": true, "device": {...}}. Any failed
phase raises, and the script exits non-zero without that line.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ITERS = 20
WARMUP_STEPS = 3
# The JAX package's pair demand of this scene at initialisation, the maximum
# over the 4 cameras: bench.py's build_scene and probe_pair_demand run on the
# CPU. The port's binning must reproduce it exactly. (The package's TPU
# record, 975,847 pairs and 815 tiles in BENCH_r05.json, differs through the
# TPU's arithmetic, not the binning.)
JAX_DEMAND_PAIRS = 975_378
JAX_DEMAND_ACTIVE = 808
HIGH_OPACITY = 0.9  # the kind of value trained gaussians reach
# The topology event (phase 7): refine iterations (detection at half), the
# position / delta learning-rate scale, boosted as the JAX package's
# end-to-end test boosts it so that unbound gaussians reach the blob in a
# short budget, and the limits of the result's checks.
TOPO_ITERS = 400
TOPO_LR_SCALE = 3.0
TOPO_BOUNDARY_PAD = 0.12
TOPO_SOLID_OPACITY = 0.995
TOPO_MIN_PROTRUSION = 0.62  # m along the blob direction (sphere radius 0.6)
TOPO_MAX_TRACKED_DEV = 0.1  # m, median |r - 0.6| of the tracked faces' vertices
# The native line (phase 7): the decimation's target, the smoothing's
# iterations (extract_mesh_fusion's), and the fusion voxel (SequenceConfig's
# default) that bounds the decimated vertices' distance to the fused ones.
NATIVE_FACES = 100_000
NATIVE_SMOOTH_ITERS = 10
FUSION_VOXEL = 0.008
# The sequence (phase 8): refine iterations per frame (the reference runs
# 2000) and the frames (0 and 1).
SEQ_ITERS = 200
SEQ_FRAMES = 2
# The warp's checks: the least observed fraction of the vertices and the band
# of the median x-move, in dx. On the unrefined frame-0 sphere the warp
# observes 0.472 of the vertices and moves their median by 0.962 dx
# (tests/test_torch_warp.py, full width); the poles, out of view of >= 2
# cameras, keep what propagation and smoothing give them (mean 0.742 dx).
SEQ_MIN_OBSERVED = 0.3
SEQ_MEDIAN_MOVE = (0.8, 1.2)
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores and HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Float operations of the blend, counted from the kernels' source (add, mul,
# compare, min, div and exp one each). Every evaluated (pixel, pair) runs the
# test: offsets, power, exp, alpha, the two cuts (16). An included pair adds,
# in the forward, the T update and the channel sums (4 + 2 C); in the
# backward, T recovery, the per-channel suffix sums, dL/dalpha and the six
# geometric gradients (29 + 8 C), plus one add per field to sum the 256
# pixels of each slot (6 + C).
TEST_OPS = 16


def fwd_included_ops(c):
    return 4 + 2 * c


def bwd_included_ops(c):
    return 29 + 8 * c + 6 + c


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def fail(msg):
    raise RuntimeError(msg)


def random_scene(torch, n, size, seed, device):
    """(means, cov3d, opacities, features [N, 4], camera) of a seeded cloud
    in front of one camera; feature 3 is the view depth."""
    from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
    from gaustar_tpu_torch.utils.synthetic import ring_cameras

    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [rng.normal(scale=0.4, size=(n, 2)), 4.0 + rng.uniform(0, 2, (n, 1))], 1
    ).astype(np.float32)
    scales = np.exp(rng.normal(-3.6, 0.4, (n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1 / (1 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    cam = ring_cameras(1, w=size, h=size, focal=1.2 * size, device=device)[0]
    feats = torch.cat([t(rgb), t(means[:, 2:3])], dim=1)
    return t(means), quat_scale_to_cov3d(t(scales), t(quats)), t(opac), feats, cam


def timed_call(torch, fn):
    """(fn(), its ms between CUDA events)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def check_forward(torch, bc, inputs, channels, label, fwd_only=False):
    """(plain raw state, the kernel's split for the backward, max |error| of
    colour and T, the plain call's ms). `fwd_only`: the kernel runs as a
    forward-only render calls it, blend_raw under no_grad (split None)."""
    pd, start, count, gx, W, H = inputs
    if fwd_only:
        with torch.no_grad():
            raw_k, split = bc.blend_raw(pd, start, count, gx, W, H, channels), None
    else:
        raw_k, split = bc.blend_fwd_split(pd, start, count, gx, W, H, channels)
    raw_p, plain_ms = timed_call(torch, lambda: bc.blend_fwd_plain(pd, start, count, gx, W, H, channels))
    rows = [0, 1, 2, 3, 6]
    err = float((raw_k[:, rows] - raw_p[:, rows]).abs().max())
    nc_bad = float((raw_k[:, 4] != raw_p[:, 4]).float().mean())
    done_bad = float((raw_k[:, 5] != raw_p[:, 5]).float().mean())
    log("fwd", f"{label} c{channels}: pairs={pd.shape[1]} active_tiles={int((count > 0).sum())} "
               f"max|d colour,T|={err:.3e} n_contrib_mismatch={nc_bad:.3e} done_mismatch={done_bad:.3e}")
    if not err <= 1e-4 or nc_bad > 0 or done_bad > 0:
        fail(f"forward kernel disagrees with blend_fwd_plain on {label} c{channels}")
    return raw_p, split, err, plain_ms


def check_backward(torch, bc, inputs, channels, raw, split, label):
    """(max |error| of the gradients, the plain call's ms). The kernel reads
    the forward's test bits (`split`), as the main path's backward does."""
    pd, start, count, gx, W, H = inputs
    gen = torch.Generator(device="cuda").manual_seed(7)
    ct = torch.zeros_like(raw)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = torch.randn(ct[:, row].shape, generator=gen, device="cuda")
    g_k = bc.blend_bwd_cuda(pd, start, count, gx, W, H, channels, raw, ct, split)
    g_p, plain_ms = timed_call(torch, lambda: bc.blend_bwd_plain(pd, start, count, gx, W, H, channels, raw, ct))
    worst = 0.0
    max_abs = float((g_k - g_p).abs().max())
    for row in range(6 + channels):
        ref = g_p[row]
        atol = 1e-3 * float(ref.abs().max())
        excess = float(((g_k[row] - ref).abs() - 1e-3 * ref.abs() - atol).max())
        worst = max(worst, float((g_k[row] - ref).abs().max()) / max(float(ref.abs().max()), 1e-30))
        if excess > 0:
            fail(f"backward kernel disagrees with blend_bwd_plain on {label} c{channels} field {row}")
    if not torch.isfinite(g_k).all():
        fail("backward kernel produced non-finite gradients")
    log("bwd", f"{label} c{channels}: max |d grad| / |grad|_inf = {worst:.3e}, max |d grad| = {max_abs:.3e} "
               f"(rtol 1e-3, atol 1e-3 |g|_inf)")
    return max_abs, plain_ms


def walk_counts(torch, bc, inputs, raw):
    """What this data needs of the two kernels: {fwd_evals, included,
    bwd_evals, fwd_slots, bwd_slots, active}. The forward evaluates each
    pixel's list up to and including its stop pair (or to the end) and loads
    a tile's pairs in batches of 256 until every pixel is done; the backward
    evaluates positions 1 .. n_contrib and loads a tile's slots up to its
    largest n_contrib; both do the full work only for included pairs."""
    pd, start, count, gx, W, H = inputs
    ids, st, ct = bc._active_tiles(start, count)
    px, py = bc._tile_pixels(ids, gx)
    done = (px >= W) | (py >= H)
    T = torch.ones_like(px)
    fwd_evals = torch.zeros((), dtype=torch.int64, device=pd.device)
    included = torch.zeros_like(fwd_evals)
    last = torch.zeros_like(ct)  # the last position any pixel of the tile walked
    for k in range(int(ct.max())):
        d, valid = bc._pair_at(pd, st, ct, k)
        alpha, contrib, _, _, _ = bc._eval_pair(d, px, py)
        walked = valid[:, None] & ~done
        contrib = contrib & walked
        test_t = T * (1.0 - alpha)
        stop = contrib & (test_t < 1e-4)
        inc = contrib & ~stop
        fwd_evals += walked.sum()
        included += inc.sum()
        last = torch.where(walked.any(1), k + 1, last)
        done = done | stop
        T = torch.where(inc, test_t, T)
    batch = bc.PIX
    fwd_slots = torch.minimum(ct, (last + batch - 1) // batch * batch).sum()
    nc = raw[ids, 4]
    return {"fwd_evals": int(fwd_evals), "included": int(included), "bwd_evals": int(nc.double().sum()),
            "fwd_slots": int(fwd_slots), "bwd_slots": int(nc.amax(1).double().sum()), "active": int(ids.numel())}


def blend_bounds(n_tiles, n_pairs, channels, w):
    """(ms, 'bytes' | 'operations') of each kernel's bound on this data, `w`
    from walk_counts. Bytes: the fields the kernel reads (6 + C) of each pair
    slot it loads; tile_count of every tile and tile_start of the active ones;
    the forward writes the whole raw state, the backward reads final T and
    n_contrib (2 rows) and the colour and final-T cotangents (C + 1 rows) of
    the active tiles and writes every slot's 6 + C gradients once."""
    nf, tiles = 6 + channels, 4 * n_tiles + 4 * w["active"]
    row = 256 * 4  # one state row of one tile
    fwd = bound(4 * nf * w["fwd_slots"] + tiles + 8 * row * n_tiles,
                TEST_OPS * w["fwd_evals"] + fwd_included_ops(channels) * w["included"])
    bwd = bound(4 * nf * w["bwd_slots"] + tiles + (2 + channels + 1) * row * w["active"] + 4 * nf * n_pairs,
                TEST_OPS * w["bwd_evals"] + bwd_included_ops(channels) * w["included"])
    return fwd, bwd


def cuda_ms(torch, fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_kernels(torch, fn):
    """Names of the CUDA kernels built from csrc/ (blend_*) that one call of
    `fn` launches, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = (re.search(r"blend_\w+", e.name) for e in prof.events() if e.device_type == DeviceType.CUDA)
    return [m.group(0) for m in names if m]


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def solid_view_inputs(torch, params, config, camera, solid_opacity):
    """(means, cov3d, opacities, features [N, 3], camera) of a detection
    render's solid-surface depth pass: every opacity at `solid_opacity`,
    small in-plane scales raised to their mean, view depth as the colour."""
    from gaustar_tpu_torch.models import sugar
    from gaustar_tpu_torch.train.topo_detect import detection_params

    with torch.no_grad():
        p = detection_params(params, solid_opacity)
        pos, cov = sugar.geom_primitives(p, config, use_solid_surface=True)
        z = pos @ camera.view[2, :3] + camera.view[2, 3]
        return pos, cov, sugar.strengths(p), z[:, None].expand(-1, 3).contiguous(), camera


def topo_phase(torch, bc):
    """Phase 7: the topology event at full width. Returns {kernel: launches}
    of the event, the forward-only check's max |error| and the event's fused
    mesh."""
    from gaustar_tpu_torch.cameras import index_camera, stack_cameras
    from gaustar_tpu_torch.models import sugar
    from gaustar_tpu_torch.train import mesh_update, sequence, topo_detect
    from gaustar_tpu_torch.train.topo_detect import detection_params
    from gaustar_tpu_torch.utils.synthetic import (
        TOPO_BLOB_CENTER, TOPO_SPHERE_CENTER, TOPO_SPHERE_RADIUS, blend_inputs, render_inputs, topology_scene)

    t0 = time.perf_counter()
    sc = topology_scene("cuda")
    cams, rcfg = sc["cams"], sc["raster_cfg"]
    n_cams = len(cams)
    height, width = sc["gt_depths"].shape[1:]
    log("topo", f"topology_scene: {len(sc['faces'])} faces, {6 * len(sc['faces'])} gaussians, {n_cams} cameras "
                f"{width}x{height}; GT rendered in {time.perf_counter() - t0:.1f} s")

    # The forward kernel as detection and fusion call it (no_grad), against
    # its plain version on the 64 busiest tiles.
    params, config = sugar.init_sugar(sc["verts"], sc["faces"], vertex_colors=sc["colors"], device="cuda")
    with torch.no_grad():
        pts = sugar.gaussian_centers(params, config).cpu().numpy()
    orbit0 = index_camera(mesh_update.fusion_cameras(pts, stack_cameras(cams)), 0)
    fwd_err = 0.0
    for label, scene, channels in (
            ("detection view (solid surface)", solid_view_inputs(torch, params, config, cams[0], TOPO_SOLID_OPACITY), 3),
            ("fusion view (orbit 0)", render_inputs(detection_params(params, TOPO_SOLID_OPACITY), config, orbit0), 4)):
        inputs = blend_inputs(*scene, channels, top_tiles=64)
        fwd_err = max(fwd_err, check_forward(torch, bc, inputs, channels, f"forward only, {label}, top-64 tiles",
                                             fwd_only=True)[2])
    del params, config

    iters = TOPO_ITERS
    seq = sequence.SequenceConfig(
        refinement_iterations=iters, force_watertight=False, boundary_pad=TOPO_BOUNDARY_PAD,
        fusion_solid_opacity=TOPO_SOLID_OPACITY, spatial_lr_scale=TOPO_LR_SCALE)
    dcfg = topo_detect.TopoDetectConfig(min_observe=3, detect_floor=False)
    log("topo", f"settings: {iters} iterations (detection at {iters // 2}), re-refine {iters // 2}; "
                f"spatial_lr_scale {seq.spatial_lr_scale}; boundary_pad {seq.boundary_pad}; force_watertight "
                f"{seq.force_watertight}; fusion voxel {seq.fusion_voxel_size} trunc {seq.fusion_sdf_trunc} "
                f"solid opacity {seq.fusion_solid_opacity}; unbind_threshold {seq.unbind_threshold}; "
                f"cc_face_threshold {seq.update_cc_face_threshold}; detection {dcfg}")

    stamps = {"refine": [], "re_refine": []}
    stage = ["refine"]
    events = []

    def on_log(entry):
        if not all(np.isfinite(float(v)) for v in entry.values()):
            fail(f"non-finite value in the {stage[0]} log: {entry}")
        if "loss" in entry:
            torch.cuda.synchronize()
            stamps[stage[0]].append(time.perf_counter())
        else:
            events.append(entry)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    p, c, d, topo, _ = sequence.refine_one_frame(
        seq, 1, sc["verts"], sc["faces"], sc["colors"], cams, sc["gt_images"], sc["gt_depths"], rcfg,
        is_first_frame=False, detect_cfg=dcfg, log_fn=on_log, log_every=1, device="cuda")
    torch.cuda.synchronize()
    t_refine = time.perf_counter() - t0
    det_mid = topo_detect.last_telemetry
    stage[0] = "re_refine"
    p, c, d, topo, ev = sequence.update_frame_topology(
        seq, 1, p, c, d, topo, cams, sc["gt_images"], sc["gt_depths"], rcfg, detect_cfg=dcfg,
        log_fn=on_log, log_every=1)
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    det_post = topo_detect.last_telemetry
    fus = mesh_update.last_fusion

    unbind = [e for e in events if "unbind_changed" in e]
    for name, t in (("mid-refine", det_mid), ("after refine", det_post)):
        if t is not None:
            log("topo", f"detection {name}: wall {1e3 * t.seconds:.1f} ms; camera loop (renders, gates, "
                        f"stacks) {t.device_ms:.1f} ms between CUDA events; coverage_mean "
                        f"{t.coverage_per_cam.mean():.4f} observed_fraction {t.observed_fraction:.4f} "
                        f"flagged_faces {t.flagged_faces}")
    log("topo", f"unbind decision: {unbind} (refine wall {t_refine:.1f} s)")
    if not unbind or not unbind[0]["loose_bind"]:
        fail(f"the model did not loose-bind: {unbind}")
    log("topo", f"fusion: {fus['views']} views x {fus['blocks']} block(s) of {fus['block_dims']} voxels "
                f"(global {fus['global_dims']}); renders + integration {fus['device_ms']:.1f} device ms; "
                f"extraction {fus['host_ms']:.1f} host ms; fused mesh {fus['verts']} verts, {fus['faces']} faces")
    log("topo", f"stage wall s: {ev['seconds']}")
    if ev["cc_update_num"] < 1:
        fail(f"the surgery grafted nothing: {ev['cc_update_num']}")
    um, track = ev["updated_mesh"], ev["track_face_mask"]
    n_tracked = int(track.sum())
    center = np.asarray(TOPO_SPHERE_CENTER)
    blob_dir = np.asarray(TOPO_BLOB_CENTER) - center
    blob_dir /= np.linalg.norm(blob_dir)
    protrusion = float(((um.verts - center) @ blob_dir).max())
    tv = um.verts[um.faces[:n_tracked].reshape(-1)]
    tracked_dev = float(np.median(np.abs(np.linalg.norm(tv - center, axis=1) - TOPO_SPHERE_RADIUS)))
    log("topo", f"surgery: {1e3 * ev['seconds']['surgery']:.1f} host ms; cc_update_num {ev['cc_update_num']}; "
                f"aabb_pad {ev['aabb_pad']}; tracked faces {n_tracked} of {len(track)}, new faces "
                f"{len(um.faces) - n_tracked}; max_dist_in_connection {ev['max_dist_in_connection']:.5f}; "
                f"protrusion toward the blob {protrusion:.4f} m; tracked median |r - r0| {tracked_dev:.5f} m")
    if protrusion <= TOPO_MIN_PROTRUSION:
        fail(f"the graft does not reach toward the blob: {protrusion:.4f} <= {TOPO_MIN_PROTRUSION}")
    if not tracked_dev < TOPO_MAX_TRACKED_DEV:
        fail(f"the tracked prefix left the sphere: median |r - r0| {tracked_dev:.4f}")

    steps = {k: [1e3 * (b - a) for a, b in zip(v[WARMUP_STEPS - 1:], v[WARMUP_STEPS:])] for k, v in stamps.items()}
    re_iters = iters // 2
    n_views = fus["views"] * fus["blocks"]
    expected = {"blend_fwd": iters + re_iters + 2 * 2 * n_cams + n_views, "blend_bwd": iters + re_iters}
    log("topo", f"median iteration ms: refine {statistics.median(steps['refine']):.2f} "
                f"({len(stamps['refine'])} its, {len(sc['faces'])} faces), re-refine "
                f"{statistics.median(steps['re_refine']):.2f} ({len(stamps['re_refine'])} its, {len(um.faces)} faces); "
                f"peak mem {peak_gb:.2f} GiB; launches {launches}, expected {expected} "
                f"(fwd = {iters} + {re_iters} iterations + 2 x 2 x {n_cams} detection renders + {n_views} fusion views)")
    if len(stamps["refine"]) != iters or len(stamps["re_refine"]) != re_iters:
        fail(f"iterations logged: {len(stamps['refine'])} and {len(stamps['re_refine'])}")
    if launches != expected:
        fail(f"the topology event launched the kernels {launches}, expected {expected}")
    return launches, fwd_err, ev["fusion_mesh"]


def native_phase(fused):
    """Phase 7's native line: decimate and smooth the fused mesh on the host."""
    from scipy.spatial import cKDTree

    from gaustar_tpu_torch import native

    t0 = time.perf_counter()
    native.build()
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    dv, df = native.decimate(fused.verts, fused.faces, NATIVE_FACES)
    t_dec = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    sv = native.laplacian_smooth(fused.verts, fused.faces, iterations=NATIVE_SMOOTH_ITERS)
    t_smooth = 1e3 * (time.perf_counter() - t0)
    dist = float(np.median(cKDTree(fused.verts).query(dv)[0]))
    log("native", f"build {t_build:.1f} s ({native.BUILD_LOG.get('seconds', 0.0):.1f} s of g++); decimate "
                  f"{len(fused.faces)} -> {len(df)} faces ({len(dv)} vertices) {t_dec:.1f} host ms; "
                  f"laplacian_smooth {NATIVE_SMOOTH_ITERS} iterations of {len(sv)} vertices {t_smooth:.1f} host ms; "
                  f"median distance decimated -> fused vertices {1e3 * dist:.3f} mm (voxel {1e3 * FUSION_VOXEL} mm)")
    if not 0.9 * NATIVE_FACES <= len(df) <= NATIVE_FACES:
        fail(f"decimation left {len(df)} faces, target {NATIVE_FACES}")
    if not (np.isfinite(dv).all() and np.isfinite(sv).all()):
        fail("the native library returned non-finite vertices")
    if not dist < FUSION_VOXEL:
        fail(f"the decimated vertices left the fused surface: median distance {dist:.4f} m")


def seq_phase(torch, bc, root):
    """Phase 8: run_sequence and render_sequence over the full-width
    two-frame dataset written under `root`. Returns {kernel: launches} of
    the two entry points."""
    from gaustar_tpu_torch.io.checkpoint import load_sugar
    from gaustar_tpu_torch.io.meshio import read_obj
    from gaustar_tpu_torch.tools.warp_mesh import WarpConfig
    from gaustar_tpu_torch.train import render_seq, sequence
    from gaustar_tpu_torch.utils.synthetic import SEQ_CAMS, SEQ_WARP, sequence_dataset

    data_root, work_root = os.path.join(root, "data"), os.path.join(root, "work")
    t0 = time.perf_counter()
    info = sequence_dataset(data_root, "full", "cuda")
    torch.cuda.synchronize()
    log("seq", f"dataset: {SEQ_FRAMES} frames x {SEQ_CAMS} cameras, {len(info['faces'])} faces, "
               f"{6 * len(info['faces'])} gaussians, written in {time.perf_counter() - t0:.1f} s")

    stamps = []  # per frame, the host clock at each logged iteration

    def on_log(entry):
        if "loss" not in entry:
            return
        if not all(np.isfinite(float(v)) for v in entry.values()):
            fail(f"non-finite value in the sequence's log: {entry}")
        if entry["iteration"] == 1:
            stamps.append([])
        torch.cuda.synchronize()
        stamps[-1].append(time.perf_counter())

    seq = sequence.SequenceConfig(data_root=data_root, work_root=work_root, frame_0=0, frame_end=SEQ_FRAMES,
                                  refinement_iterations=SEQ_ITERS, disable_mesh_update=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    final, final_config, frames = sequence.run_sequence(seq, warp_cfg=WarpConfig(**SEQ_WARP), device="cuda",
                                                        log_fn=on_log, log_every=1)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t0
    peak_run = torch.cuda.max_memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    render_seq.render_sequence(data_root, work_root, 0, SEQ_FRAMES, iterations=SEQ_ITERS, render_modes="bd",
                               device="cuda")
    torch.cuda.synchronize()
    t_render = 1e3 * (time.perf_counter() - t0)
    peak_render = torch.cuda.max_memory_allocated() / 2**30
    launches = dict(bc.LAUNCHES)

    for rec, st in zip(frames, stamps):
        s, w = rec["seconds"], rec["warp"]
        steps = [1e3 * (b - a) for a, b in zip(st[WARMUP_STEPS - 1:], st[WARMUP_STEPS:])]
        warp = ("no warp (last frame)" if w is None else
                f"warp {1e3 * s['warp']:.1f} ms wall (depths and flows loaded, mesh written), of which "
                f"observations {w['observe_ms']:.1f} host ms ({SEQ_CAMS} cameras), robust average + "
                f"propagation + smoothing {w['average_ms']:.1f} host ms; visible per camera "
                f"{[round(x, 4) for x in w['visible_per_camera']]}, observed fraction {w['observed_fraction']:.4f}")
        log("seq", f"frame {rec['frame']}: JPEG decode {rec['decode_ms']:.2f} ms ({SEQ_CAMS} cameras, CUDA events), "
                   f"load {1e3 * s['load']:.1f} ms wall; refine {s['refine']:.2f} s wall, median iteration "
                   f"{statistics.median(steps):.2f} ms ({len(st)} its); exports ms: npz {1e3 * s['export_npz']:.1f}, "
                   f"ply {1e3 * s['export_ply']:.1f}, obj {1e3 * s['export_obj']:.1f}; {warp}")
    log("seq", f"run_sequence {t_run:.2f} s, peak mem {peak_run:.2f} GiB; render_sequence {t_render:.1f} ms "
               f"({SEQ_FRAMES} frames x {SEQ_CAMS} cameras, RGB JPEG + depth npz), peak mem {peak_render:.2f} GiB")

    missing = []
    for f in range(SEQ_FRAMES):
        fdir = os.path.join(work_root, f"{f:04d}")
        names = [f"{SEQ_ITERS}.npz", f"{SEQ_ITERS}.json", f"{f:04d}.ply", "color_mesh.obj", "config.json",
                 "metrics.jsonl"]
        names += [f"render_b/render_{c:06d}.jpg" for c in range(SEQ_CAMS)]
        names += [f"render_d/depth_{c:06d}.npz" for c in range(SEQ_CAMS)]
        if f > 0:
            names.append("coarse_mesh/warp_smooth.obj")
        missing += [os.path.join(fdir, n) for n in names if not os.path.exists(os.path.join(fdir, n))]
    if missing:
        fail(f"the sequence did not write {missing}")
    if [len(st) for st in stamps] != [SEQ_ITERS] * SEQ_FRAMES:
        fail(f"iterations logged per frame: {[len(st) for st in stamps]}")

    last = SEQ_FRAMES - 1
    loaded, lconf, _ = load_sugar(os.path.join(work_root, f"{last:04d}", f"{SEQ_ITERS}.npz"), "cuda")
    unequal = [n for n, t in final.named() if not torch.equal(getattr(loaded, n).detach(), t.detach())]
    if unequal or not torch.equal(lconf.faces, final_config.faces):
        fail(f"the frame-{last} checkpoint does not load to the final parameters: {unequal}")

    v0, _, _ = read_obj(os.path.join(work_root, "0000", "color_mesh.obj"))
    vw, _, _ = read_obj(os.path.join(work_root, "0001", "coarse_mesh", "warp_smooth.obj"))
    dx = info["dx"]
    move = (vw - v0).mean(axis=0)
    median_x = float(np.median(vw[:, 0] - v0[:, 0]))
    observed = frames[0]["warp"]["observed_fraction"]
    center = np.asarray([dx, 0.0, 4.0])
    radius = float(np.median(np.linalg.norm(info["verts"] - [0.0, 0.0, 4.0], axis=1)))
    dev_w, dev_0 = (float(np.median(np.abs(np.linalg.norm(v - center, axis=1) - radius))) for v in (vw, v0))
    log("seq", f"warp 0 -> 1: observed fraction {observed:.4f}; mean move {move.tolist()} m, median x-move "
               f"{median_x / dx:.4f} dx (dx {dx}); median |r - {radius:.3f}| about frame 1's centre {dev_w:.5f} m "
               f"warped, {dev_0:.5f} m unwarped")
    if not observed >= SEQ_MIN_OBSERVED:
        fail(f"the warp observed {observed:.4f} of the vertices, expected at least {SEQ_MIN_OBSERVED}")
    if not 0.5 * dx <= move[0] <= 1.5 * dx:
        fail(f"the warp moved the mesh by {move[0]:.4f} m along x, expected about {dx}")
    if not SEQ_MEDIAN_MOVE[0] * dx <= median_x <= SEQ_MEDIAN_MOVE[1] * dx:
        fail(f"the warp's median x-move is {median_x / dx:.4f} dx, expected within {SEQ_MEDIAN_MOVE}")
    if not dev_w < 0.5 * dev_0:
        fail("the warped mesh is not nearer frame 1's sphere than half the unwarped one's distance")

    expected = {"blend_fwd": SEQ_FRAMES * SEQ_ITERS + 2 * SEQ_FRAMES * SEQ_CAMS, "blend_bwd": SEQ_FRAMES * SEQ_ITERS}
    log("seq", f"launches {launches}, expected {expected} (fwd = {SEQ_FRAMES} x {SEQ_ITERS} iterations + "
               f"2 renders x {SEQ_FRAMES} frames x {SEQ_CAMS} cameras)")
    if launches != expected:
        fail(f"the sequence launched the kernels {launches}, expected {expected}")
    return launches


def kernel_phases(torch, bc, t_start):
    """Phases 3-6: each kernel against its plain version, the refine step at
    full width, the kernels' times. Returns the kernels line's entries."""
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.train import refine
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn
    from gaustar_tpu_torch.utils.synthetic import blend_inputs, reference_scene, render_inputs, synthetic_frame

    # 3-4 kernels against their plain versions
    small = random_scene(torch, 20_000, 256, seed=3, device="cuda")
    params, config, data, raster_cfg = reference_scene("cuda")
    n_cams = data.gt_images.shape[0]
    demand = []
    for i in range(n_cams):
        pd, _, count, *_ = blend_inputs(*render_inputs(params, config, index_camera(data.cameras, i)), 4)
        demand.append((pd.shape[1], int((count > 0).sum())))
    d_pairs, d_active = max(p for p, _ in demand), max(a for _, a in demand)
    log("demand", f"full width at init, (pairs, active tiles) per camera {demand}; max {d_pairs} pairs, "
                  f"{d_active} active tiles (the JAX package on the CPU: {JAX_DEMAND_PAIRS}, {JAX_DEMAND_ACTIVE})")
    if (d_pairs, d_active) != (JAX_DEMAND_PAIRS, JAX_DEMAND_ACTIVE):
        fail("the full-width binning differs from the JAX package's pair demand")
    full = render_inputs(params, config, index_camera(data.cameras, 0))
    means, cov, opac, feats, cam0 = full
    full_high = (means, cov, torch.full_like(opac, HIGH_OPACITY), feats, cam0)
    checks = [(c, label, scene) for c in (3, 4) for label, scene in (("256x256/20k", small),
                                                                    ("full-width top-64 tiles", full))]
    for channels, label, scene in checks + [(4, f"full-width top-64 tiles, opacities {HIGH_OPACITY}", full_high)]:
        inputs = blend_inputs(*scene, channels, top_tiles=None if scene is small else 64)
        raw, split = check_forward(torch, bc, inputs, channels, label)[:2]
        check_backward(torch, bc, inputs, channels, raw, split, label)

    # 5 the slice
    p_s, c_s, d_s, _, rc_s = synthetic_frame(device="cuda")
    p_c, c_c, d_c, _, rc_c = synthetic_frame(device="cpu")
    cfg_s = refine.RefineConfig(num_iterations=4, loose_bind_from=10**9)
    l_g, _ = refine.compute_losses(p_s, c_s, d_s, 1, 1, cfg_s, rc_s, 2)
    l_c, _ = refine.compute_losses(p_c, c_c, d_c, 1, 1, cfg_s, rc_c, 2)
    gg = torch.autograd.grad(l_g, [p_s.points, p_s.scales, p_s.sh_dc])
    gc = torch.autograd.grad(l_c, [p_c.points, p_c.scales, p_c.sh_dc])
    gerr = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(gg, gc))
    l_g, l_c = float(l_g.detach()), float(l_c.detach())
    log("slice", f"48x48 frame, card vs CPU plain path: loss {l_g:.6f} vs {l_c:.6f}, "
                 f"max grad diff / |grad|_inf {gerr:.2e}")
    if abs(l_g - l_c) > 1e-4 * abs(l_c) or gerr > 1e-3:
        fail("the refine loss on the card disagrees with the CPU plain path")

    cfg = refine.RefineConfig(num_iterations=ITERS, loose_bind_from=10**9, do_sh_warmup=False)
    stamps = []

    def on_log(entry):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        if not all(np.isfinite(v) for v in entry.values()):
            fail(f"non-finite loss at iteration {entry['iteration']}: {entry}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bc.reset_launch_counts()
    t0 = time.perf_counter()
    out_params, _, history = refine.refine_frame(params, config, data, cfg, raster_cfg,
                                                 log_every=1, log_fn=on_log)
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    steps_ms = [1e3 * (b - a) for a, b in zip(stamps[WARMUP_STEPS - 1:], stamps[WARMUP_STEPS:])]
    median_ms = statistics.median(steps_ms)
    n_g = params.scales.shape[0]
    height, width = data.gt_images.shape[1:3]
    log("slice", f"refine_frame {ITERS} its: {n_g} gaussians, {width}x{height}, {n_cams} cameras; "
                 f"launches {launches}; wall {wall:.2f} s; median step {median_ms:.2f} ms "
                 f"(steps {WARMUP_STEPS + 1}-{ITERS}); peak mem {peak_gb:.2f} GiB; "
                 f"num_pairs {int(history[-1]['num_pairs'])}; loss {history[0]['loss']:.5f} -> {history[-1]['loss']:.5f}")
    if len(history) != ITERS or launches != {"blend_fwd": ITERS, "blend_bwd": ITERS}:
        fail(f"main path launched the kernels {launches}, expected {ITERS} each")
    moved = float((out_params.points - params.points).detach().abs().max())
    if not moved > 0:
        fail("refine_frame did not move the mesh vertices")

    bc.reset_launch_counts()
    opt_state = adam_init(out_params)
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    loss_b, ld_b = refine.train_step(out_params, opt_state, lr_fn, config, data, [0, 1, 2, 3], 1,
                                     cfg, raster_cfg, 2)
    torch.cuda.synchronize()
    if not np.isfinite(float(loss_b)) or dict(bc.LAUNCHES) != {"blend_fwd": 4, "blend_bwd": 4}:
        fail(f"B=4 step: loss {float(loss_b)}, launches {bc.LAUNCHES}")
    log("slice", f"compute_losses_multi B=4 step: loss {float(loss_b):.5f}, launches {dict(bc.LAUNCHES)}")

    # 6 kernel times at full width (camera 0, the fused 4-channel blend)
    def timed(x):
        """(fwd ms, bwd ms, raw, ct, split) of the wrappers on blend inputs x,
        the backward as the main path calls it: with the forward's test bits."""
        raw, split = bc.blend_fwd_split(*x, 4)
        ct = torch.randn(raw.shape, generator=torch.Generator(device="cuda").manual_seed(11), device="cuda")
        return (cuda_ms(torch, lambda: bc.blend_fwd_cuda(*x, 4), iters=50),
                cuda_ms(torch, lambda: bc.blend_bwd_cuda(*x, 4, raw, ct, split), iters=50), raw, ct, split)

    inputs = blend_inputs(*full, 4)
    pd, start, count, gx, W, H = inputs
    fwd_ms, bwd_ms, raw, ct, split = timed(inputs)
    fwd_long_ms, bwd_long_ms = timed(blend_inputs(*full, 4, top_tiles=1))[:2]
    high = blend_inputs(*full_high, 4)
    fwd_high_ms, bwd_high_ms = timed(high)[:2]
    fwd_kernels = device_kernels(torch, lambda: bc.blend_fwd_cuda(*inputs, 4))
    bwd_kernels = device_kernels(torch, lambda: bc.blend_bwd_cuda(*inputs, 4, raw, ct, split))
    plan = split[0]
    # The plain versions' times: their one call in the all-tile checks (seconds
    # at this size; their kernels are warm from phases 3-4).
    _, split, fwd_err, fwd_plain_ms = check_forward(torch, bc, inputs, 4, "full-width all tiles")
    bwd_err, bwd_plain_ms = check_backward(torch, bc, inputs, 4, raw, split, "full-width all tiles")

    n_tiles, n_pairs = start.shape[0], pd.shape[1]
    walk = walk_counts(torch, bc, inputs, raw)
    fwd_bound, bwd_bound = blend_bounds(n_tiles, n_pairs, 4, walk)
    kernels = [
        {"name": "blend_fwd", "route": "cuda", "source": "gaustar_tpu_torch/csrc/blend_fwd.cu",
         "replaces": "gaustar_tpu/ops/blend_pallas.py:256", "launches": launches["blend_fwd"],
         "launches_per_step": launches["blend_fwd"] / ITERS,
         "max_abs_err": fwd_err,
         "ms": fwd_ms, "plain_ms": fwd_plain_ms, "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
         "library_ms": None, "device_kernels": len(fwd_kernels),
         "scratch_bytes": plan.ends.nbytes + plan.bits_bytes(), "ms_high_opacity": fwd_high_ms,
         "longest_tile_ms": fwd_long_ms},
        {"name": "blend_bwd", "route": "cuda", "source": "gaustar_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "gaustar_tpu/ops/blend_pallas.py:504", "launches": launches["blend_bwd"],
         "launches_per_step": launches["blend_bwd"] / ITERS,
         "max_abs_err": bwd_err,
         "ms": bwd_ms, "plain_ms": bwd_plain_ms, "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
         "library_ms": None, "device_kernels": len(bwd_kernels), "scratch_bytes": plan.state_bytes(4),
         "ms_high_opacity": bwd_high_ms, "longest_tile_ms": bwd_long_ms},
    ]
    log("kernels", f"CUDA kernels per call: blend_fwd {fwd_kernels}; blend_bwd {bwd_kernels}; "
                   f"scratch: test bits {plan.bits_bytes()} B "
                   f"(made by the forward, read by the backward), states {plan.state_bytes(4)} B; opacities "
                   f"{HIGH_OPACITY}: pairs {high[0].shape[1]}, longest tile list {int(high[2].max())}")
    log("kernels", f"full width cam 0: pairs {n_pairs}, active tiles {walk['active']} of {n_tiles}, "
                   f"longest tile list {int(count.max())}, median active {int(count[count > 0].median())}; "
                   f"evaluations fwd {walk['fwd_evals']} bwd {walk['bwd_evals']}, included {walk['included']}; "
                   f"slots loaded fwd {walk['fwd_slots']} bwd {walk['bwd_slots']}; "
                   f"bounds fwd {fwd_bound[0]:.4f} ms ({fwd_bound[1]}) bwd {bwd_bound[0]:.4f} ms ({bwd_bound[1]}); "
                   f"median step {median_ms:.2f} ms; total {time.perf_counter() - t_start:.1f} s")
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    from gaustar_tpu_torch.ops import _build
    from gaustar_tpu_torch.ops import blend_cuda as bc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1 card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log("card", f"{kind}; torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)

    # 2 build
    t0 = time.perf_counter()
    build_log = _build.build(["blend_fwd", "blend_bwd", "jpeg_codec"])
    for name, entry in build_log.items():
        usage = [ln.strip() for ln in entry["log"].splitlines() if "registers" in ln or "smem" in ln]
        log("build", f"{name}: {entry['seconds']:.1f} s; " + " | ".join(usage))
    log("build", f"wall {time.perf_counter() - t0:.1f} s")

    kernels = kernel_phases(torch, bc, t_start)
    # 7 the topology event, then the native library on its fused mesh
    t0 = time.perf_counter()
    topo_launches, fwd_only_err, fused = topo_phase(torch, bc)
    log("topo", f"phase wall {time.perf_counter() - t0:.1f} s")
    native_phase(fused)
    del fused
    torch.cuda.empty_cache()
    # 8 the sequence
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_seq_") as root:
        seq_launches = seq_phase(torch, bc, root)
    log("seq", f"phase wall {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["launches_topo"] = topo_launches[k["name"]]
        k["launches_seq"] = seq_launches[k["name"]]
    kernels[0]["max_abs_err_fwd_only"] = fwd_only_err
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
