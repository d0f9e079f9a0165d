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
             checkpoint loads equal to the final parameters, the warp
             observes at least SEQ_MIN_OBSERVED of the vertices, moves the
             mesh's mean by 0.5-1.5 x SEQ_DX and its median by SEQ_MEDIAN_MOVE
             x SEQ_DX along x and brings it closer to frame 1's sphere, every
             loss is finite and each kernel launched exactly as often as the
             two entry points imply;
  9 prep     the dataset preparation at examples/refscale_field_init.py's
             widths: the field initializer through refscale.field_init.run
             (train/init_mesh.py) on PREP_CAMS ring cameras at 1600x1024
             seeing the analytic sphere (RGB 0.6, masks from the hit test),
             FieldConfig's default widths over field_init.AABB, occupancy
             carving at 128, PREP_RAYS rays a batch for PREP_ITERS
             iterations, the iso level relative to the trained density,
             extraction at PREP_GRID_RES with the CC filter, 10 smoothing
             iterations and decimation to 100,000 faces; the mesh
             depth renderer (tools/mesh_render.py) on uv_sphere(201, 250) in
             PREP_RENDER_CAMS of the cameras against
             utils/synthetic.sphere_depth and on the initializer's mesh in
             every camera (silhouette IoU against the masks); RAFT
             (tools/raft.py, random_params(0)) on a seeded 1600x1024 frame
             and its copy rolled RAFT_SHIFT px along x through
             compute_flow_pair (scale 0.5, RAFT_ITERS iterations, both
             directions), the forward flow also on the CPU after 1 and
             RAFT_ITERS iterations; fuse_gt_depths
             of the PREP_RENDER_CAMS analytic depth maps. It prints each
             stage's times (CUDA events on the card, the host clock for host
             stages), the hash encoding's and the correlation lookup's own
             times, rays/s, the occupancy fill, the density probe, the
             mesh's faces, vertices, centroid error and radii, peak memory,
             the renders' pairs and IoUs, and the card-vs-CPU flow
             difference. It fails unless the initializer's mesh has 1 to
             100,000 faces, finite vertices and its centroid within
             PREP_MAX_CENTROID_ERR of the sphere's centre; the uv_sphere's
             masks agree with the analytic ones at IoU >= PREP_MIN_IOU and
             its median |depth difference| on their common pixels is under
             PREP_MAX_DEPTH_ERR; the flows are finite of shape [512, 800, 2]
             and the card's forward flow agrees with the CPU's (RAFT_TOL_1
             after one iteration, RAFT_TOL_MEDIAN / RAFT_TOL_MAX after
             RAFT_ITERS, relative to the flow's largest component); the fused vertices' median distance to the sphere is under
             one voxel; every loss is finite and no blend kernel launched
             (the preparation renders no gaussians);
 10 gs       vanilla 3DGS at full width: the reference scene's 600,000 SuGaR
             centres moved by GS_NOISE m of seeded noise, grey, through
             create_from_pcd (dist2_avg3 at N = 600,000: its time, peak
             memory, and its relative error against exact |q - p|^2 on
             GS_KNN_SAMPLE points); train_gaussians for GS_ITERS iterations
             against GT renders of the SuGaR model in GS_CAMS ring cameras at
             1600x1024 (densify events at 199-599, one opacity reset), with
             the median iteration, each event's counts and time, the gaussian
             counts and peak memory; evaluate_pairs of the 8 views before and
             after training (PSNR, SSIM, and LPIPS of seeded synthetic
             weights that lpips_convert packed, printed as lpips_synthetic);
             the renders and GTs as 8-bit PNGs through evaluate_dirs, which
             must give the 8-bit images' PSNR / SSIM; the border-face
             postprocess on the SuGaR sphere with a cap (centroid z <
             GS_CAP_Z) cut off; refine_frame for GS_KNOB_ITERS iterations
             with the Laplacian and area_reg knobs on; and one render_composite
             of the model and a moved copy with half its gaussians masked. It
             fails unless every loss is finite, dist2_avg3 is finite and
             positive, every densify event's counts add up (the survivors
             are the count before less the pruned rows, and n_active =
             survivors + clones + 2 splits), the PSNR after training exceeds the initial
             one by GS_MIN_PSNR_GAIN dB, the knobs' terms are in the loss dict
             and each kernel launched exactly as often as the phase implies.
 11 strips   the kernels' tile_base: the full-width frame of phases 3-6 (camera
             0, 4 channels) blended as STRIP_SPLITS strips of ceil(T / D_g)
             tiles, each strip one launch of each kernel with its first tile
             as tile_base (D_g = 3 pads the last strip with two empty tiles):
             the strips' forward rows 0-6 must equal the full-grid launch's
             bit for bit and their gradients within STRIP_GRAD_RTOL of each
             field's inf-norm (it prints whether they are bit-equal), with
             each strip's time against the full grid's; one strip's 64
             busiest tiles against the plain versions at phases 3-4's
             tolerances; one launch of each kernel per strip;
 12 dist     the multi-GPU training path on ranks spawned on the one card
             (torch.multiprocessing, spawn, gloo, a file:// rendezvous in a
             temporary directory), at full width (the reference scene):
             make_sharded_train_step on DIST_CAM_RANKS ranks x DIST_B
             cameras, then make_gauss2d_train_step on cam 2 x gauss
             DIST_GAUSS. Each rank takes one SGD(lr 1) step, whose gradients
             must equal its own single-process step's mean over the same
             cameras (rtol DIST_RTOL, atol DIST_RTOL of each leaf's
             inf-norm, at least DIST_ATOL_FLOOR), then DIST_ADAM_STEPS Adam
             steps with finite losses, then DIST_TIMED_STEPS more with each
             collective timed alone (the card synchronised around it). Per
             rank it prints the step walls, the bytes put into collectives
             per step, the collectives' time and share of a timed step and
             the peak memory, and its launches must be one forward and one
             backward per local camera and step. These are ranks sharing one card, not cards;
 13 tools    registration on the card (ICP recovers a rigid T from the
             reference model's vertices within TOOLS_MAX_T_ERR; the moved
             model's render against the original seen by the moved camera,
             at least TOOLS_MIN_PSNR dB), the model cut and recolour;
             profiling.loop_bench of the refine step against phase 5's
             median; profiling.trace of one step, which must show the blend
             kernels; exact launch counts.
 14 refscale the reference-scale runs (gaustar_tpu_torch/refscale/) at full
             width, shortened in depth (REFSCALE_*): frame.run on the
             reference scene widened to REFSCALE_FRAME_CAMS ring cameras with
             the dent in the GT (REFSCALE_FRAME_ITERS iterations in four
             timed segments, detection twice, fusion decimated to 150,000
             faces, the surgery, the half-budget re-refine); seq.run (the
             two-frame dataset on 40 cameras, run_sequence at
             REFSCALE_SEQ_ITERS a frame, each stage timed); real's capture
             (GT renders on REFSCALE_REAL_CAMS cameras, REFSCALE_REAL_ITERS
             refine iterations, detection under mean, trim1 and median on
             the 160-camera rig with precision and recall, fusion); and
             warp160.run on 160 cameras. It fails on a non-finite loss, a
             frame whose surgery grafted nothing or whose fusion is not
             decimated to about 150,000 faces, a sequence whose frames did
             not checkpoint (whether a frame loose-bound and updated is
             printed: at this depth neither does, PERF.md), a warp whose
             mean motion error reaches REFSCALE_MAX_WARP_ERR_MM, or any
             launch count that differs from what the run implies (one
             forward and one backward per iteration, one forward per
             detection render, fusion view and GT render). seq prints each
             mid-refine detection's pair demand (the largest num_pairs of
             its normal and solid-surface renders over the cameras) beside
             the refine's largest before it, real its detections' demand;
 15 demo     gaustar_tpu_torch.demo.run at the demo's own size (12 ring
             cameras at 256x256, DEMO_ITERS iterations a frame): the
             two-frame dataset with a blob appearing in frame 1, GT from the
             blend kernel, then run_sequence with the mesh update on. It
             prints the PSNRs and the detections' pair demand, and fails if
             a frame's loose bind differs from DEMO_LOOSE_BIND (at this size
             both frames loose-bind, as through the JAX package on the same
             model), a loose-bound frame does not graft (cc_update_num >=
             1), a loss is non-finite, or a
             launch count differs from what the run implies (one forward
             per GT render, detection render, fusion view and PSNR render;
             one forward and one backward per iteration).
 16 bench    gaustar_tpu_torch.bench.run on the reference scene at each batch
             of BENCH_BATCHES (B = 4, then 1; bench.WARMUP steps, then
             bench.STEPS timed), with each run's bench JSON line; then
             gaustar_tpu_torch.bench_scaling.run on the cards (one rank a
             card, so on one card the 1-rank step alone) and its JSON line.
             It fails unless every loss is finite, each bench run launched
             each kernel exactly steps x B times, the first B = 4 step's
             largest num_pairs equals JAX_DEMAND_PAIRS (all four cameras
             from the initial parameters), the scaling run reports the card
             count, no size beyond it, one launch of each kernel per rank,
             camera and step, and no efficiency on one card.
The kernels line adds launches_strips, launches_dist (summed over the ranks
of both steps), launches_tools, launches_refscale, launches_demo and
launches_bench (both bench runs and the scaling ranks), and each kernel's
max |error| on the strip against its plain version.
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
# The dataset preparation (phase 9), at the widths of the JAX package's
# reference-scale run (examples/refscale_field_init.py:36-95): 40 cameras at
# 1600x1024 around the analytic sphere, FieldConfig's default widths, 8192
# rays a batch, occupancy at 128. Cut: 300 training iterations of 2000, and
# the extraction grid at InitMeshConfig's 256 where that run took 512 (the
# marching tetrahedra run on the host). The iso level is relative to the
# trained interior density, as there (:106-117). The sphere, the AABB, the
# occupancy resolution and the face target are refscale/field_init.py's.
PREP_CAMS = 40
PREP_ITERS = 300
PREP_RAYS = 8192
PREP_GRID_RES = 256
PREP_MAX_CENTROID_ERR = 0.1  # m
# The mesh renderer's check: uv_sphere(201, 250) (100,000 faces, chord
# sagitta 0.047 mm at radius 0.6) in 8 of the cameras against the analytic
# depth.
PREP_RENDER_CAMS = 8
PREP_MIN_IOU = 0.995
PREP_MAX_DEPTH_ERR = 1e-4  # m, median over the common pixels
# RAFT: random_params(0), a frame and its copy rolled RAFT_SHIFT px along x,
# 20 iterations at half resolution. The card's forward flow against the
# CPU's, relative to the CPU flow's largest component: after one iteration
# within RAFT_TOL_1; after RAFT_ITERS the random weights' recurrence runs the
# flow out to hundreds of px and amplifies float32 rounding (on an H100 3.6e-6
# after 1 iteration, 1.5e-2 after 20; PERF.md), so there the median |diff|
# within RAFT_TOL_MEDIAN and the max within RAFT_TOL_MAX.
RAFT_SHIFT = 8
RAFT_ITERS = 20
RAFT_TOL_1 = 2e-5
RAFT_TOL_MEDIAN = 1e-3
RAFT_TOL_MAX = 5e-2
# Vanilla 3DGS (phase 10): train_gaussians on the reference scene's 600,000
# SuGaR centres (moved by GS_NOISE m of seeded noise, grey) against GT renders
# of the SuGaR model in GS_CAMS ring cameras at 1600x1024. Densify events at
# 199, 299, 399, 499 and 599. The JAX loop (and the port) resets opacities at
# every multiple of the interval, iteration 600 included, so the interval is
# 350, not 300: one reset, at 350, and the evaluation sees trained opacities.
# The PSNR after training must exceed the initial one by GS_MIN_PSNR_GAIN dB:
# half the 20.2 dB gain measured on an NVIDIA H100 80GB HBM3 (23.49 -> 43.72 dB,
# PERF.md).
GS_ITERS = 600
GS_CAMS = 8
GS_NOISE = 1e-3
GS_SH_WARMUP = 200
GS_DENSIFY = (100, 600, 100)  # from, until, interval
GS_OPACITY_RESET = 350
GS_MIN_PSNR_GAIN = 10.0
GS_KNN_SAMPLE = 10_000
GS_CAP_Z = 3.55  # faces with a centroid below it are cut off the sphere (z 3.4-4.6)
GS_KNOB_ITERS = 5
# The strips (phase 11): the full-width frame blended as D_g strips of
# ceil(T / D_g) tiles, each one launch with its tile_base. 6,400 tiles: D_g = 3
# leaves the last strip with two tiles of padding.
STRIP_SPLITS = (2, 3, 4)
STRIP_GRAD_RTOL = 1e-6  # of each field's inf-norm
# The distributed steps (phase 12): ranks that share the one card over gloo.
# (a) camera DP on DIST_CAM_RANKS ranks x DIST_B cameras, (b) gauss2d on a
# cam = 2 x gauss = 2 mesh; one SGD(lr 1) step, whose gradients (captured as
# the step applies them) are held to the single-process step's mean gradient
# at tests/test_gauss2d.py's rtol and atol 2e-4 of each leaf's inf-norm, then
# DIST_ADAM_STEPS Adam steps. That file's 1e-6 floor on atol covers reading
# gradients back as params_before - params_after, which capturing avoids; at
# full width most leaves' gradients are below 1e-6, so the floor here is
# DIST_ATOL_FLOOR, under which only rounding noise lies (complex2d's
# gradients at the rest state are about 1e-13).
DIST_CAM_RANKS = 2
DIST_B = 2
DIST_GAUSS = 2
DIST_ADAM_STEPS = 5
DIST_TIMED_STEPS = 2  # Adam steps after those, each collective timed alone
DIST_RTOL = 2e-4
DIST_ATOL_FLOOR = 1e-9
DIST_TIMEOUT_S = 400
# The tools (phase 13): a rigid T (a rotation about the world origin, 4 m
# from the sphere, and a shift) that moves the sphere's vertices by about a
# centimetre, about one vertex spacing (9 mm between latitude rings), small
# enough for ICP to lock onto the true correspondences.
TOOLS_T_ANGLE = 0.002  # rad about (1, 2, 2) / 3
TOOLS_T_SHIFT = (0.0012, -0.0008, 0.0015)  # m
TOOLS_MAX_T_ERR = 1e-5
TOOLS_MIN_PSNR = 40.0  # dB, the moved model's render against the moved camera's
TOOLS_BENCH_ITERS = 10
# The reference-scale runs (phase 14, gaustar_tpu_torch/refscale/) at full
# width, their depth cut to fit the time limit: the frame on 40 cameras for
# 800 of 2000 iterations (detection twice, fusion decimated to 150,000 faces,
# the surgery, a 400-iteration re-refine; after 400 iterations the trained
# surface is not yet opaque enough for detection's visibility gate and
# nothing is flagged, after 800 the dent is, PERF.md); the sequence's two
# frames at 200 of 2000 iterations each; the real capture on 32 cameras for 100 of 400
# iterations with detection on the 160-camera rig and fusion (its 160-camera
# flow warp, host numpy, is left to the full run); the warp on 160 cameras,
# whole, whose mean motion error must stay under REFSCALE_MAX_WARP_ERR_MM of
# the 20 mm shift.
REFSCALE_FRAME_CAMS = 40
REFSCALE_FRAME_ITERS = 800
REFSCALE_FUSED_FACES = (149_000, 150_000)
REFSCALE_SEQ_CAMS = 40
REFSCALE_SEQ_ITERS = 200
REFSCALE_REAL_CAMS = 32
REFSCALE_REAL_ITERS = 100
REFSCALE_REAL_DETECT_CAMS = 160
REFSCALE_WARP_CAMS = 160
REFSCALE_MAX_WARP_ERR_MM = 1.0
# The end-to-end demo (phase 15, gaustar_tpu_torch/demo.py) at its own size.
# By iteration 300 the in-plane scales of frame 0's gaussians have grown
# enough to put 1.2 cm of median depth error (5.7 cm at the 90th
# percentile) between the detection's renders and the GT's, and detection
# flags 817-821 of the 1,280 faces; the JAX package's detection
# and surgery on the same model flag the same faces and graft (PERF.md).
# So both frames loose-bind and graft.
DEMO_ITERS = 600
DEMO_LOOSE_BIND = [True, True]
# The bench (phase 16, gaustar_tpu_torch/bench.py and bench_scaling.py): the
# camera batches it runs, in order.
BENCH_BATCHES = (4, 1)
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


def check_forward(torch, bc, inputs, channels, label, fwd_only=False, tile_base=0):
    """(plain raw state, the kernel's split for the backward, max |error| of
    colour and T, the plain call's ms). `fwd_only`: the kernel runs as a
    forward-only render calls it, blend_raw under no_grad (split None)."""
    from gaustar_tpu_torch.utils.general import device_ms

    pd, start, count, gx, W, H = inputs
    if fwd_only:
        with torch.no_grad():
            raw_k, split = bc.blend_raw(pd, start, count, gx, W, H, channels, tile_base), None
    else:
        raw_k, split = bc.blend_fwd_split(pd, start, count, gx, W, H, channels, tile_base)
    raw_p, plain_ms = device_ms(torch.device("cuda"),
                                lambda: bc.blend_fwd_plain(pd, start, count, gx, W, H, channels, tile_base))
    rows = [0, 1, 2, 3, 6]
    err = float((raw_k[:, rows] - raw_p[:, rows]).abs().max())
    nc_bad = float((raw_k[:, 4] != raw_p[:, 4]).float().mean())
    done_bad = float((raw_k[:, 5] != raw_p[:, 5]).float().mean())
    log("fwd", f"{label} c{channels}: pairs={pd.shape[1]} active_tiles={int((count > 0).sum())} "
               f"max|d colour,T|={err:.3e} n_contrib_mismatch={nc_bad:.3e} done_mismatch={done_bad:.3e}")
    if not err <= 1e-4 or nc_bad > 0 or done_bad > 0:
        fail(f"forward kernel disagrees with blend_fwd_plain on {label} c{channels}")
    return raw_p, split, err, plain_ms


def check_backward(torch, bc, inputs, channels, raw, split, label, tile_base=0):
    """(max |error| of the gradients, the plain call's ms). The kernel reads
    the forward's test bits (`split`), as the main path's backward does."""
    from gaustar_tpu_torch.utils.general import device_ms

    pd, start, count, gx, W, H = inputs
    ct = seeded_cotangent(torch, raw, 7)
    g_k = bc.blend_bwd_cuda(pd, start, count, gx, W, H, channels, raw, ct, split, tile_base)
    g_p, plain_ms = device_ms(torch.device("cuda"),
                              lambda: bc.blend_bwd_plain(pd, start, count, gx, W, H, channels, raw, ct, tile_base))
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


def seeded_cotangent(torch, raw, seed):
    """A cotangent of the raw state: seeded normals on the rows the loss
    reads (colour, final T, depth), zeros elsewhere."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ct = torch.zeros_like(raw)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = torch.randn(ct[:, row].shape, generator=gen, device="cuda")
    return ct


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


def prep_phase(torch, bc):
    """Phase 9: the dataset preparation at full width. Returns {kernel:
    launches} of the phase (none expected)."""
    from gaustar_tpu_torch.mesh.primitives import uv_sphere
    from gaustar_tpu_torch.models import neural_field as nf
    from gaustar_tpu_torch.refscale import field_init
    from gaustar_tpu_torch.tools import depth_fusion, mesh_render, raft
    from gaustar_tpu_torch.tools.geometry import resize_linear
    from gaustar_tpu_torch.utils.general import device_ms, full_float32
    from gaustar_tpu_torch.utils.profiling import cuda_ms
    from gaustar_tpu_torch.utils.synthetic import REF_FOCAL, REF_H, REF_W, sphere_depth

    center, radius = field_init.CENTER, field_init.RADIUS
    bc.reset_launch_counts()

    # The field initializer: training and extraction.
    rep, out = field_init.run(PREP_ITERS, PREP_GRID_RES, PREP_RAYS, PREP_CAMS, device="cuda",
                              log=lambda m: log("prep", m))
    field, fcfg, mesh, cams = out["field"], out["field_cfg"], out["mesh"], out["cams"]
    step, losses = rep["step_ms_median"], rep["losses"]
    log("prep", f"field: {fcfg.n_levels} levels x 2^{int(np.log2(fcfg.table_size))} x {fcfg.n_features}, hidden "
                f"{fcfg.hidden}, {fcfg.n_samples} samples; {PREP_CAMS} cameras {REF_W}x{REF_H}, views and masks in "
                f"{rep['gt_build_s']:.1f} s; train {PREP_ITERS} its x {PREP_RAYS} rays: wall {rep['train_s']:.1f} s, "
                f"occupancy carve {rep['occupancy_ms']:.1f} ms (res {rep['occupancy_res']}, fill "
                f"{rep['occupancy_fill_pct']:.2f}%), median step {step:.2f} ms (CUDA events, steps 4-{PREP_ITERS}), "
                f"{PREP_RAYS / step * 1e3:.0f} rays/s, {PREP_RAYS * fcfg.n_samples / step * 1e3:.3e} samples/s; "
                f"peak mem {rep.get('train_peak_memory_bytes', 0) / 2**30:.2f} GiB; losses {[round(x, 5) for x in losses]}; "
                f"density probe {rep['density_probe']}")
    if len(losses) != PREP_ITERS // 200 or not all(np.isfinite(losses)):
        fail(f"non-finite field loss: {losses}")
    # The hash encoding alone at a training batch's size (a kernel candidate).
    pts01 = torch.rand((PREP_RAYS * fcfg.n_samples, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                       device="cuda")
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: nf.hash_encode(field.tables, pts01, fcfg), iters=5)
    enc_bwd_ms = cuda_ms(lambda: nf.hash_encode(field.tables, pts01, fcfg).sum().backward(), iters=5)
    log("prep", f"hash_encode of {len(pts01)} points ({fcfg.n_levels} levels x 8 corners): forward {enc_ms:.2f} ms, "
                f"forward + backward {enc_bwd_ms:.2f} ms (CUDA events)")
    del pts01, field, out

    ex = rep["extract_ms"]
    cerr = rep.get("center_err_m", float("nan"))
    log("prep", f"extract {PREP_GRID_RES}^3: wall {rep['extract_s']:.1f} s; density grid {ex['grid_ms']:.1f} device "
                f"ms; host ms tets {ex.get('tets_ms', 0):.1f}, cc filter {ex.get('cc_filter_ms', 0):.1f}, smooth "
                f"{ex.get('smooth_ms', 0):.1f}, decimate {ex.get('decimate_ms', 0):.1f}; {len(mesh.faces)} faces, "
                f"{len(mesh.verts)} vertices; centroid error {cerr:.4f} m, radius mean "
                f"{rep.get('radius_mean_m', float('nan')):.4f} std {rep.get('radius_std_m', float('nan')):.4f} m "
                f"(true {radius}); peak mem {rep.get('extract_peak_memory_bytes', 0) / 2**30:.2f} GiB")
    if not 0 < len(mesh.faces) <= field_init.TARGET_FACES:
        fail(f"the initial mesh has {len(mesh.faces)} faces")
    if not np.isfinite(mesh.verts).all():
        fail("the initial mesh has non-finite vertices")
    if not cerr < PREP_MAX_CENTROID_ERR:
        fail(f"the initial mesh's centroid is {cerr:.4f} m from the sphere's centre")

    # The mesh depth renderer: the uv_sphere against the analytic depth, then
    # the initializer's mesh in every camera (IoU against the depth's masks).
    views = [c.view.cpu().numpy().astype(np.float64) for c in cams]
    depths = np.stack([sphere_depth(v, REF_FOCAL, (REF_H, REF_W), center, radius) for v in views])
    masks = (depths < mesh_render.INVALID_DEPTH - 1.0).astype(np.float32)
    sv, sf = uv_sphere(201, 250, radius=radius, center=center)
    picks = list(range(0, PREP_CAMS, PREP_CAMS // PREP_RENDER_CAMS))[:PREP_RENDER_CAMS]
    stats = []
    for ci in picks:
        (depth, mask, pairs), ms = device_ms(torch.device("cuda"), lambda: mesh_render.render_mesh_depth(sv, sf, cams[ci]))
        ref_mask = masks[ci] > 0
        both = mask & ref_mask
        stats.append((ci, pairs, ms, float(both.sum() / (mask | ref_mask).sum()),
                      float(np.median(np.abs(depth[both] - depths[ci][both])))))
    log("prep", f"render_mesh_depth uv_sphere(201, 250) ({len(sf)} faces) per camera (index, pairs, ms incl. the "
                f"host copy, mask IoU, median |depth - analytic| m): {[tuple(round(x, 6) for x in t) for t in stats]}")
    worst_iou, worst_err = min(t[3] for t in stats), max(t[4] for t in stats)
    if not worst_iou >= PREP_MIN_IOU or not worst_err < PREP_MAX_DEPTH_ERR:
        fail(f"the mesh renderer misses the analytic sphere: IoU {worst_iou:.5f}, median error {worst_err:.3e} m")
    ious, ms_all = [], []
    for ci in range(PREP_CAMS):
        (_, mask, _), ms = device_ms(torch.device("cuda"), lambda: mesh_render.render_mesh_depth(mesh.verts, mesh.faces,
                                                                                                  cams[ci]))
        ref_mask = masks[ci] > 0
        ious.append(round(float((mask & ref_mask).sum() / (mask | ref_mask).sum()), 4))
        ms_all.append(ms)
    log("prep", f"initial mesh silhouettes, IoU against the masks per camera: {ious}; median render "
                f"{statistics.median(ms_all):.2f} ms")

    # RAFT on the card, the forward flow also on the CPU.
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 256, (REF_H, REF_W, 3)).astype(np.uint8)
    img2 = np.roll(img1, RAFT_SHIFT, axis=1)
    params = raft.random_params(0)
    model = raft.make_raft(params, "cuda")
    torch.cuda.reset_peak_memory_stats()
    raft.compute_flow_pair(model, img1, img2, iters=RAFT_ITERS)  # warm-up: cuDNN's algorithm choice
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fwd, bwd, pad = raft.compute_flow_pair(model, img1, img2, iters=RAFT_ITERS)
    t_pair = 1e3 * (time.perf_counter() - t0)
    hs, ws = REF_H // 2, REF_W // 2
    t1 = torch.as_tensor(resize_linear(img1, hs, ws), device="cuda").permute(2, 0, 1)[None].float()
    t2 = torch.as_tensor(resize_linear(img2, hs, ws), device="cuda").permute(2, 0, 1)[None].float()
    dir_ms = cuda_ms(lambda: raft.raft_forward(model, t1, t2, RAFT_ITERS), iters=3, warmup=1)
    peak_raft = torch.cuda.max_memory_allocated() / 2**30
    # The correlation lookup alone, as one update iteration calls it (a kernel candidate).
    with torch.no_grad(), full_float32():
        pyramid = raft.build_corr_pyramid(model.fnet(2 * (t1 / 255.0) - 1), model.fnet(2 * (t2 / 255.0) - 1))
        coords = raft.coords_grid(1, hs // 8, ws // 8, "cuda") + 3.5
        corr_ms = cuda_ms(lambda: raft.corr_lookup(pyramid, coords), iters=10)
    del pyramid
    cpu_model = raft.make_raft(params, "cpu")
    t0 = time.perf_counter()
    cpu_fwd = raft.raft_forward(cpu_model, t1.cpu(), t2.cpu(), RAFT_ITERS)[0].permute(1, 2, 0).numpy()
    t_cpu = time.perf_counter() - t0
    one = [raft.raft_forward(m, a, b, 1)[0].cpu().numpy() for m, a, b in ((model, t1, t2), (cpu_model, t1.cpu(), t2.cpu()))]
    rel_1 = float(np.abs(one[0] - one[1]).max() / np.abs(one[1]).max())
    scale = float(np.abs(cpu_fwd).max())
    rel_max, rel_median = (float(f(np.abs(fwd - cpu_fwd)) / scale) for f in (np.max, np.median))
    log("prep", f"RAFT random_params(0), {REF_W}x{REF_H} uint8 frames rolled {RAFT_SHIFT} px, scale 0.5, {RAFT_ITERS} "
                f"iterations: compute_flow_pair (both directions, resize and copies) {t_pair:.1f} ms wall; "
                f"raft_forward {dir_ms:.2f} ms per direction (CUDA events), of which corr_lookup "
                f"{corr_ms:.3f} ms a call x {RAFT_ITERS}; peak mem {peak_raft:.2f} GiB; flow "
                f"shape {list(fwd.shape)}, pad {pad}, forward mean {fwd.reshape(-1, 2).mean(0).tolist()}, largest "
                f"|component| {scale:.3f} px; card vs CPU forward flow / largest component: 1 iteration max "
                f"{rel_1:.3e} (tolerance {RAFT_TOL_1}), {RAFT_ITERS} iterations max {rel_max:.3e} ({RAFT_TOL_MAX}) "
                f"median {rel_median:.3e} ({RAFT_TOL_MEDIAN}), max |diff| {rel_max * scale:.4f} px; CPU {t_cpu:.1f} s")
    if fwd.shape != (hs, ws, 2) or bwd.shape != (hs, ws, 2) or not (np.isfinite(fwd).all() and np.isfinite(bwd).all()):
        fail(f"RAFT flows: shapes {fwd.shape} {bwd.shape}, finite {np.isfinite(fwd).all()} {np.isfinite(bwd).all()}")
    if not (rel_1 <= RAFT_TOL_1 and rel_max <= RAFT_TOL_MAX and rel_median <= RAFT_TOL_MEDIAN):
        fail("RAFT's flow on the card differs from the CPU's")

    # GT depth fusion of the analytic depth maps.
    cmr = {"intrinsics": np.stack([np.diag([REF_FOCAL, REF_FOCAL, 1.0])] * len(picks)),
           "extrinsics": np.stack([views[ci] for ci in picks])}
    fused, fus_ms = device_ms(torch.device("cuda"), lambda: depth_fusion.fuse_gt_depths(depths[picks], cmr, device="cuda"))
    dist = float(np.median(np.abs(np.linalg.norm(fused.verts - center, axis=1) - radius)))
    log("prep", f"fuse_gt_depths of {len(picks)} analytic depth maps: {fus_ms:.1f} ms (CUDA events around the call, "
                f"host extraction included); {len(fused.faces)} faces; median |r - {radius}| {1e3 * dist:.3f} mm "
                f"(voxel {1e3 * FUSION_VOXEL} mm)")
    if not len(fused.faces) or not dist < FUSION_VOXEL:
        fail(f"the fused mesh left the sphere: median distance {dist:.4f} m")
    launches = dict(bc.LAUNCHES)
    if any(launches.values()):
        fail(f"the preparation launched blend kernels: {launches}")
    return launches


def synthetic_lpips(root):
    """LPIPSVgg on the card with seeded synthetic VGG16 and linear weights,
    packed by lpips_convert.convert (the repository holds no real ones)."""
    from gaustar_tpu_torch.eval import lpips_convert
    from gaustar_tpu_torch.eval.metrics import LPIPSVgg
    from gaustar_tpu_torch.utils.synthetic import lpips_checkpoints

    packed = os.path.join(root, "packed.pt")
    lpips_convert.convert(*lpips_checkpoints(root), packed)
    return LPIPSVgg(packed, device="cuda")


def knn_exact_dist2(torch, pts, idx, chunk=128):
    """Mean squared distance of pts[idx] to its 3 nearest other points, from
    coordinate differences (no expansion)."""
    out = []
    for s in range(0, len(idx), chunk):
        q = pts[idx[s:s + chunk]]
        d = ((q[:, None, :] - pts[None]) ** 2).sum(-1)
        out.append(torch.topk(d, 4, dim=1, largest=False).values[:, 1:].mean(-1))
    return torch.cat(out)


def gs_phase(torch, bc, root):
    """Phase 10: vanilla 3DGS at full width (KNN init, train_gaussians with
    densify events and an opacity reset, evaluation), the border-face
    postprocess, the refine knobs and a composite render. Returns {kernel:
    launches} of the phase."""
    from gaustar_tpu_torch.cameras import stack_cameras
    from gaustar_tpu_torch.eval import metrics
    from gaustar_tpu_torch.io.image_codec import write_png
    from gaustar_tpu_torch.models import compositor, gaussians, sugar
    from gaustar_tpu_torch.ops.knn import dist2_avg3
    from gaustar_tpu_torch.train import mesh_update, refine, train_gaussians
    from gaustar_tpu_torch.train.optimizer import spatial_lr_scale_from_cameras
    from gaustar_tpu_torch.utils.general import device_ms
    from gaustar_tpu_torch.utils.synthetic import REF_FOCAL, REF_H, REF_W, reference_scene, ring_cameras

    dev = torch.device("cuda")
    bc.reset_launch_counts()
    t_phase = time.perf_counter()
    params, config, data, raster_cfg = reference_scene("cuda")
    cams = ring_cameras(GS_CAMS, w=REF_W, h=REF_H, focal=REF_FOCAL, device="cuda")
    batch = stack_cameras(cams)
    with torch.no_grad():
        gt = torch.stack([sugar.render(params, config, c, raster_config=raster_cfg)[0] for c in cams])
        centres = sugar.gaussian_centers(params, config)
    n0 = centres.shape[0]
    rng = np.random.default_rng(0)
    pts = centres + torch.as_tensor(rng.normal(scale=GS_NOISE, size=(n0, 3)).astype(np.float32), device=dev)
    grey = torch.full((n0, 3), 0.5, device=dev)
    log("gs", f"scene: {n0} SuGaR centres + {GS_NOISE} m noise, grey; GT of the SuGaR model in {GS_CAMS} cameras "
              f"{REF_W}x{REF_H}")

    # KNN init at full width, and dist2_avg3's error against exact distances.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    p0, init_ms = device_ms(dev, lambda: gaussians.create_from_pcd(pts, grey, sh_degree=2, device="cuda"))
    peak_init = torch.cuda.max_memory_allocated() / 2**30
    d2, knn_ms = device_ms(dev, lambda: dist2_avg3(pts))
    sample = torch.as_tensor(rng.choice(n0, GS_KNN_SAMPLE, replace=False), device=dev)
    exact = knn_exact_dist2(torch, pts, sample)
    rel = ((d2[sample] - exact).abs() / exact).cpu().numpy()
    log("gs", f"create_from_pcd of {n0} points: {init_ms:.1f} ms (CUDA events; dist2_avg3 alone {knn_ms:.1f} ms, "
              f"chunk 1024), peak mem {peak_init:.2f} GiB; dist2_avg3 min {float(d2.min()):.3e} median "
              f"{float(d2.median()):.3e} max {float(d2.max()):.3e}; against exact |q - p|^2 on {GS_KNN_SAMPLE} "
              f"points: relative error median {float(np.median(rel)):.4f} max {float(rel.max()):.4f}")
    if not (torch.isfinite(d2).all() and (d2 > 0).all()):
        fail("dist2_avg3 is not finite and positive")

    # Training.
    cfg = train_gaussians.GSTrainConfig(
        iterations=GS_ITERS, sh_degree=2, sh_warmup_every=GS_SH_WARMUP, densify_from_iter=GS_DENSIFY[0],
        densify_until_iter=GS_DENSIFY[1], densification_interval=GS_DENSIFY[2],
        opacity_reset_interval=GS_OPACITY_RESET)
    lr_scale = spatial_lr_scale_from_cameras(torch.stack([c.camera_center for c in cams]))
    events = []

    def on_log(entry):
        events.append(entry)
        if "loss" in entry and not np.isfinite(entry["loss"]):
            fail(f"non-finite loss at iteration {entry['iteration']}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trained, history = train_gaussians.train_gaussians(p0, batch, gt, cfg, raster_cfg, spatial_lr_scale=lr_scale,
                                                       log_fn=on_log)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    peak_train = torch.cuda.max_memory_allocated() / 2**30
    tr = train_gaussians.last_train
    step = statistics.median(tr["step_ms"][WARMUP_STEPS:])
    dens = [e for e in events if e.get("event") == "densify"]
    log("gs", f"train_gaussians {GS_ITERS} its, spatial_lr_scale {lr_scale:.4f}: wall {t_train:.1f} s, median "
              f"iteration {step:.2f} ms (CUDA events), peak mem {peak_train:.2f} GiB; gaussians {n0} -> "
              f"{gaussians.n_points(trained)}; losses {[round(h['loss'], 5) for h in history]}")
    log("gs", "densify events (iteration, n_pruned, n_kept, n_clone, n_split, n_active): "
              f"{[tuple(e[k] for k in ('iteration', 'n_pruned', 'n_kept', 'n_clone', 'n_split', 'n_active')) for e in dens]}, "
              f"ms {[round(x, 1) for x in tr['densify_ms']]}")
    expected_its = [it for it in range(1, GS_ITERS + 1)
                    if GS_DENSIFY[0] < it < GS_DENSIFY[1] and (it + 1) % GS_DENSIFY[2] == 0]
    if [e["iteration"] for e in dens] != expected_its:
        fail(f"densify events at {[e['iteration'] for e in dens]}, expected {expected_its}")
    n_prev = n0
    for e in dens:
        if not (e["n_kept"] == n_prev - e["n_pruned"] and e["n_active"] == e["n_kept"] + e["n_clone"] + 2 * e["n_split"]):
            fail(f"densify at {e['iteration']}: counts do not add up ({e}, {n_prev} before)")
        n_prev = e["n_active"]
    if n_prev != gaussians.n_points(trained) or len(history) != GS_ITERS // 100:
        fail(f"the model has {gaussians.n_points(trained)} gaussians after the last event's {n_prev}")

    # Evaluation: the 8 views before and after training.
    with torch.no_grad():
        before = [gaussians.render(p0, c, raster_config=raster_cfg)[0] for c in cams]
        after = [gaussians.render(trained, c, raster_config=raster_cfg)[0] for c in cams]
    lpips = synthetic_lpips(root)
    (m0, m1), eval_ms = device_ms(dev, lambda: [metrics.evaluate_pairs(r, list(gt), lpips) for r in (before, after)])
    log("gs", f"evaluate_pairs over {GS_CAMS} views, at initialisation -> after training: PSNR {m0['PSNR']:.4f} -> "
              f"{m1['PSNR']:.4f} dB, SSIM {m0['SSIM']:.4f} -> {m1['SSIM']:.4f}, lpips_synthetic {m0['LPIPS']:.4f} -> "
              f"{m1['LPIPS']:.4f} (seeded synthetic VGG16 / LPIPS weights, not a real LPIPS score); {eval_ms:.1f} ms "
              f"for both (CUDA events)")
    if not all(np.isfinite(v) for m in (m0, m1) for v in m.values()):
        fail(f"non-finite metrics {m0} {m1}")
    if not m1["PSNR"] > m0["PSNR"] + GS_MIN_PSNR_GAIN:
        fail(f"PSNR after training {m1['PSNR']:.4f} dB is not {GS_MIN_PSNR_GAIN} dB above {m0['PSNR']:.4f} dB")
    rdir, gdir = os.path.join(root, "renders"), os.path.join(root, "gt")
    os.makedirs(rdir)
    os.makedirs(gdir)
    q_r, q_g = [], []
    t0 = time.perf_counter()
    for i, (r, g_) in enumerate(zip(after, gt)):
        for img, d, q in ((r, rdir, q_r), (g_, gdir, q_g)):
            u8 = (img.clamp(0, 1) * 255).round().to(torch.uint8)
            write_png(os.path.join(d, f"{i:05d}.png"), u8)
            q.append(u8.to(torch.float32) / 255.0)
    t_png = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_dir = metrics.evaluate_dirs(rdir, gdir, device="cuda")
    t_dirs = time.perf_counter() - t0
    m_q = metrics.evaluate_pairs(q_r, q_g)
    log("gs", f"8-bit PNGs: written in {t_png:.1f} s; evaluate_dirs PSNR {m_dir['PSNR']:.4f} SSIM "
              f"{m_dir['SSIM']:.4f} in {t_dirs:.1f} s, the 8-bit images in memory {m_q['PSNR']:.4f} / "
              f"{m_q['SSIM']:.4f}")
    if set(m_dir) != {"PSNR", "SSIM"} or any(abs(m_dir[k] - m_q[k]) > 1e-5 * abs(m_q[k]) for k in m_q):
        fail(f"evaluate_dirs {m_dir} differs from the 8-bit images' {m_q}")
    del before, after, trained, p0, gt
    torch.cuda.empty_cache()

    # The border-face postprocess on the SuGaR sphere with a cap cut off.
    with torch.no_grad():
        cz = params.points[config.faces].mean(dim=1)[:, 2].cpu().numpy()
    p_open, c_open = mesh_update.subset_sugar_faces(params, config, cz >= GS_CAP_Z)
    ((p_pp, c_pp), mask_pp), pp_ms = device_ms(dev, lambda: mesh_update.postprocess_border_faces(p_open, c_open))
    n_open = c_open.faces.shape[0]
    peeled = mesh_update.last_postprocess
    log("gs", f"postprocess_border_faces on {n_open} faces (cap z < {GS_CAP_Z} cut off, {6 * n_open} centres): "
              f"peeled {peeled['peeled']}, re-added {peeled['readded']}, kept {int(mask_pp.sum())}; "
              f"{pp_ms:.1f} ms (CUDA events around the call)")
    if not (peeled["peeled"] > 0 and c_pp.faces.shape[0] == int(mask_pp.sum()) == n_open - peeled["peeled"]
            + peeled["readded"] and p_pp.scales.shape[0] == 6 * c_pp.faces.shape[0]):
        fail(f"border postprocess: {peeled}, {c_pp.faces.shape[0]} faces")
    del p_open, c_open, p_pp, c_pp

    # The refine knobs.
    kcfg = refine.RefineConfig(num_iterations=GS_KNOB_ITERS, loose_bind_from=10**9, use_laplacian_smoothing=True,
                               area_reg_from=0)
    _, _, khist = refine.refine_frame(params, config, data, kcfg, raster_cfg, log_every=1)
    keys = ("laplacian_loss", "area_reg_loss", "loss")
    log("gs", f"refine_frame {GS_KNOB_ITERS} its with use_laplacian_smoothing and area_reg_from=0: "
              + ", ".join(f"{k} {[round(h[k], 6) for h in khist]}" for k in keys))
    if len(khist) != GS_KNOB_ITERS or not all(k in h and np.isfinite(h[k]) for h in khist for k in keys):
        fail(f"the knobs' losses are missing or not finite: {khist}")

    # A composite render: the model, and the same model moved with half its gaussians masked.
    n = params.scales.shape[0]
    move = torch.eye(4, device=dev)
    move[:3, 3] = torch.tensor([0.3, 0.0, 0.2], device=dev)
    entries = [compositor.CompositorEntry(params, config),
               compositor.CompositorEntry(params, config, transform=move,
                                          mask=torch.arange(n, device=dev) % 2 == 0)]
    with torch.no_grad():
        (img, aux), comp_ms = device_ms(dev, lambda: compositor.render_composite(entries, cams[0],
                                                                                 raster_config=raster_cfg))
    log("gs", f"render_composite of 2 x {n} gaussians: {comp_ms:.1f} ms, {aux.num_pairs} pairs, image "
              f"{tuple(img.shape)} mean {float(img.mean()):.4f}")
    if tuple(img.shape) != (REF_H, REF_W, 3) or not torch.isfinite(img).all():
        fail("the composite render is not a finite full-width image")

    launches = dict(bc.LAUNCHES)
    expected = {"blend_fwd": GS_CAMS + GS_ITERS + 2 * GS_CAMS + GS_KNOB_ITERS + 1,
                "blend_bwd": GS_ITERS + GS_KNOB_ITERS}
    log("gs", f"launches {launches}, expected {expected} (fwd = {GS_CAMS} GT + {GS_ITERS} training + "
              f"2 x {GS_CAMS} evaluation + {GS_KNOB_ITERS} knob + 1 composite renders; bwd = training + knob "
              f"iterations); phase wall {time.perf_counter() - t_phase:.1f} s")
    if launches != expected:
        fail(f"phase 10 launched the kernels {launches}, expected {expected}")
    return launches


def kernel_phases(torch, bc, t_start):
    """Phases 3-6: each kernel against its plain version, the refine step at
    full width, the kernels' times. Returns the kernels line's entries."""
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.train import refine
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn
    from gaustar_tpu_torch.utils.profiling import cuda_ms
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
        return (cuda_ms(lambda: bc.blend_fwd_cuda(*x, 4), iters=50),
                cuda_ms(lambda: bc.blend_bwd_cuda(*x, 4, raw, ct, split), iters=50), raw, ct, split)

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
    return kernels, median_ms


def strip_inputs(torch, inputs, d, g):
    """(strip g of d's blend inputs, its tile_base): tiles [g tpd, (g + 1) tpd)
    of the full grid's, tpd = ceil(T / d), the tail past the grid padded
    with empty tiles. tile_start still indexes the whole pair_data."""
    pd, start, count, gx, W, H = inputs
    n = start.shape[0]
    tpd = -(-n // d)
    t0, t1 = min(g * tpd, n), min((g + 1) * tpd, n)
    s = torch.zeros(tpd, dtype=torch.int32, device=start.device)
    c = torch.zeros(tpd, dtype=torch.int32, device=start.device)
    s[: t1 - t0] = start[t0:t1]
    c[: t1 - t0] = count[t0:t1]
    return (pd, s, c, gx, W, H), g * tpd


def strips_phase(torch, bc, scene):
    """Phase 11: the full-width frame (camera 0, 4 channels) blended as
    STRIP_SPLITS strips through both kernels with tile_base, against the
    full-grid launch; one strip against the plain versions. Returns
    {kernel: launches} of the strip launches and the kernels' max |error|
    against the plain versions."""
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.utils.profiling import cuda_ms
    from gaustar_tpu_torch.utils.synthetic import blend_inputs, render_inputs

    params, config, data = scene
    inputs = blend_inputs(*render_inputs(params, config, index_camera(data.cameras, 0)), 4)
    pd, start, count, gx, W, H = inputs
    n = start.shape[0]
    raw_full, split_full = bc.blend_fwd_split(*inputs, 4)
    ct = seeded_cotangent(torch, raw_full, 13)
    g_full = bc.blend_bwd_cuda(*inputs, 4, raw_full, ct, split_full)
    torch.cuda.synchronize()
    scale = g_full.abs().amax(dim=1).clamp_min(1e-30)
    bc.reset_launch_counts()
    strips = {}
    for d in STRIP_SPLITS:
        raws, grads, calls = [], torch.zeros_like(g_full), []
        for g in range(d):
            s_in, base = strip_inputs(torch, inputs, d, g)
            raw, split = bc.blend_fwd_split(*s_in, 4, base)
            live = min(n - base, raw.shape[0])
            cts = torch.zeros_like(raw)
            cts[:live] = ct[base:base + live]
            grads += bc.blend_bwd_cuda(*s_in, 4, raw, cts, split, base)
            raws.append(raw)
            calls.append((s_in, base, raw, cts, split))
        full = torch.cat(raws)
        pad = full[n:]
        fwd_equal = torch.equal(full[:n, :7], raw_full[:, :7])
        pad_empty = bool((pad[:, 3] == 1).all() and (pad[:, [0, 1, 2, 4, 5, 6, 7]] == 0).all())
        grad_rel = float(((grads - g_full).abs().amax(dim=1) / scale).max())
        strips[d] = dict(calls=calls, fwd_equal=fwd_equal, grad_rel=grad_rel, grad_equal=torch.equal(grads, g_full),
                         pad=pad.shape[0], pad_empty=pad_empty)
        if not fwd_equal or not pad_empty:
            fail(f"{d} strips: the forward differs from the full-grid launch (rows 0-6 equal {fwd_equal}, "
                 f"padding empty {pad_empty})")
        if not grad_rel <= STRIP_GRAD_RTOL:
            fail(f"{d} strips: gradients differ from the full-grid launch by {grad_rel:.3e} of the inf-norm")
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    expected = {"blend_fwd": sum(STRIP_SPLITS), "blend_bwd": sum(STRIP_SPLITS)}

    fwd_ms = cuda_ms(lambda: bc.blend_fwd_cuda(*inputs, 4), iters=20)
    bwd_ms = cuda_ms(lambda: bc.blend_bwd_cuda(*inputs, 4, raw_full, ct, split_full), iters=20)
    for d, r in strips.items():
        f_ms = [cuda_ms(lambda c=c: bc.blend_fwd_cuda(*c[0], 4, c[1]), iters=20) for c in r["calls"]]
        b_ms = [cuda_ms(lambda c=c: bc.blend_bwd_cuda(*c[0], 4, c[2], c[3], c[4], c[1]), iters=20)
                for c in r["calls"]]
        log("strips", f"D_g={d}: {len(r['calls'])} strips of {r['calls'][0][0][1].shape[0]} tiles ({r['pad']} of "
                      f"padding, empty); forward rows 0-6 bit-equal to the full grid {r['fwd_equal']}; gradients "
                      f"max |d| / |g|_inf {r['grad_rel']:.3e}, bit-equal {r['grad_equal']}; strip ms fwd "
                      f"{[round(x, 4) for x in f_ms]} bwd {[round(x, 4) for x in b_ms]} (full grid fwd {fwd_ms:.4f} "
                      f"bwd {bwd_ms:.4f}; 20-call means, CUDA events)")
    del strips

    # One strip against the plain versions, on its 64 busiest tiles (phases 3-4's tolerances).
    s_in, base = strip_inputs(torch, inputs, 3, 1)
    s_pd, s_start, s_count = s_in[:3]
    keep = torch.topk(s_count, 64).indices
    s_in = (s_pd, s_start, torch.zeros_like(s_count).index_copy_(0, keep, s_count[keep]), *s_in[3:])
    raw, split, fwd_err, _ = check_forward(torch, bc, s_in, 4, f"strip 2 of 3 (tile_base {base}), top-64 tiles",
                                           tile_base=base)
    bwd_err, _ = check_backward(torch, bc, s_in, 4, raw, split, f"strip 2 of 3 (tile_base {base}), top-64 tiles",
                                tile_base=base)
    log("strips", f"launches {launches}, expected {expected} (one forward and one backward per strip)")
    if launches != expected:
        fail(f"the strips launched the kernels {launches}, expected {expected}")
    return launches, {"blend_fwd": fwd_err, "blend_bwd": bwd_err}


def dist_rank(rank, world, init, out, mode):
    """One rank of phase 12 (a spawned process; every rank on the one card,
    gloo). `mode` "camera_dp": make_sharded_train_step, DIST_B cameras a
    rank; "gauss2d": make_gauss2d_train_step on cam = world / DIST_GAUSS x
    gauss = DIST_GAUSS, one camera a rank. One SGD(lr 1) step, whose
    gradients (captured as the step applies them) are held to this
    process's single-process step on the same cameras, then DIST_ADAM_STEPS
    Adam steps and DIST_TIMED_STEPS with the collectives timed. Writes its
    report to out/rank<r>.pt."""
    import torch

    from gaustar_tpu_torch.models import sugar
    from gaustar_tpu_torch.ops import blend_cuda as bc
    from gaustar_tpu_torch.parallel import collectives, gauss2d, launch, sharding
    from gaustar_tpu_torch.train import refine
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam, adam_init, make_lr_fn, sgd
    from gaustar_tpu_torch.utils.synthetic import reference_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    launch.initialize(rank, world, init)
    params, config, data, rcfg = reference_scene("cuda")
    cfg = refine.RefineConfig(num_iterations=100, loose_bind_from=10**9, do_sh_warmup=False)
    sh_deg = config.sh_levels - 1
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    n_cams = data.gt_images.shape[0]
    if mode == "camera_dp":
        mesh = sharding.make_camera_mesh()
        p = sugar.fresh_params(params)
        rows = slice(None)
        cams = list(range(DIST_B))
        ref_cams = list(range(n_cams))
        make = lambda update: sharding.make_sharded_train_step(config, data, cfg, rcfg, update, mesh)  # noqa: E731
    else:
        mesh = launch.make_mesh(gauss=DIST_GAUSS)
        p, _ = gauss2d.shard_sugar(params, config, mesh.gauss, mesh.gauss_rank)
        rows = gauss2d.shard_bounds(params.scales.shape[0], mesh.gauss, mesh.gauss_rank)
        cams = 0
        ref_cams = [c * (n_cams // mesh.cam) for c in range(mesh.cam)]
        make = lambda update: gauss2d.make_gauss2d_train_step(config, data, cfg, update, mesh)  # noqa: E731
    grads = {}

    def sgd_captured(params_, grads_, state):
        grads.update({k: g.clone() for k, g in grads_.items()})
        sgd(1.0)(params_, grads_, state)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bc.reset_launch_counts()
    collectives.reset_counters()
    t0 = time.perf_counter()
    loss_sgd, aux = make(sgd_captured)(sh_deg)(p, None, cams, 1)
    torch.cuda.synchronize()
    sgd_wall = time.perf_counter() - t0
    opt = adam_init(p)
    step = make(adam(lr_fn))(sh_deg)
    collectives.reset_counters()
    walls, losses = [], []
    for it in range(2, 2 + DIST_ADAM_STEPS):
        t0 = time.perf_counter()
        loss, aux = step(p, opt, cams, it)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    step_bytes = {k: v / DIST_ADAM_STEPS for k, v in collectives.BYTES.items()}
    # The collectives' share of a step: each one timed alone, the card synchronised around it.
    collectives.reset_counters(timed=True)
    timed_walls = []
    for it in range(2 + DIST_ADAM_STEPS, 2 + DIST_ADAM_STEPS + DIST_TIMED_STEPS):
        t0 = time.perf_counter()
        loss, aux = step(p, opt, cams, it)
        torch.cuda.synchronize()
        timed_walls.append(time.perf_counter() - t0)
        losses.append(float(loss))
    step_coll_s = {k: v / DIST_TIMED_STEPS for k, v in collectives.SECONDS.items()}
    collectives.reset_counters()
    launches = dict(bc.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30

    # The single-process step on the same cameras, in this process.
    loss_ref, _ = refine.compute_losses_multi(params, config, data, ref_cams, 1, cfg, rcfg, sh_deg)
    g_ref = refine.named_grads(loss_ref, params)
    errs, worst = {}, 0.0
    for k, g in grads.items():
        a = g_ref[k] if k == "points" else g_ref[k][rows]
        scale = float(a.abs().max())
        excess = (g - a).abs() - DIST_RTOL * a.abs() - max(DIST_RTOL * scale, DIST_ATOL_FLOOR)
        errs[k] = (float((g - a).abs().max()), scale)
        worst = max(worst, float(excess.max()))
    torch.save({"rank": rank, "cam_rank": mesh.cam_rank, "gauss_rank": mesh.gauss_rank,
                "backend": launch.runtime_info()["backend"], "loss_sgd": float(loss_sgd), "loss_ref": float(loss_ref.detach()),
                "grad_err": errs, "ok": worst <= 0.0, "adam_losses": losses, "sgd_wall": sgd_wall, "walls": walls,
                "timed_walls": timed_walls, "step_coll_s": step_coll_s, "num_pairs": aux["num_pairs"], "step_bytes": step_bytes, "launches": launches, "peak_gb": peak},
               os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def dist_phase(torch):
    """Phase 12: the camera-DP and gauss2d steps at full width, on ranks
    spawned on the one card (gloo, file:// rendezvous in a temporary
    directory). Returns {kernel: launches} summed over every rank."""
    import torch.multiprocessing as mp

    total = {"blend_fwd": 0, "blend_bwd": 0}
    steps = 1 + DIST_ADAM_STEPS + DIST_TIMED_STEPS
    runs = (("camera_dp", DIST_CAM_RANKS, steps * DIST_B), ("gauss2d", 2 * DIST_GAUSS, steps))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as root:
        for mode, world, per_rank in runs:
            out = os.path.join(root, mode)
            os.makedirs(out)
            t0 = time.perf_counter()
            ctx = mp.start_processes(dist_rank, args=(world, f"file://{os.path.join(out, 'rendezvous')}", out, mode),
                                     nprocs=world, join=False, start_method="spawn")
            while not ctx.join(timeout=5):
                if time.perf_counter() - t0 > DIST_TIMEOUT_S:
                    for proc in ctx.processes:
                        proc.kill()
                    fail(f"{mode}: the ranks did not finish in {DIST_TIMEOUT_S} s")
            wall = time.perf_counter() - t0
            ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]
            expected = {"blend_fwd": per_rank, "blend_bwd": per_rank}
            for r in ranks:
                log("dist", f"{mode} rank {r['rank']} (cam {r['cam_rank']}, gauss {r['gauss_rank']}; {world} ranks "
                            f"sharing one card over {r['backend']}): SGD step loss {r['loss_sgd']:.6f} vs the "
                            f"single-process step's {r['loss_ref']:.6f}; gradients (max |d|, |g|_inf) "
                            f"{ {k: (float(f'{d:.2e}'), float(f'{g:.2e}')) for k, (d, g) in r['grad_err'].items()} } "
                            f"within rtol {DIST_RTOL}, atol max({DIST_RTOL} |g|_inf, {DIST_ATOL_FLOOR}) {r['ok']}; step wall SGD {1e3 * r['sgd_wall']:.1f} ms, Adam "
                            f"{[round(1e3 * w, 1) for w in r['walls']]} ms (median "
                            f"{1e3 * statistics.median(r['walls']):.1f}); Adam losses "
                            f"{[round(x, 6) for x in r['adam_losses']]}; bytes per step into collectives "
                            f"{ {k: int(v) for k, v in r['step_bytes'].items()} }; collectives timed alone (card "
                            f"synchronised around each) ms per step "
                            f"{ {k: round(1e3 * v, 2) for k, v in r['step_coll_s'].items()} } of timed step walls "
                            f"{[round(1e3 * w, 1) for w in r['timed_walls']]} ms, share "
                            f"{sum(r['step_coll_s'].values()) / statistics.mean(r['timed_walls']):.3f}; num_pairs {r['num_pairs']}; peak "
                            f"{r['peak_gb']:.2f} GiB; launches {r['launches']}")
                if not r["ok"]:
                    fail(f"{mode} rank {r['rank']}: the gradients differ from the single-process step's")
                if abs(r["loss_sgd"] - r["loss_ref"]) > 1e-4 * abs(r["loss_ref"]):
                    fail(f"{mode} rank {r['rank']}: loss {r['loss_sgd']} vs {r['loss_ref']}")
                if not all(np.isfinite(r["adam_losses"])):
                    fail(f"{mode} rank {r['rank']}: non-finite Adam loss {r['adam_losses']}")
                if r["launches"] != expected:
                    fail(f"{mode} rank {r['rank']} launched the kernels {r['launches']}, expected {expected}")
                for k in total:
                    total[k] += r["launches"][k]
            log("dist", f"{mode}: {world} ranks, phase wall {wall:.1f} s (spawn, scene, steps, reference); launches "
                        f"per rank as expected {expected} ({per_rank // steps} camera(s) x {steps} steps)")
    return total


def tools_phase(torch, bc, scene, refine_median_ms):
    """Phase 13: registration on the card (ICP recovers a known rigid T from
    the model's vertices; the moved model's render against the moved
    camera's), the model cut and recolour, profiling.loop_bench of the
    refine step against phase 5's median, and profiling.trace of one step.
    Returns {kernel: launches} of the phase."""
    from gaustar_tpu_torch.cameras import Camera, index_camera
    from gaustar_tpu_torch.models import sugar
    from gaustar_tpu_torch.ops.sh import sh_to_rgb_dc
    from gaustar_tpu_torch.tools import registration as reg
    from gaustar_tpu_torch.train import refine
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn
    from gaustar_tpu_torch.utils import profiling

    params, config, data = scene
    axis = np.array([1.0, 2.0, 2.0]) / 3.0
    kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(TOOLS_T_ANGLE) * kx + (1 - np.cos(TOOLS_T_ANGLE)) * kx @ kx
    T[:3, 3] = TOOLS_T_SHIFT
    bc.reset_launch_counts()
    moved = reg.transform_model(params, config, T)
    src = params.points.detach().double().cpu().numpy()
    dst = moved.points.detach().double().cpu().numpy()
    t0 = time.perf_counter()
    T_est, hist = reg.icp(src, dst)
    icp_ms = 1e3 * (time.perf_counter() - t0)
    t_err = float(np.abs(T_est - T).max())

    cam = index_camera(data.cameras, 0)
    w2c = np.eye(4)
    w2c[:3, :3] = cam.R.T.cpu().numpy()
    w2c[:3, 3] = cam.T.cpu().numpy()
    w2c_moved = w2c @ np.linalg.inv(T)  # the camera moved with the model
    cam_moved = Camera.from_w2c(w2c_moved, float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                                cam.width, cam.height, device="cuda")
    with torch.no_grad():
        img, aux = sugar.render(moved, config, cam_moved, bg=(0.0, 1.0, 0.0))
        img0, _ = sugar.render(params, config, cam, bg=(0.0, 1.0, 0.0))
    mse = float(((img - img0) ** 2).mean())
    psnr = -10.0 * np.log10(max(mse, 1e-30))
    cut_p, cut_c = reg.cut_model_by_box(params, config, np.array([[-10.0, -10.0, -10.0], [10.0, 0.0, 10.0]]))
    red = reg.recolor_model(cut_p, factor=(0.0, 0.0, 0.0), offset=(1.0, 0.0, 0.0))
    rgb = sh_to_rgb_dc(red.sh_dc.detach())
    log("tools", f"registration: ICP on {len(src)} vertices recovered T (angle {TOOLS_T_ANGLE} rad, shift "
                 f"{TOOLS_T_SHIFT} m) to max |d T| {t_err:.2e} in {len(hist)} iterations, {icp_ms:.1f} host ms, "
                 f"rms {hist[0]:.3e} -> {hist[-1]:.3e}; the moved model's render against the moved camera's: "
                 f"PSNR {psnr:.2f} dB, {aux.num_pairs} pairs; cut to y < 0: {cut_c.faces.shape[0]} of "
                 f"{config.faces.shape[0]} faces; recolour red: max |rgb - (1, 0, 0)| "
                 f"{float((rgb - torch.tensor([1.0, 0.0, 0.0], device='cuda')).abs().max()):.2e}")
    if not t_err <= TOOLS_MAX_T_ERR:
        fail(f"ICP did not recover the transform: max |d T| {t_err:.3e}")
    if not psnr >= TOOLS_MIN_PSNR:
        fail(f"the moved model's render differs from the moved camera's: PSNR {psnr:.2f} dB")
    if not 0 < cut_c.faces.shape[0] < config.faces.shape[0] or cut_p.scales.shape[0] != 6 * cut_c.faces.shape[0]:
        fail(f"the cut kept {cut_c.faces.shape[0]} faces")
    if not float((rgb - torch.tensor([1.0, 0.0, 0.0], device="cuda")).abs().max()) < 1e-5:
        fail("recolor_model did not set the colour")

    cfg = refine.RefineConfig(num_iterations=ITERS, loose_bind_from=10**9, do_sh_warmup=False)
    p = sugar.fresh_params(params)
    opt = adam_init(p)
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    rcfg = refine.RasterConfig()

    def one_step(i):
        refine.train_step(p, opt, lr_fn, config, data, i % data.gt_images.shape[0], i + 1, cfg, rcfg, 2)

    bench_ms = 1e3 * profiling.loop_bench(one_step, iters=TOOLS_BENCH_ITERS, device="cuda")
    host_ms = []  # the same steps on the host clock, synchronised each step, as phase 5 times them
    for i in range(TOOLS_BENCH_ITERS):
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t0))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_trace_") as tdir:
        with profiling.trace(tdir) as tr:
            one_step(0)
        from torch.autograd import DeviceType

        names = [e.name for e in tr.prof.events() if e.device_type == DeviceType.CUDA]
        blend = sorted({m.group(0) for m in (re.search(r"blend_\w+", x) for x in names) if m})
        trace_kb = os.path.getsize(os.path.join(tdir, "trace.json")) / 1024
    torch.cuda.synchronize()
    launches = dict(bc.LAUNCHES)
    steps = 1 + 2 * TOOLS_BENCH_ITERS + 1
    expected = {"blend_fwd": 2 + steps, "blend_bwd": steps}
    log("tools", f"profiling.loop_bench: refine step {bench_ms:.2f} ms per iteration ({TOOLS_BENCH_ITERS} "
                 f"iterations between CUDA events) against phase 5's median {refine_median_ms:.2f} ms (host "
                 f"clock) and this phase's host-clock median of the next {TOOLS_BENCH_ITERS} steps "
                 f"{statistics.median(host_ms):.2f} ms; profiling.trace of one step: {len(names)} CUDA kernel events, blend kernels {blend}, "
                 f"{trace_kb:.0f} KiB Chrome trace; launches {launches}, expected {expected} (2 renders, "
                 f"{steps} steps)")
    if not blend:
        fail("the trace shows no blend kernel")
    if launches != expected:
        fail(f"phase 13 launched the kernels {launches}, expected {expected}")
    return launches


def refscale_phase(torch, bc):
    """Phase 14: the reference-scale runs through their modules' entry
    functions. Returns {kernel: launches} summed over the four runs."""
    from gaustar_tpu_torch.refscale import frame, real, scenes, seq, warp160
    from gaustar_tpu_torch.utils.synthetic import reference_scene

    total = {"blend_fwd": 0, "blend_bwd": 0}

    def counted(label, expected):
        got = dict(bc.LAUNCHES)
        log("refscale", f"{label}: launches {got}, expected {expected}")
        if got != expected:
            fail(f"refscale {label} launched the kernels {got}, expected {expected}")
        for k in total:
            total[k] += got[k]

    def finite(label, segments):
        bad = [s for s in segments if s["first_nonfinite_chunk_it"] is not None or not np.isfinite(s["loss_sum"])]
        if bad:
            fail(f"refscale {label}: non-finite loss in {bad}")

    # The frame.
    t0 = time.perf_counter()
    params, config, data, rcfg = reference_scene("cuda")
    data = scenes.reference_rig(data, REFSCALE_FRAME_CAMS)
    torch.cuda.synchronize()
    log("refscale", f"frame: scene and {REFSCALE_FRAME_CAMS}-camera rig built in {time.perf_counter() - t0:.1f} s")
    bc.reset_launch_counts()
    res = frame.run(params, config, data, rcfg, REFSCALE_FRAME_ITERS, log=lambda m: log("refscale", f"frame: {m}"))
    rep = res["report"]
    finite("frame refine", rep["refine"]["segments"])
    if rep["cc_update_num"] < 1:
        fail(f"refscale frame: the surgery grafted nothing (cc_update_num {rep['cc_update_num']})")
    finite("frame re-refine", rep["re_refine"]["segments"])
    if not REFSCALE_FUSED_FACES[0] <= rep["fusion_faces"] <= REFSCALE_FUSED_FACES[1]:
        fail(f"refscale frame: {rep['fusion_faces']} fused faces, expected {REFSCALE_FUSED_FACES}")
    log("refscale", "frame: " + json.dumps({k: v for k, v in rep.items() if k not in ("refine", "re_refine")}))
    log("refscale", f"frame: ms per iteration refine {[round(s['ms_per_iter'], 2) for s in rep['refine']['segments']]} "
                    f"(spread {rep['refine']['ms_per_iter_spread_pct']:.1f}%), re-refine "
                    f"{[round(s['ms_per_iter'], 2) for s in rep['re_refine']['segments']]}")
    its = REFSCALE_FRAME_ITERS + REFSCALE_FRAME_ITERS // 2
    counted("frame", {"blend_fwd": its + 2 * 2 * REFSCALE_FRAME_CAMS + rep["fusion_views"], "blend_bwd": its})
    del params, config, data, res
    torch.cuda.empty_cache()

    # The sequence.
    with tempfile.TemporaryDirectory(prefix="chip_smoke_refseq_") as root:
        bc.reset_launch_counts()
        rep = seq.run(root, REFSCALE_SEQ_ITERS, REFSCALE_SEQ_CAMS, log=lambda m: log("refscale", f"seq: {m}"))
    log("refscale", "seq: " + json.dumps({k: v for k, v in rep.items() if k != "stages"}))
    for d in rep["pair_demand"]:
        log("refscale", f"seq: detection at iteration {d['iteration']}: pair demand normal {d['detect_max_pairs']}, "
                        f"solid {d['detect_max_pairs_solid']}; the refine's largest before it "
                        f"{d['refine_max_pairs']} (solid / refine {d['solid_over_refine']:.4f})")
    if not (rep["frame0_ckpt"] and rep["frame1_ckpt"]):
        fail(f"refscale seq: a frame wrote no checkpoint: {rep['frame0_ckpt']}, {rep['frame1_ckpt']}")
    names = [s["stage"] for s in rep["stages"]]
    n_refines = names.count("refine_frame")
    bwd = 2 * REFSCALE_SEQ_ITERS + (n_refines - 2) * (REFSCALE_SEQ_ITERS // 2)
    views = sum(s["views"] for s in rep["stages"] if s["stage"] == "extract_mesh_fusion")
    counted(f"seq ({n_refines} refines, {names.count('detect_topo_err')} detections, {views} fusion views)",
            {"blend_fwd": bwd + 2 * REFSCALE_SEQ_CAMS * names.count("detect_topo_err") + views, "blend_bwd": bwd})
    torch.cuda.empty_cache()

    # The real capture: GT renders, refine, detection on the full rig, fusion.
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    bc.reset_launch_counts()
    cap = real.capture(REFSCALE_REAL_CAMS, rng, torch.device("cuda"))
    params, config, topo, hist = real.refine_body(cap, REFSCALE_REAL_ITERS, torch.device("cuda"))
    if len(hist) != REFSCALE_REAL_ITERS // 50 or not all(np.isfinite(h["loss"]) for h in hist):
        fail(f"refscale real: refine history {hist}")
    det_cams, det_depths = real.detection_rig(cap, REFSCALE_REAL_DETECT_CAMS, torch.device("cuda"))
    rows = real.detection(params, config, topo, det_cams, det_depths, real.changed_faces(cap["body_v"], cap["body_f"]),
                          log=lambda m: log("refscale", f"real: {m}"))
    fus = real.fusion(params, config, cap["cams"], torch.device("cuda"))
    log("refscale", f"real: GT render {cap['gt_render_s']:.1f} s, final loss {hist[-1]['loss']:.5f}, fusion {fus}; "
                    f"wall {time.perf_counter() - t0:.1f} s")
    log("refscale", f"real: detection pair demand (normal, solid) {[(r['max_pairs'], r['max_pairs_solid']) for r in rows.values()]}"
                    f"; the refine's largest at its logged iterations {max(int(h['num_pairs']) for h in hist)}")
    counted("real", {"blend_fwd": REFSCALE_REAL_CAMS + REFSCALE_REAL_ITERS
                     + 2 * REFSCALE_REAL_DETECT_CAMS * len(real.DETECTORS) + fus["views"],
                     "blend_bwd": REFSCALE_REAL_ITERS})
    del cap, params, config, rows, det_depths
    torch.cuda.empty_cache()

    # The 160-camera warp.
    bc.reset_launch_counts()
    rep, _ = warp160.run(REFSCALE_WARP_CAMS, log=lambda m: None)
    log("refscale", "warp160: " + json.dumps(rep))
    if not rep["motion_err_mean_mm"] < REFSCALE_MAX_WARP_ERR_MM:
        fail(f"refscale warp160: mean motion error {rep['motion_err_mean_mm']:.3f} mm")
    counted("warp160", {"blend_fwd": 0, "blend_bwd": 0})
    return total


def demo_phase(torch, bc):
    """Phase 15: the end-to-end demo at its own size. Returns {kernel:
    launches} of the run."""
    from gaustar_tpu_torch import demo

    with tempfile.TemporaryDirectory(prefix="chip_smoke_demo_") as root:
        bc.reset_launch_counts()
        rep = demo.run(root, DEMO_ITERS, device="cuda", log=lambda m: log("demo", m))
        launches = dict(bc.LAUNCHES)
    log("demo", json.dumps({k: v for k, v in rep.items() if k not in ("stages", "detection_and_unbind")}))
    for d in rep["pair_demand"]:
        log("demo", f"detection at iteration {d['iteration']}: pair demand normal {d['detect_max_pairs']}, solid "
                    f"{d['detect_max_pairs_solid']}; the refine's largest before it {d['refine_max_pairs']} "
                    f"(solid / refine {d['solid_over_refine']:.4f})")
    f0, f1 = rep["frames"]
    unbound = [e["loose_bind"] for e in rep["detection_and_unbind"] if "unbind_changed" in e]
    log("demo", f"PSNR cam 0: frame 0 {f0['psnr_cam0']:.4f} dB, frame 1 {f1['psnr_cam0']:.4f} dB; loose bind per "
                f"frame {unbound}; cc_update_num {f0['cc_update_num']}, {f1['cc_update_num']}; faces {f0['faces']}, "
                f"{f1['faces']}; run_sequence {rep['seq_seconds']:.1f} s, dataset {rep['dataset_build_s']:.1f} s, peak "
                f"mem {rep.get('peak_memory_bytes', 0) / 2**30:.2f} GiB")
    if not rep["losses_finite"]:
        fail("demo: a non-finite loss")
    # At this size frame 0 loose-binds too, as it does through the JAX
    # package on the same model (DEMO_LOOSE_BIND; PERF.md).
    if unbound != DEMO_LOOSE_BIND:
        fail(f"demo: loose bind per frame {unbound}, expected {DEMO_LOOSE_BIND}")
    if not all(f["updated"] and (f["cc_update_num"] or 0) >= 1 for f in (f0, f1)):
        fail(f"demo: a loose-bound frame grafted nothing (cc_update_num {f0['cc_update_num']}, {f1['cc_update_num']})")
    names = [s["stage"] for s in rep["stages"]]
    its = 2 * DEMO_ITERS + (names.count("refine_frame") - 2) * (DEMO_ITERS // 2)
    views = sum(s["views"] for s in rep["stages"] if s["stage"] == "extract_mesh_fusion")
    gt = 2 * 2 * demo.N_CAMS  # an image and a solid depth per camera and frame
    expected = {"blend_fwd": gt + its + 2 * demo.N_CAMS * names.count("detect_topo_err") + views + 2, "blend_bwd": its}
    log("demo", f"launches {launches}, expected {expected} ({gt} GT renders, {its} iterations, "
                f"{names.count('detect_topo_err')} detections, {views} fusion views, 2 PSNR renders)")
    if launches != expected:
        fail(f"demo launched the kernels {launches}, expected {expected}")
    return launches


def bench_phase(torch, bc):
    """Phase 16: the bench at each of BENCH_BATCHES on the reference scene,
    then the camera-DP scaling harness on the cards. Returns {kernel:
    launches} summed over the bench runs and the scaling ranks."""
    from gaustar_tpu_torch import bench, bench_scaling
    from gaustar_tpu_torch.utils.synthetic import reference_scene

    kind = torch.cuda.get_device_name(0)
    scene = reference_scene("cuda")
    n_gauss = scene[0].scales.shape[0]
    steps = bench.WARMUP + bench.STEPS
    total = {"blend_fwd": 0, "blend_bwd": 0}
    for batch in BENCH_BATCHES:
        bc.reset_launch_counts()
        rec = bench.run(*scene, batch)
        launches = dict(bc.LAUNCHES)
        log("bench", json.dumps(bench.result(scene[2], batch, rec["step_s"], n_gauss, kind)))
        log("bench", f"B={batch}: step {1e3 * rec['step_s']:.3f} ms ({bench.STEPS} steps after {bench.WARMUP}, "
                     f"those {rec['warmup_s']:.2f} s); peak {rec['peak_bytes'] / 2**30:.3f} GiB; largest num_pairs "
                     f"per step {rec['num_pairs']}; loss {rec['losses'][0]:.5f} -> {rec['losses'][-1]:.5f}; "
                     f"launches {launches}")
        if not all(np.isfinite(rec["losses"])):
            fail(f"bench B={batch}: a non-finite loss {rec['losses']}")
        expected = {"blend_fwd": steps * batch, "blend_bwd": steps * batch}
        if launches != expected:
            fail(f"bench B={batch} launched the kernels {launches}, expected {expected}")
        if batch == 4 and rec["num_pairs"][0] != JAX_DEMAND_PAIRS:
            fail(f"bench B=4: the first step's largest num_pairs {rec['num_pairs'][0]}, expected {JAX_DEMAND_PAIRS}")
        total = {k: total[k] + launches[k] for k in total}
    del scene
    torch.cuda.empty_cache()

    rep = bench_scaling.run("cuda")
    log("bench", json.dumps(rep))
    cards = torch.cuda.device_count()
    sizes = [int(n) for n in rep["detail"]]
    if rep["cards"] != cards or max(sizes) > cards:
        fail(f"bench_scaling ran sizes {sizes} on {rep['cards']} of {cards} cards")
    for n, d in rep["detail"].items():
        per_kernel = int(n) * (1 + bench_scaling.STEPS) * bench_scaling.CAMS_PER_RANK
        if not all(np.isfinite(d["losses"])) or d["launches"] != {"blend_fwd": per_kernel, "blend_bwd": per_kernel}:
            fail(f"bench_scaling at {n} ranks: losses {d['losses']}, launches {d['launches']}, expected {per_kernel}")
        total = {k: total[k] + d["launches"][k] for k in total}
    if cards == 1 and rep["value"] is not None:
        fail("bench_scaling reported an efficiency on one card")
    return total


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

    kernels, median_ms = kernel_phases(torch, bc, t_start)
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
    torch.cuda.empty_cache()
    # 9 the dataset preparation
    t0 = time.perf_counter()
    prep_launches = prep_phase(torch, bc)
    log("prep", f"phase wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # 10 vanilla 3DGS, evaluation, the border postprocess, the knobs, a composite
    with tempfile.TemporaryDirectory(prefix="chip_smoke_gs_") as root:
        gs_launches = gs_phase(torch, bc, root)
    torch.cuda.empty_cache()
    # 11 strips: the kernels' tile_base
    from gaustar_tpu_torch.utils.synthetic import reference_scene

    t0 = time.perf_counter()
    scene = reference_scene("cuda")[:3]
    strip_launches, strip_errs = strips_phase(torch, bc, scene)
    log("strips", f"phase wall {time.perf_counter() - t0:.1f} s")
    # 12 dist: the camera-DP and gauss2d steps on ranks sharing the card
    t0 = time.perf_counter()
    dist_launches = dist_phase(torch)
    log("dist", f"phase wall {time.perf_counter() - t0:.1f} s")
    # 13 tools: registration and profiling
    t0 = time.perf_counter()
    tools_launches = tools_phase(torch, bc, scene, median_ms)
    log("tools", f"phase wall {time.perf_counter() - t0:.1f} s")
    del scene
    torch.cuda.empty_cache()
    # 14 refscale: the reference-scale runs
    t0 = time.perf_counter()
    refscale_launches = refscale_phase(torch, bc)
    log("refscale", f"phase wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # 15 demo: the end-to-end demo with its topology change
    t0 = time.perf_counter()
    demo_launches = demo_phase(torch, bc)
    log("demo", f"phase wall {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    # 16 bench: the refine step's throughput and the camera-DP scaling harness
    t0 = time.perf_counter()
    bench_launches = bench_phase(torch, bc)
    log("bench", f"phase wall {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k["launches_topo"] = topo_launches[k["name"]]
        k["launches_seq"] = seq_launches[k["name"]]
        k["launches_prep"] = prep_launches.get(k["name"], 0)
        k["launches_gs"] = gs_launches[k["name"]]
        k["launches_strips"] = strip_launches[k["name"]]
        k["launches_dist"] = dist_launches[k["name"]]
        k["launches_tools"] = tools_launches[k["name"]]
        k["launches_refscale"] = refscale_launches[k["name"]]
        k["launches_demo"] = demo_launches[k["name"]]
        k["launches_bench"] = bench_launches[k["name"]]
        k["max_abs_err_strip"] = strip_errs[k["name"]]
    kernels[0]["max_abs_err_fwd_only"] = fwd_only_err
    log("done", f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
