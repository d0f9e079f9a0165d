"""The refine step's throughput on one card (counterpart of the JAX
repository's bench.py).

    python -m gaustar_tpu_torch.bench [--batch 4] [--steps 8] [--detail PATH] [--device cuda]

One step is bench.py's (:155-201): train/refine.py:train_step on
utils/synthetic.reference_scene, the port of bench.py:build_scene (a
100,000-face sphere x 6 gaussians a face = 600,000 gaussians, four ring
cameras at 1600x1024): the fused RGB + depth render at SH degree 2, the
margin-masked 0.8 L1 + 0.2 DSSIM, the depth and mask losses, the mesh
losses, the backward and the named-group Adam of OptimizationParams() at
spatial lr scale 1.0, under RefineConfig(num_iterations=2000,
loose_bind_from=10**9, do_sh_warmup=False) with zero unbind weights and a
zero pre_sh_dc. A batch of B > 1 cameras runs compute_losses_multi (the
gaussian primitives once, then B renders and B loss stacks) and one Adam
step. The cameras cycle as at bench.py:171-176: step `it` renders camera
it % 4 at B = 1 and cameras (it * B + b) % 4, b < B, at B > 1.

Timing: WARMUP steps (the kernels' first build, the allocator's growth),
then `--steps` steps on the host clock, the window closed by
torch.cuda.synchronize(). Mpix/s = W * H * B / step (bench.py:220).

Output: the last line on stdout is one JSON object with the keys metric,
value (Mpix/s), unit, batch, ms_per_camera and device (the card's name, or
"cpu"). Stderr gets the card's nvidia-smi name and power limit, the step
ms and setup s, the gaussian count, the largest num_pairs over a step's
cameras and the peak of torch.cuda.max_memory_allocated. `--detail PATH`
times the stages of bench_detail (bench.py:251-310) on camera 0, each a
utils/profiling.loop_bench of DETAIL_ITERS calls: preprocess + binning +
the pair gather, the render forward and the render forward + backward; it
writes them to PATH as JSON and echoes them to stderr (the blend kernels'
own device time is the benchmark's `raster_fwd_device_ms` and blend
rooflines). `--width`, `--height`, `--lat` and `--lon` shrink the scene
(the CPU tests).

What bench.py has that this module does not, and why:
  - the persistent jit cache (:35-48): nothing here is traced or compiled
    but the two blend kernels, which ops/_build.py builds once per source;
  - GAUSTAR_BENCH_AUTOCAPS (:135) and GAUSTAR_BENCH_CHUNK (:109): static
    pair capacities and the scan's chunk; the port sizes every buffer
    exactly from each render's own pair count;
  - GAUSTAR_BENCH_BATCH_IMPL=scan (:188): the scanned camera batch serves
    compile reuse and is not ported, by design (ROADMAP);
  - vs_baseline: a ratio to an estimate that was never measured on a card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from gaustar_tpu_torch.cameras import index_camera
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import binning
from gaustar_tpu_torch.ops.projection import TILE, preprocess
from gaustar_tpu_torch.refscale.common import device_record, sync
from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn
from gaustar_tpu_torch.train.refine import RefineConfig, train_step
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.profiling import loop_bench
from gaustar_tpu_torch.utils.synthetic import REF_H, REF_LAT, REF_LON, REF_W, reference_scene

SH_DEG = 2
WARMUP = 3
STEPS = 8  # timed steps (bench.py's K)
DETAIL_ITERS = 8
BG = (0.0, 1.0, 0.0)
CFG = RefineConfig(num_iterations=2000, loose_bind_from=10**9, do_sh_warmup=False)


def step_cameras(it: int, batch: int, n_cams: int = 4):
    """The cameras of step `it`: an int at B = 1, a list of B at B > 1."""
    if batch == 1:
        return it % n_cams
    return [(it * batch + b) % n_cams for b in range(batch)]


def make_step(params, config, data, raster_cfg, batch: int):
    """(params, step): a fresh copy of `params` and step(it) -> (loss,
    loss_dict), one bench step of train_step that updates that copy and its
    Adam state in place."""
    params = sugar.fresh_params(params)
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    opt_state = adam_init(params)
    unbind_weight = torch.zeros(params.scales.shape[0], device=params.scales.device)
    pre_sh_dc = params.sh_dc.detach()[:, 0, :] * 0.0
    n_cams = data.gt_images.shape[0]

    def step(it: int):
        return train_step(params, opt_state, lr_fn, config, data, step_cameras(it, batch, n_cams), it, CFG,
                          raster_cfg, SH_DEG, unbind_weight, pre_sh_dc)

    return params, step


def run(params, config, data, raster_cfg, batch: int = 4, steps: int = STEPS) -> dict:
    """Steps 0 .. WARMUP - 1, then `steps` timed steps. Returns step_s (the
    timed steps' mean), warmup_s, every step's loss and largest num_pairs
    over its cameras (warm-up steps first), and on a card the peak bytes of
    the run."""
    dev = params.points.device
    _, step = make_step(params, config, data, raster_cfg, batch)
    losses, pairs = [], []

    def steps_from(first, n):
        for it in range(first, first + n):
            loss, loss_dict = step(it)
            losses.append(loss)
            pairs.append(loss_dict["num_pairs"])
        sync(dev)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    steps_from(0, WARMUP)
    t1 = time.perf_counter()
    steps_from(WARMUP, steps)
    step_s = (time.perf_counter() - t1) / steps
    return {"step_s": step_s, "warmup_s": t1 - t0, "losses": [float(x) for x in losses],
            "num_pairs": [int(p) for p in pairs],
            "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None}


def result(data, batch: int, step_s: float, n_gauss: int, device_name: str) -> dict:
    """The bench's JSON line."""
    height, width = data.gt_images.shape[1:3]
    return {
        "metric": (f"Mpix/s of the full refine step on one card ({n_gauss} gaussians, {width}x{height}, "
                   f"fused RGB+depth render, L1+SSIM, depth, mask and mesh losses, named-group Adam) "
                   f"[camera batch B={batch}]"),
        "value": width * height * batch / step_s / 1e6,
        "unit": "Mpix/s",
        "batch": batch,
        "ms_per_camera": 1e3 * step_s / batch,
        "device": device_name,
    }


def detail(params, config, data, raster_cfg, full_step_s: float, iters: int = DETAIL_ITERS) -> dict:
    """Seconds of the render's stages on camera 0 (bench_detail): preprocess
    + binning + the pair gather, the render forward, the render forward +
    backward."""
    dev = params.points.device
    camera = index_camera(data.cameras, 0)
    grid_x, grid_y = (camera.width + TILE - 1) // TILE, (camera.height + TILE - 1) // TILE
    leaves = [p for _, p in params.named()]
    with torch.no_grad():
        centers, cov3d = sugar.geom_primitives(params, config)
        opac = sugar.strengths(params)
    col = torch.full((centers.shape[0], 3), 0.5, device=dev)

    @torch.no_grad()
    def prep_bin(i):
        g = preprocess(centers, cov3d, opac, col, camera)
        return binning.gather_pair_data(g, binning.bin_gaussians(g, grid_x, grid_y))

    @torch.no_grad()
    def fwd(i):
        return sugar.render(params, config, camera, bg=BG, sh_deg=SH_DEG, raster_config=raster_cfg)[0]

    def fwdbwd(i):
        img, _ = sugar.render(params, config, camera, bg=BG, sh_deg=SH_DEG, raster_config=raster_cfg)
        return torch.autograd.grad(((img - 0.5) ** 2).mean(), leaves, allow_unused=True)

    t_pb = loop_bench(prep_bin, iters=iters, device=dev)
    t_fwd = loop_bench(fwd, iters=iters, device=dev)
    t_fb = loop_bench(fwdbwd, iters=iters, device=dev)
    return {
        "full_step_s": full_step_s,
        "preprocess_binning_s": t_pb,
        "render_fwd_s": t_fwd,
        "render_fwdbwd_s": t_fb,
        "note": "camera 0, RGB; the full step is B renders fwd+bwd + SSIM + mesh losses + Adam",
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4, help="cameras a step")
    ap.add_argument("--steps", type=int, default=STEPS, help="timed steps")
    ap.add_argument("--detail", metavar="PATH", help="write the render's stage times to PATH")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=int, default=REF_W)
    ap.add_argument("--height", type=int, default=REF_H)
    ap.add_argument("--lat", type=int, default=REF_LAT)
    ap.add_argument("--lon", type=int, default=REF_LON)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    t0 = time.perf_counter()
    params, config, data, raster_cfg = reference_scene(dev, w=args.width, h=args.height, n_lat=args.lat,
                                                       n_lon=args.lon)
    setup_s = time.perf_counter() - t0
    rec = run(params, config, data, raster_cfg, args.batch, args.steps)
    card = device_record(dev)
    n_gauss = params.scales.shape[0]
    out = result(data, args.batch, rec["step_s"], n_gauss, card["device"])
    if "nvidia_smi" in card:
        print(card["nvidia_smi"], file=sys.stderr)
    print(f"# host {card['host_cpu']}", file=sys.stderr)
    peak = "" if rec["peak_bytes"] is None else f"; peak {rec['peak_bytes'] / 2**30:.3f} GiB"
    print(f"# step {1e3 * rec['step_s']:.3f} ms ({args.steps} steps after {WARMUP}, those {rec['warmup_s']:.1f} "
          f"s), setup {setup_s:.1f} s, device {card['device']}, n_gauss={n_gauss}, largest num_pairs of a step "
          f"{max(rec['num_pairs'])}{peak}", file=sys.stderr)
    if args.detail:
        stages = detail(params, config, data, raster_cfg, rec["step_s"])
        with open(args.detail, "w") as f:
            json.dump(stages, f, indent=2)
        print(f"# detail: {json.dumps(stages)}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
