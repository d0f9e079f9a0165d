#!/usr/bin/env python3
"""Where the time of the refine step goes on one NVIDIA GPU (gaustar_tpu_torch).

    python3 profile_step.py        # needs one CUDA card
    python3 profile_step.py blend  # section 4 alone

On `reference_scene` (600k gaussians, 1600x1024, 4 cameras) it prints the
card's name and power limit, then:
  1 step     `refine_frame` for STEPS iterations after WARMUP: host time per
             iteration (synchronized), untraced;
  2 trace    the same under torch.profiler: device time per iteration (the
             union of the intervals of every kernel, copy and fill), its share
             of the untraced iteration, and the operators by self device time;
  3 layers   the forward and backward of each layer of one iteration on its
             own (camera 0, the fused 4-channel render): its time between
             CUDA events and its device-busy time under the profiler;
  4 blend    the two blend wrappers' times over every tile of camera 0 and
             over its longest tile alone, at the initial opacities and at
             0.9, with the device time of each CUDA kernel they launch.
"""

from __future__ import annotations

import subprocess
import sys
import time

WARMUP = 3
STEPS = 8
ROWS = 25


def device_busy_us(events):
    """Time covered by at least one device event, in microseconds."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return busy, len(spans)


def cuda_ms(torch, fn, iters=5, warmup=2):
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


def wall_and_device_ms(torch, fn, iters=5):
    """(CUDA-event ms, device-busy ms) per call of `fn`: where the first is
    larger, the device waited on the host between kernels."""
    from torch.profiler import ProfilerActivity, profile

    wall = cuda_ms(torch, fn, iters)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return wall, device_busy_us(prof.events())[0] / 1e3 / iters


def layer_ms(torch, params, config, data, cfg):
    """{layer: (wall ms, device ms)} of one iteration's layers, forward and
    backward each, with fixed random cotangents where the layer's output is
    not a loss."""
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.models import sugar
    from gaustar_tpu_torch.ops.rasterizer import RasterConfig, rasterize
    from gaustar_tpu_torch.train import refine
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, adam_step, make_lr_fn

    cam = index_camera(data.cameras, 0)
    dev = params.points.device
    gen = torch.Generator(device=dev).manual_seed(0)
    leaves = [p for _, p in params.named()]

    def geometry():
        pos, cov = sugar.geom_primitives(params, config)
        return pos, cov, sugar.points_rgb(params, pos, cam.camera_center, cfg.sh_levels - 1)

    with torch.no_grad():
        pos, cov, rgb = geometry()
        z = pos @ cam.view[2, :3] + cam.view[2, 3]
        blend_in = [pos, cov, sugar.strengths(params), torch.cat([rgb, z[:, None]], 1)]
    blend_in = [t.detach().requires_grad_() for t in blend_in]

    def render():
        img, _ = rasterize(*blend_in, cam, bg=(*cfg.bg_color, cfg.max_depth),
                           config=RasterConfig(channels=4), layout="cm")
        return img

    maps = render().detach()
    img_cm, depth = maps[:3].clone().requires_grad_(), maps[3].clone().requires_grad_()
    ct_geom = [torch.randn(t.shape, generator=gen, device=dev) for t in (pos, cov, rgb)]
    ct_img = torch.randn(maps.shape, generator=gen, device=dev)

    def pixel():
        return refine.pixel_losses(data, 0, 1, cfg, img_cm, depth)[0]

    def shared():
        return refine.shared_losses(params, config, data, 1, cfg)[0]

    opt_state = adam_init(params)
    zero_grads = {k: torch.zeros_like(p) for k, p in params.named()}
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    return {
        "sugar geometry + SH colour": wall_and_device_ms(torch, lambda: torch.autograd.grad(
            geometry(), leaves, ct_geom, allow_unused=True)),
        "rasterize (preprocess, binning, gather, blend kernels, assemble)": wall_and_device_ms(
            torch, lambda: torch.autograd.grad(render(), blend_in, ct_img)),
        "pixel losses (masked L1 + SSIM, depth, mask)": wall_and_device_ms(
            torch, lambda: torch.autograd.grad(pixel(), [img_cm, depth])),
        "shared losses (mesh regularizers, opacity)": wall_and_device_ms(
            torch, lambda: torch.autograd.grad(shared(), leaves, allow_unused=True)),
        "named-group Adam": wall_and_device_ms(torch, lambda: adam_step(params, zero_grads, opt_state, lr_fn)),
    }


def device_kernel_ms(torch, fn, iters=10):
    """{CUDA kernel name: device ms per call of `fn`} under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / iters
    return out


def blend_tile_ms(torch, params, config, data):
    """{(opacity state, tiles): (pairs, longest list, fwd ms, bwd ms, fwd
    kernels, bwd kernels)} of the blend wrappers on camera 0, 4 channels:
    at the scene's initial opacities and with every opacity set to 0.9 (the
    tile lists re-binned, as a render of trained gaussians bins them), over
    every tile and over the longest tile alone. The last two entries are the
    device ms of each CUDA kernel a wrapper launches."""
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.ops import blend_cuda as bc
    from gaustar_tpu_torch.utils.synthetic import blend_inputs, render_inputs

    means, cov, opac, feats, cam = render_inputs(params, config, index_camera(data.cameras, 0))
    out = {}
    for state, op in (("initial opacities", opac), ("opacities 0.9", torch.full_like(opac, 0.9))):
        for label, top in (("all tiles", None), ("longest tile alone", 1)):
            inputs = blend_inputs(means, cov, op, feats, cam, 4, top_tiles=top)
            raw, split = bc.blend_fwd_split(*inputs, 4)
            ct = torch.randn(raw.shape, device=raw.device)
            fwd = lambda: bc.blend_fwd_cuda(*inputs, 4)  # noqa: E731
            bwd = lambda: bc.blend_bwd_cuda(*inputs, 4, raw, ct, split)  # noqa: E731
            out[(state, label)] = (inputs[0].shape[1], int(inputs[2].max()), cuda_ms(torch, fwd, 20),
                                   cuda_ms(torch, bwd, 20), device_kernel_ms(torch, fwd),
                                   device_kernel_ms(torch, bwd))
    return out


def print_blend(torch, params, config, data):
    for (state, label), (pairs, longest, fwd, bwd, kf, kb) in blend_tile_ms(torch, params, config, data).items():
        print(f"[blend] {state}, {label}: {pairs} pairs, longest list {longest}; blend_fwd {fwd:.4f} ms, "
              f"blend_bwd {bwd:.4f} ms", flush=True)
        for wrapper, kernels in (("blend_fwd", kf), ("blend_bwd", kb)):
            print(f"[blend]   {wrapper} device ms by kernel: "
                  + ", ".join(f"{name} {ms:.4f}" for name, ms in kernels.items()), flush=True)


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_step: CUDA is not available; this script needs one GPU", file=sys.stderr)
        return 1
    from gaustar_tpu_torch.train import refine
    from gaustar_tpu_torch.utils.synthetic import reference_scene

    print(torch.cuda.get_device_name(0), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0], flush=True)
    params, config, data, raster_cfg = reference_scene("cuda")
    if sys.argv[1:] == ["blend"]:
        print_blend(torch, params, config, data)
        return 0

    def run(iters):
        cfg = refine.RefineConfig(num_iterations=iters, loose_bind_from=10**9, do_sh_warmup=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        refine.refine_frame(params, config, data, cfg, raster_cfg, log_every=0)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(WARMUP)
    step_ms = 1e3 * run(STEPS) / STEPS
    print(f"[step] {STEPS} iterations after {WARMUP}: {step_ms:.3f} ms per iteration (host clock, untraced)",
          flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced_ms = 1e3 * run(STEPS) / STEPS
    busy_us, n_events = device_busy_us(prof.events())
    device_ms = busy_us / 1e3 / STEPS
    print(f"[trace] {traced_ms:.3f} ms per iteration traced; device busy {device_ms:.3f} ms per iteration "
          f"({n_events} device events) = {100 * device_ms / step_ms:.1f}% of the untraced iteration", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=ROWS, max_name_column_width=60),
          flush=True)

    cfg = refine.RefineConfig(loose_bind_from=10**9, do_sh_warmup=False)
    layers = layer_ms(torch, params, config, data, cfg)
    for name, (wall, dev) in layers.items():
        print(f"[layers] wall {wall:8.3f} ms  device {dev:8.3f} ms ({100 * dev / step_ms:5.1f}% of the "
              f"iteration)  {name}", flush=True)
    wall = sum(w for w, _ in layers.values())
    dev = sum(d for _, d in layers.values())
    print(f"[layers] wall {wall:8.3f} ms  device {dev:8.3f} ms ({100 * dev / step_ms:5.1f}%)  sum, of a "
          f"{step_ms:.3f} ms iteration", flush=True)
    print_blend(torch, params, config, data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
