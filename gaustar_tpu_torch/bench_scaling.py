"""Camera-DP scaling of the refine step over ranks (counterpart of the JAX
repository's bench_scaling.py).

    python -m gaustar_tpu_torch.bench_scaling [--cams-per-rank 2] [--small] [--device cuda] [--max-ranks 8]

For each size R of 1, 2, 4, 8 and 16 (bench_scaling.py:45) up to the number
of cards, R ranks run parallel/sharding.make_sharded_train_step with
`--cams-per-rank` B cameras a rank (:46): one warm-up step, then STEPS
steps timed on the host clock, the card synchronised (:66-73). The step is
the JAX script's: RefineConfig(num_iterations=4, loose_bind_from=10_000),
SH degree 0, the named-group Adam at spatial lr scale 1.0. A size's step
time is its slowest rank's. Efficiency is t_1 / t_R (:78): each rank renders
B cameras a step, so ideal scaling keeps the step time flat while R ranks
take R x B cameras.

Ranks are processes spawned with torch.multiprocessing and a file://
rendezvous under a temporary directory. On cards each rank has a card of its
own and the group runs over NCCL (parallel/launch.default_backend); ranks
never share a card: ranks sharing one measure gloo through the host
(chip_smoke.py phase 12), not scaling. With `--device cpu` the ranks run
gloo on the CPU, one thread each, up to `--max-ranks`; a size beyond the
host's cores is marked "oversubscribed" (:80-93) and the headline is the
largest size that is not.

The scene: on a card, utils/synthetic.reference_scene's sphere and widths
(600,000 gaussians, 1600x1024) on a ring of R x B cameras. The JAX script's
64x64 synthetic_frame (icosphere(2); :53-56) measures only launch overhead on
a card; `--small` gives it, and the CPU test runs it.

Output: one JSON line: metric; value, the efficiency at the headline size;
unit; detail, per size its step_s, efficiency, backend, each rank's last
loss and the blend launches summed over its ranks; cards; device. With one
card the only size is 1: value is null and `note` says that no scaling was
measured.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

SIZES = (1, 2, 4, 8, 16)
CAMS_PER_RANK = 2
STEPS = 5
CPU_MAX_RANKS = 8  # the JAX script's virtual CPU devices
TIMEOUT_S = 900


def _scene(n_cams: int, small: bool, dev: torch.device):
    from gaustar_tpu_torch.utils.synthetic import reference_scene, synthetic_frame

    if small:
        params, config, data, _, raster_cfg = synthetic_frame(n_cams=n_cams, w=64, h=64, subdiv=2, device=dev)
        return params, config, data, raster_cfg
    return reference_scene(dev, n_cams=n_cams)


def rank_main(rank: int, world: int, init: str, out: str, device: str, small: bool, cams_per_rank: int):
    """One rank (a spawned process): join the group, build the scene, time
    the camera-DP steps, write {step_s, loss, launches, backend} to
    out/rank<r>.pt."""
    import torch.distributed as dist

    from gaustar_tpu_torch.parallel import launch, sharding
    from gaustar_tpu_torch.refscale.common import sync
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam, adam_init, make_lr_fn
    from gaustar_tpu_torch.train.refine import RefineConfig
    from gaustar_tpu_torch.utils import profiling

    dev = launch.rank_device(device, rank)
    if dev.type == "cpu":
        torch.set_num_threads(1)
    launch.initialize(rank, world, init, device=device)
    mesh = sharding.make_camera_mesh(device=device)
    params, config, data, raster_cfg = _scene(world * cams_per_rank, small, dev)
    cfg = RefineConfig(num_iterations=4, loose_bind_from=10_000)
    opt_state = adam_init(params)
    step = sharding.make_sharded_train_step(config, data, cfg, raster_cfg,
                                            adam(make_lr_fn(OptimizationParams(), 1.0)), mesh)(sh_deg=0)
    cams = list(range(cams_per_rank))
    profiling.reset_counts()
    step(params, opt_state, cams, 1)
    sync(dev)
    t0 = time.perf_counter()
    for i in range(STEPS):
        loss, _ = step(params, opt_state, cams, 2 + i)
    sync(dev)
    step_s = (time.perf_counter() - t0) / STEPS
    backend = dist.get_backend() if dist.is_initialized() else None
    launches = profiling.counts("blend_fwd", "blend_bwd")
    torch.save({"step_s": step_s, "loss": float(loss), "launches": launches, "backend": backend},
               os.path.join(out, f"rank{rank}.pt"))
    if dist.is_initialized():
        dist.destroy_process_group()


def run_ranks(world: int, device: str, small: bool, cams_per_rank: int) -> list[dict]:
    """Spawn `world` ranks of rank_main, wait for them (at most TIMEOUT_S)
    and return each rank's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="bench_scaling_") as out:
        init = f"file://{os.path.join(out, 'rendezvous')}"
        ctx = mp.start_processes(rank_main, args=(world, init, out, device, small, cams_per_rank),
                                 nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish in {TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        return [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(world)]


def host_cores() -> int:
    return len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count() or 1


def run(device: str = "cuda", cams_per_rank: int = CAMS_PER_RANK, small: bool = False,
        max_ranks: int = CPU_MAX_RANKS) -> dict:
    """The scaling record (the JSON line's object)."""
    from gaustar_tpu_torch.utils.general import resolve_device

    dev = resolve_device(device)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    limit = cards if dev.type == "cuda" else max_ranks
    sizes = [n for n in SIZES if n <= limit]
    cores = host_cores()
    ranks = {n: run_ranks(n, dev.type, small, cams_per_rank) for n in sizes}
    step_s = {n: max(r["step_s"] for r in ranks[n]) for n in sizes}
    eff = {n: step_s[sizes[0]] / step_s[n] for n in sizes}
    oversubscribed = {n: dev.type == "cpu" and n > cores for n in sizes}
    headline = max([n for n in sizes if not oversubscribed[n]] or sizes[:1])
    scene = "64x64 synthetic frame" if small else "600k gaussians at 1600x1024"
    out = {
        "metric": (f"camera-DP refine step scaling efficiency ({headline} ranks, {cams_per_rank} cameras a rank, "
                   f"{scene}, t_1 / t_R)"),
        "value": eff[headline] if len(sizes) > 1 else None,
        "unit": "efficiency",
        "detail": {
            str(n): {
                "step_s": step_s[n],
                "efficiency": eff[n],
                "backend": ranks[n][0]["backend"],
                "losses": [r["loss"] for r in ranks[n]],
                "launches": {k: sum(r["launches"][k] for r in ranks[n]) for k in ranks[n][0]["launches"]},
                **({"oversubscribed": True} if oversubscribed[n] else {}),
            }
            for n in sizes
        },
        "cards": cards,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "n_cores": cores,
    }
    if len(sizes) == 1:
        out["note"] = (f"one {'card' if dev.type == 'cuda' else 'rank'}: only the 1-rank step was timed; "
                       "no scaling was measured")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cams-per-rank", type=int, default=CAMS_PER_RANK)
    ap.add_argument("--small", action="store_true", help="the JAX script's 64x64 synthetic frame")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-ranks", type=int, default=CPU_MAX_RANKS, help="the largest size on the CPU")
    args = ap.parse_args(argv)
    out = run(args.device, args.cams_per_rank, args.small, args.max_ranks)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
