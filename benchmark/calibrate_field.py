"""The readings the field cell's limits are set from, on the card at the
cell's size (no measured window: the check steps and the reference alone).

    python3 benchmark/calibrate_field.py --workload field.body160.r8192 --seeds 1,2,... [--control 3]
        [--faults 3] [--levels 15,5] [--out PATH]

For each seed: the program's numbers against the reference (the lower
readings), and the rays of the check steps whose tightened [tmin, tmax]
differ between the port and the reference, bit for bit and by more than a
millionth of the ray's slab. For the first `--control` seeds, the control:
the reference in TF32 put in the program's place. For the first `--faults`
seeds, each fault planted in the program: the encoding computed in
bfloat16 (tables and trilinear weights), and, at each level of `--levels`,
that level's rows hashed with a wrong prime (z's 805459861 replaced by
73856093). A step that leaves the state unchanged reads 1 on change_gap by
its definition and needs no run. One JSON line per reading goes to stdout
and to `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import calibrate, field_rays, harness, scene as scene_mod  # noqa: E402
from benchmark.reference.field_step import level_resolutions  # noqa: E402

WRONG_PRIME = 73856093


@contextlib.contextmanager
def encoding_in_bf16():
    """The port's hash encoding with its tables and trilinear weights in
    bfloat16, its features back in float32."""
    from gaustar_tpu_torch.models import neural_field as nf

    encode, corners = nf.hash_encode, nf._level_corners

    def bf16_corners(*args, **kwargs):
        rows, w = corners(*args, **kwargs)
        return rows, w.to(torch.bfloat16)

    def bf16_encode(tables, pts01, cfg):
        return encode(tables.to(torch.bfloat16), pts01, cfg).to(torch.float32)

    nf.hash_encode, nf._level_corners = bf16_encode, bf16_corners
    try:
        yield
    finally:
        nf.hash_encode, nf._level_corners = encode, corners


def wrong_prime(level: int, field: dict):
    """A context in which the port hashes the rows of one level of the
    field `field` (the configuration's "field" block) with z's prime
    replaced; the level is known by its resolution."""
    res_at = level_resolutions(field["n_levels"], field["base_res"], field["max_res"])[level]

    @contextlib.contextmanager
    def ctx():
        from gaustar_tpu_torch.models import neural_field as nf

        corners = nf._level_corners

        def faulty(pts01, res, table_size, dense=False):
            if res != res_at or dense:
                return corners(pts01, res, table_size, dense)
            primes = nf._PRIMES
            nf._PRIMES = (primes[0], primes[1], WRONG_PRIME)
            try:
                return corners(pts01, res, table_size, dense)
            finally:
                nf._PRIMES = primes

        nf._level_corners = faulty
        try:
            yield
        finally:
            nf._level_corners = corners

    return ctx


def bounds_differ(workload: str, seed: int, device="cuda") -> dict:
    """Rays of the check steps whose tightened bounds differ between the
    port (init_mesh.rays_for_pixels, neural_field.ray_bounds on its carved
    occupancy) and the reference, bit for bit and beyond a millionth of the
    slab; and the occupancy cells that differ."""
    from gaustar_tpu_torch.models import neural_field as nf
    from gaustar_tpu_torch.train import init_mesh

    spec = harness.benchmark_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config = scene_mod.load_json("configs", cell["config"])
    mix = scene_mod.load_json("mixes", cell["traffic"])
    inputs = scene_mod.make_scene(config, seed, device)
    schedule = scene_mod.camera_schedule(seed, inputs.rig.n, mix["cameras_per_step"])
    program = harness.program_module(config).Program(inputs, config, device)
    reference = harness.reference_module(config).Reference(inputs, config)
    out = {"occupancy_cells_differ": int((program.occupancy != reference.occ).sum()), "rays": 0, "bits": 0,
           "beyond_1e-6": 0, "largest": 0.0}
    for it in range(1, mix["check_steps"] + 1):
        cams = next(schedule)
        n = program.cfg.rays_per_batch // len(cams)
        px, py, _ = field_rays.draw(program.fg, cams, it, n, program.field_cfg.n_samples, inputs.rig.height, device)
        rays = [init_mesh.rays_for_pixels(program.cameras[c], px[k].float() + 0.5, py[k].float() + 0.5)
                for k, c in enumerate(cams)]
        o, d = torch.cat([r[0] for r in rays]), torch.cat([r[1] for r in rays])
        tmin, tmax = nf.ray_bounds(o, d, program.field_cfg, program.occupancy)
        rmin, rmax = reference.bounds(*reference.rays(cams, px, py))
        slab = torch.clamp_min(rmax - rmin, 1e-3)
        gap = torch.maximum((tmin - rmin).abs(), (tmax - rmax).abs()) / slab
        out["rays"] += int(tmin.numel())
        out["bits"] += int(((tmin != rmin) | (tmax != rmax)).sum())
        out["beyond_1e-6"] += int((gap > 1e-6).sum())
        out["largest"] = max(out["largest"], float(gap.max()))
    del program, reference, inputs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="field.body160.r8192")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--levels", default="15,5")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = next(w for w in harness.benchmark_spec()["workloads"] if w["name"] == args.workload)
    config = scene_mod.load_json("configs", cell["config"])
    Program = harness.program_module(config).Program
    runs = [("program", s, Program, contextlib.nullcontext) for s in seeds]
    runs += [("control_tf32", s, calibrate.ReferenceAsProgram, contextlib.nullcontext) for s in seeds[:args.control]]
    runs += [("fault_bf16_encoding", s, Program, encoding_in_bf16) for s in seeds[:args.faults]]
    for level in (int(x) for x in args.levels.split(",") if x):
        runs += [(f"fault_wrong_prime_l{level:02d}", s, Program, wrong_prime(level, config["field"])) for s in seeds[:args.faults]]
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in seeds:
            rec = {"workload": args.workload, "kind": "bounds", "seed": seed, **bounds_differ(args.workload, seed)}
            print(json.dumps(rec), flush=True)
            if sink:
                sink.write(json.dumps(rec) + "\n")
        for kind, seed, make, ctx in runs:
            with ctx():
                rec = {"workload": args.workload, "kind": kind, "seed": seed,
                       **calibrate.readings(args.workload, seed, make)}
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    print(f"# card: {harness.nvidia_smi()}; host cpu: {harness.host_cpu()}", flush=True)


if __name__ == "__main__":
    main()
