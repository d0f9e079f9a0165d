"""The readings a cell's limits are set from, on the card at the cell's size
(no measured window: the check steps and the reference alone).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... [--control 3] [--faults 3] [--out PATH]

For each seed: the program's numbers against the reference (the lower
readings). For the first `--control` seeds, the control: the reference in
TF32 put in the program's place. For the first `--faults` seeds, each fault
the cell can have, planted in the program: half of a camera batch left out
(the mean over the rest), and one gradient altered where it is produced (the
SH colour's, x 1.5). A step that leaves the state unchanged reads 1 on
change_gap by its definition and needs no run. One JSON line per reading
goes to stdout and to `--out`.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from benchmark import check, harness, scene as scene_mod  # noqa: E402


class ReferenceAsProgram:
    """The reference put in the program's place (the control)."""

    def __init__(self, inputs, config, device, tf32=True):
        self.ref = harness.reference_module(config).Reference(inputs, config, tf32=tf32)

    def step(self, cams, iteration):
        return self.ref.step(cams)[0]

    def leaves(self):
        return self.ref.leaves

    def first_moments(self):
        return self.ref.mu

    def free(self):
        self.ref = None


def half_batch(inputs, config, device):
    """The program, each step over the first half of its cameras."""

    class HalfBatch(harness.program_module(config).Program):
        def step(self, cams, iteration):
            return super().step(cams[:max(1, len(cams) // 2)], iteration)

    return HalfBatch(inputs, config, device)


@contextlib.contextmanager
def altered_gradient(leaf: str = "sh_dc", factor: float = 1.5):
    """The program's named gradients with one leaf's scaled."""
    from gaustar_tpu_torch.train import refine

    original = refine.named_grads

    def named_grads(loss, params):
        grads = original(loss, params)
        grads[leaf] = grads[leaf] * factor
        return grads

    refine.named_grads = named_grads
    try:
        yield
    finally:
        refine.named_grads = original


def readings(workload: str, seed: int, make_program, config=None, device="cuda") -> dict:
    spec = harness.benchmark_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config = config or scene_mod.load_json("configs", cell["config"])
    mix = scene_mod.load_json("mixes", cell["traffic"])
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    t0 = time.perf_counter()
    inputs = scene_mod.make_scene(config, seed, device)
    schedule = scene_mod.camera_schedule(seed, inputs.rig.n, mix["cameras_per_step"])
    cams = [next(schedule) for _ in range(mix["check_steps"])]
    program = make_program(inputs, config, device)
    t1 = time.perf_counter()
    prog = check.program_readings(program, cams)
    t2 = time.perf_counter()
    program.free()
    del program
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    ref = check.reference_readings(harness.reference_module(config).Reference(inputs, config), cams)
    t3 = time.perf_counter()
    out = check.gaps(prog, ref)
    out["loss_gaps"] = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    out["grad_by_leaf"] = {k: [prog["grad"][k], ref["grad"][k]] for k in ref["grad"]}
    out["change_by_leaf"] = {k: [prog["change"][k], ref["change"][k]] for k in ref["change"]}
    out["seconds"] = {"inputs_and_program": t1 - t0, "program_steps": t2 - t1, "reference": t3 - t2}
    del inputs
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    cell = next(w for w in harness.benchmark_spec()["workloads"] if w["name"] == args.workload)
    batch = scene_mod.load_json("mixes", cell["traffic"])["cameras_per_step"]
    Program = harness.program_module(scene_mod.load_json("configs", cell["config"])).Program
    runs = [("program", s, Program, contextlib.nullcontext) for s in seeds]
    runs += [("control_tf32", s, ReferenceAsProgram, contextlib.nullcontext) for s in seeds[:args.control]]
    if batch > 1:
        runs += [("fault_half_batch", s, half_batch, contextlib.nullcontext) for s in seeds[:args.faults]]
    runs += [("fault_altered_gradient", s, Program, altered_gradient) for s in seeds[:args.faults]]
    sink = open(args.out, "a") if args.out else None
    try:
        for kind, seed, make, ctx in runs:
            with ctx():
                rec = {"workload": args.workload, "kind": kind, "seed": seed,
                       **readings(args.workload, seed, make)}
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
