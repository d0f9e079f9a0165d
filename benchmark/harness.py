"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

The cell is found by name in BENCHMARK.json; its configuration, traffic mix,
limits and metric readers by their names under benchmark/, and the program
and the reference by the configuration's "program" and "reference" keys
(benchmark/programs/<program>.py, benchmark/reference/<reference>.py). The
window drives the program's step in a closed loop with one caller (each step
issued when the previous returns), never reading a loss, and ends in
torch.cuda.synchronize().
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import itertools
import json
import os
import resource
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

from benchmark import check, scene as scene_mod, trace as trace_mod
from benchmark.programs import Laps

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gaustar_tpu")


@dataclasses.dataclass
class Run:
    """What a run measured, for the metric readers."""

    setup_s: float
    window_s: float
    steps: int
    pixels_per_step: int
    cameras_per_step: int
    param_elements: int
    device_kind: str
    trace: trace_mod.Trace | None = None
    operations_per_step: float | None = None  # the program module's step_operations, in a traced run


def benchmark_spec() -> dict:
    with open(ROOT.parent / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(spec: dict, workload: str, traced: bool) -> list:
    """The metric entries a run of `workload` reads: the end-to-end metrics
    that exist in the cell, or the per-layer metrics that move one of them.
    A per-layer reader returns None where the cell's program gives it
    nothing to read, and a per-layer `workloads` list names the cells that
    must report it; so a new cell of a program already measured reads its
    metrics from new files alone."""
    end_to_end = [m for m in spec["end_to_end"] if workload in m.get("workloads", [workload])]
    if traced:
        moved = {m["name"] for m in end_to_end}
        return [m for m in spec["per_layer"] if m["moves"] in moved]
    return end_to_end


def reader(name: str):
    """The reader of a metric: benchmark/metrics/<name>.py, or, for a name
    split by the end-to-end metric it moves (`<name>.<split>`), the reader of
    the part before the first dot."""
    return importlib.import_module(f"benchmark.metrics.{name.split('.')[0]}")


def program_module(config: dict) -> types.ModuleType:
    """The module of the program the configuration names."""
    return importlib.import_module(f"benchmark.programs.{config['program']}")


def reference_module(config: dict) -> types.ModuleType:
    """The module of the plain reference the configuration names."""
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def host_cpu() -> str:
    """The first processor's model name, or its vendor, family, model and
    clock where the name reads unknown."""
    fields = {}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if not line.strip():
                    break
                key, _, value = line.partition(":")
                fields.setdefault(key.strip(), value.strip())
    except OSError:
        return "unknown"
    name = fields.get("model name", "unknown")
    if name != "unknown":
        return name
    return ", ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model", "cpu MHz") if k in fields)


def nvidia_smi() -> str:
    """The card's name, power limit and draw, clocks and temperature."""
    query = "name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"not available ({type(e).__name__})"
    return f"{query}: {out.stdout.strip()}"


def host_counters() -> dict:
    """This process's CPU seconds, its involuntary context switches and
    Python's full collections; the host's CPU seconds stolen by the
    hypervisor (/proc/stat, summed over CPUs)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    out = {"cpu_s": ru.ru_utime + ru.ru_stime, "preempted": ru.ru_nivcsw, "gc_full": gc.get_stats()[2]["collections"]}
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        out["steal_s"] = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return out


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device="cuda", t0: float | None = None,
             config: dict | None = None, make_program=None, log=print, parts: dict | None = None) -> dict:
    """One run; returns the result line's object. `config` replaces the
    configuration file's contents and `make_program(scene, config, device)`
    the program's constructor (the CPU tests shrink the one and break the
    other; the program's module still counts a step's work); `parts`
    holds the seconds of the set-up's parts before this call."""
    t0 = time.perf_counter() if t0 is None else t0
    parts = dict(parts or {})
    lap = Laps(parts)
    spec = benchmark_spec()
    cell = next(w for w in spec["workloads"] if w["name"] == workload)
    config = config or scene_mod.load_json("configs", cell["config"])
    mix = scene_mod.load_json("mixes", cell["traffic"])
    limits = scene_mod.load_json("limits", workload)
    programs = program_module(config)
    make_program = make_program or programs.Program
    torch.backends.cuda.matmul.allow_tf32 = bool(config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["tf32"])
    on_card = torch.device(device).type == "cuda"

    # Set-up: inputs, the program, the check steps (which build and warm
    # every kernel of the cell's shapes).
    if on_card:
        torch.zeros(1, device=device)
    lap("CUDA context")
    inputs = scene_mod.make_scene(config, seed, device)
    sync(device)
    lap("scene and GT")
    program = make_program(inputs, config, device)
    parts.update(getattr(program, "parts", {}))
    lap.last = time.perf_counter()  # the program timed its own parts
    per_step = mix["cameras_per_step"]
    schedule = scene_mod.camera_schedule(seed, inputs.rig.n, per_step)
    check_cams = [next(schedule) for _ in range(mix["check_steps"])]
    readings = check.program_readings(program, check_cams)
    lap("check steps")
    iteration = itertools.count(len(check_cams) + 1)

    def step():
        program.step(next(schedule), next(iteration))

    # The window.
    sync(device)
    host_before = host_counters()
    wall_window = time.time()
    t_window = time.perf_counter()
    marks = []  # when the host had issued each step
    while True:
        step()
        marks.append(time.perf_counter() - t_window)
        if marks[-1] >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t_window
    host_window = {k: v - host_before[k] for k, v in host_counters().items()}
    steps = len(marks)
    setup_s = t_window - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    smi = nvidia_smi() if on_card else "not a card"

    run = Run(setup_s, window_s, steps, programs.pixels_per_step(inputs, config, mix), per_step,
              sum(v.numel() for v in program.leaves().values()),
              torch.cuda.get_device_name() if on_card else "cpu")
    entries = cell_metrics(spec, workload, traced)
    breakdown = None
    # An end-to-end reader that names TRACE reads the traced steps in an
    # untraced run too; they run after the window has closed.
    if traced or any(getattr(reader(m["name"]), "TRACE", False) for m in entries):
        observers = [reader(m["name"]) for m in entries] + ([programs] if traced else [])
        targets = {getattr(mod, "CAPTURE", None) for mod in observers} - {None}
        run.trace = trace_mod.record(step, mix["trace_steps"], sorted(targets), on_card)
    if traced:
        run.operations_per_step = programs.step_operations(run)
        breakdown = trace_mod.breakdown(run.trace)
    metrics = {}
    for m in entries:
        value = reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_rec = {"platform": "gpu" if on_card else "cpu", "kind": run.device_kind,
                  "count": cell["chips"], "memory_peak_bytes": peak}
    if traced:
        device_rec.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
    if run.trace is not None:
        run.trace.captures.clear()

    # The check, on the card's memory the program no longer holds.
    program.free()
    del program
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    reference = reference_module(config).Reference(inputs, config)
    ref_readings = check.reference_readings(reference, check_cams)
    ref_s = time.perf_counter() - t_ref
    numbers = check.gaps(readings, ref_readings)
    correct, checks = check.judge(numbers, limits)

    log(f"# card: {smi}")
    log(f"# host cpu: {host_cpu()}")
    log(f"# cell {workload}: config {cell['config']}, mix {cell['traffic']}, seed {seed}, "
        f"{inputs.rig.n} cameras at {inputs.rig.width}x{inputs.rig.height}, {per_step} a step")
    log(f"# set-up {setup_s:.3f} s; window {window_s:.3f} s from unix time {wall_window:.3f}, {steps} steps; "
        f"peak device memory {peak} bytes")
    log(f"# set-up parts (s; the check steps build the kernels in a fresh checkout): "
        f"{ {k: round(v, 3) for k, v in parts.items()} }")
    if run.trace is not None:
        log(f"# step time: {1e3 * window_s / steps:.3f} ms in the window, {1e3 * run.trace.window_s / run.trace.steps:.3f}"
            f" ms traced (the profiler's own cost on the host), {1e3 * run.trace.busy_s() / run.trace.steps:.3f} ms"
            f" of it busy on the device")
    log(f"# host during the window: {host_window}")
    log(f"# steps issued in each second of the window: {[sum(1 for m in marks if k <= m < k + 1) for k in range(int(seconds) + 1)]}")
    log(f"# reference {ref_s:.3f} s; unmoved leaves {numbers['unmoved_leaves']}; losses program "
        f"{readings['losses']} reference {ref_readings['losses']}")
    result = {"correct": correct, "attempted": len(check_cams) + steps,
              "failed": sum(1 for c in checks.values() if not c["value"] <= c["limit"]),
              "metrics": metrics, "device": device_rec}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description="One run of one benchmark cell on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    parts = {"interpreter and imports": time.perf_counter() - t0}
    lap = Laps(parts)
    spec = benchmark_spec()
    cell = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    lap("card check (the CUDA driver's start)")
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0, parts=parts)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}", file=sys.stderr)
        return 3
    emit(result)
    return 0


def emit(result: dict):
    """Each compared number beside its limit, last on stderr; the result
    line, last on stdout."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
