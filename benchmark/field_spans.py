"""The field step's layer spans in a traced window: each kernel, copy and
fill charged to the span that launched it, summed by the subtrees of the
field's layer spans, and the field's counters.

As benchmark/spans.py does for the refine step: the traced window keeps the
arguments of the program's field step (STEP_CAPTURE), and once the other
per-layer metrics have read that window, the same steps run again under the
program's own exporter (gaustar_tpu_torch.utils.profiling.trace, CUDA
activity alone on a card), which writes the program's spans, the runtime
calls and the device events on one clock. Attribution is spans.py's
(read_spans, device_events, Spans.charge and its chains): a launch on the
autograd engine's thread in no span of its own goes to the main thread's
innermost span, field.backward. Nothing of the program is imported until a
field step has been captured, so a cell of another program, or a program
without the field step, reads nothing.
"""

from __future__ import annotations

import importlib
import json
import os
import tempfile

from benchmark import spans

# The program function whose arguments are one traced field step.
STEP_CAPTURE = ("benchmark.programs.field_step", "run_field_step")
ATTEMPTS = 3  # span windows run at most, while the profiler loses kernel events
# Metric -> the spans whose subtrees it sums.
LAYERS = {
    "field_encode_device_ms": ("field.encode",),
    "field_mlp_device_ms": ("field.mlp",),
    "field_composite_device_ms": ("field.composite",),
    "field_backward_device_ms": ("field.backward",),
    "field_adam_device_ms": ("field.adam",),
}


def attribute(doc: dict, steps: int) -> dict | None:
    """What the program's exporter wrote for `steps` field steps: device ms
    a step of each metric in LAYERS, of the whole window and outside every
    span; device ms a step by innermost span; kernels and synchronizes a
    step; the field's counters a step; kernel launches whose kernel the
    profiler lost. None where the trace holds no span."""
    events = doc["traceEvents"]
    record = doc.get("programRecord", {})
    sp = spans.read_spans(events, record.get("main_thread"))
    if not sp.names:
        return None
    device, lost = spans.device_events(events)
    main_idx = sp.by_thread.get(sp.main, [])
    lo = min(sp.starts[i] for i in main_idx) if main_idx else min(sp.starts)
    hi = max([sp.ends[i] for i in main_idx] + [b for _, _, b, _, _ in device])
    layers = dict.fromkeys(LAYERS, 0.0)
    self_us: dict = {}
    total = outside = 0.0
    kernels = 0
    for cat, a, b, tid, t in device:
        s = -1 if t is None else sp.charge(tid, t)
        dur = b - a
        total += dur
        kernels += cat == "kernel"
        name = spans.NO_SPAN if s == -1 else sp.names[s]
        self_us[name] = self_us.get(name, 0.0) + dur
        if s == -1:
            outside += dur
            continue
        for metric, roots in LAYERS.items():
            if sp.chains[s].intersection(roots):
                layers[metric] += dur
    syncs = sum(1 for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in spans.SYNC_CALLS)
    counts = record.get("counts", {})
    ms = 1e-3 / steps
    return {
        "steps": steps,
        "window_s": (hi - lo) * 1e-6,
        "device_ms": {k: v * ms for k, v in layers.items()},
        "total_device_ms": total * ms,
        "outside_device_ms": outside * ms,
        "self_device_ms": {k: v * ms for k, v in sorted(self_us.items(), key=lambda kv: -kv[1])},
        "kernels": kernels / steps,
        "syncs": syncs / steps,
        "rays_per_step": counts["field_rays"] / steps if "field_rays" in counts else None,
        "samples_per_step": counts["field_samples"] / steps if "field_samples" in counts else None,
        "lost_kernels": lost,
    }


def record_steps(calls: list, profiling) -> dict:
    """Run the captured field steps again under the program's exporter;
    returns the trace it wrote."""
    step = getattr(importlib.import_module(STEP_CAPTURE[0]), STEP_CAPTURE[1])
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, host_ops=False):
            for args, kwargs in calls:
                step(*args, **kwargs)
        with open(os.path.join(d, "trace.json")) as f:
            return json.load(f)


def measure(run) -> dict | None:
    """attribute() of the harness's traced field steps run again with the
    program's spans on, again while the profiler loses kernel events, up to
    ATTEMPTS windows, the one that lost fewest kept (memoized on the trace;
    printed on the run's earlier lines); None where the traced steps called
    no field step or the program has no recorder."""
    memo = run.trace.memo
    if "field_spans" not in memo:
        memo["field_spans"] = None
        calls = run.trace.captures.get(STEP_CAPTURE, [])
        profiling = importlib.import_module("gaustar_tpu_torch.utils.profiling") if calls else None
        if hasattr(profiling, "recording"):
            tries = []
            while len(tries) < ATTEMPTS and (not tries or tries[-1]["lost_kernels"]):
                m = attribute(record_steps(calls, profiling), len(calls))
                if m is None:
                    break
                tries.append(dict(m, attempts=len(tries) + 1))
            memo["field_spans"] = min(tries, key=lambda m: m["lost_kernels"], default=None)
        if memo["field_spans"] is not None:
            report(memo["field_spans"], run)
    return memo["field_spans"]


def report(m: dict, run):
    t = run.trace
    print(f"# field spans: traced step {1e3 * m['window_s'] / m['steps']:.3f} ms with the program's recorder on, "
          f"{1e3 * t.window_s / t.steps:.3f} ms in the harness's traced window (recorder off); kernels a step "
          f"{m['kernels']:.4f}, synchronizes {m['syncs']:.4f}; device ms a step {m['total_device_ms']:.4f}, in the "
          f"five layers {sum(m['device_ms'].values()):.4f}, outside every span {m['outside_device_ms']:.4f}; rays "
          f"{m['rays_per_step']} and samples {m['samples_per_step']} a step; kernels the profiler lost "
          f"{m['lost_kernels']} (span window {m['attempts']} of at most {ATTEMPTS})", flush=True)
    print(f"# field device ms a step by innermost span: "
          f"{ {k: round(v, 4) for k, v in m['self_device_ms'].items()} }", flush=True)


def device_ms(run, metric: str) -> float | None:
    m = measure(run)
    return None if m is None else m["device_ms"][metric]
