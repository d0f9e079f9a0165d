"""The program's layer spans in a traced window: each kernel, copy and fill
charged to the span that launched it, each idle gap of the device to the
span the host was in, and the synchronizes and launches of each span.

The harness's traced window (benchmark/trace.py) runs with the program's
recording off and keeps neither the runtime calls' correlation ids nor their
threads. So the span metrics observe the program's refine step in the
harness's traced steps (STEP_CAPTURE: its arguments) and, once the other
per-layer metrics have read that window, run the same steps again, with the
same cameras and iterations, under the program's own exporter
(gaustar_tpu_torch.utils.profiling.trace) with CUDA activity alone, as the
harness's window records it. That exporter writes one Chrome trace holding
the program's spans, the runtime calls and the device events on one clock.
A program without a recorder (no utils/profiling.recording) reads nothing.

Attribution: a device event's launch is the runtime call with its
correlation id. The event goes to the innermost span on the launching
thread whose interval holds the launch's start. A launch on another thread
than the main one (the autograd engine's) inside no span of that thread
goes to the main thread's innermost span open at that moment
(refine.backward), and a span at the top of another thread belongs, for the
subtrees below, under the main thread's span open at its start. On the CPU
(the tests) the top-level host operations stand in for device events, each
launched at its own start.
"""

from __future__ import annotations

import bisect
import dataclasses
import importlib
import json
import os
import tempfile

from benchmark.trace import DEVICE_CATS, SYNC_CALLS, busy_spans

# The program function whose arguments are one traced step.
STEP_CAPTURE = ("gaustar_tpu_torch.train.refine", "train_step")
# The Chrome-trace category the program's exporter gives its spans.
SPAN_CAT = "program_span"
NO_SPAN = "(no span)"
# Runtime calls that launch a kernel: each has a kernel event of its
# correlation id unless the profiler lost it.
KERNEL_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
ATTEMPTS = 3  # span windows run at most, while the profiler loses kernel events
# Metric -> the spans whose subtrees it sums.
LAYERS = {
    "geometry_device_ms": ("refine.geometry", "render.colour"),
    "raster_fwd_device_ms": ("render.rasterize",),
    "pixel_loss_device_ms": ("loss.pixel",),
    "mesh_loss_device_ms": ("loss.mesh",),
    "backward_device_ms": ("refine.backward",),
    "adam_device_ms": ("refine.adam",),
}


@dataclasses.dataclass
class Spans:
    """The spans of a trace, by index, and their lookup by thread and time
    (microseconds of the trace's clock)."""

    names: list
    threads: list
    starts: list
    ends: list
    parents: list
    main: int  # the main thread's id in the trace
    by_thread: dict = dataclasses.field(default_factory=dict, init=False)  # tid -> span indices by start

    def __post_init__(self):
        for i in sorted(range(len(self.names)), key=lambda i: self.starts[i]):
            self.by_thread.setdefault(self.threads[i], []).append(i)
        self._keys = {t: [self.starts[i] for i in idx] for t, idx in self.by_thread.items()}
        self.chains = [self._chain(i) for i in range(len(self.names))]

    def innermost(self, tid, t: float) -> int:
        """The innermost span of thread `tid` open at `t`, -1 for none. The
        latest-started span before `t` either holds it or lies inside
        every span that does, so its ancestors are searched."""
        idx = self.by_thread.get(tid)
        if not idx:
            return -1
        k = bisect.bisect_right(self._keys[tid], t) - 1
        s = idx[k] if k >= 0 else -1
        while s != -1 and not self.starts[s] <= t <= self.ends[s]:
            s = self.parents[s]
        return s

    def charge(self, tid, t: float) -> int:
        """The span a launch or a synchronize at `t` on thread `tid` is
        charged to."""
        s = self.innermost(tid, t)
        if s == -1 and tid != self.main:
            s = self.innermost(self.main, t)
        return s

    def _chain(self, i: int) -> frozenset:
        names = set()
        while i != -1:
            names.add(self.names[i])
            parent = self.parents[i]
            if parent == -1 and self.threads[i] != self.main:
                parent = self.innermost(self.main, self.starts[i])
            i = parent
        return frozenset(names)


def read_spans(events, main) -> Spans:
    rows = sorted((e["args"]["index"], e) for e in events if e.get("cat") == SPAN_CAT)
    es = [e for _, e in rows]
    return Spans([e["name"] for e in es], [e["tid"] for e in es], [float(e["ts"]) for e in es],
                 [float(e["ts"]) + float(e["dur"]) for e in es], [e["args"]["parent"] for e in es], main)


def device_events(events) -> tuple:
    """([(cat, start, end, launching thread, launch start)] of the kernels,
    copies and fills (launch None where no runtime call carries the
    correlation id), kernel launches with no kernel event); on a trace with
    no device event, the top-level host operations."""
    launches = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]), e.get("name"))
    out, ran = [], set()
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = float(e["ts"])
            corr = e.get("args", {}).get("correlation")
            ran.add(corr)
            tid, t, _ = launches.get(corr, (None, None, None))
            out.append((e["cat"], a, a + float(e["dur"]), tid, t))
    if out:
        return out, sum(1 for c, (_, _, name) in launches.items() if name in KERNEL_LAUNCHES and c not in ran)
    ops = sorted((e.get("tid"), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op")
    last: dict = {}
    for tid, a, b in ops:
        if a >= last.get(tid, float("-inf")):
            out.append(("cpu_op", a, b, tid, a))
            last[tid] = b
    return out, 0


def attribute(doc: dict, steps: int) -> dict | None:
    """What the program's exporter wrote for `steps` refine steps: device ms
    a step of each metric in LAYERS, of the whole window and outside every
    span; device ms a step by innermost span; the window's idle seconds by
    the main thread's innermost span; synchronizes and kernels a step by
    span; pairs a render; kernel launches whose kernel the profiler lost.
    None where the trace holds no span."""
    events = doc["traceEvents"]
    record = doc.get("programRecord", {})
    spans = read_spans(events, record.get("main_thread"))
    if not spans.names:
        return None
    device, lost = device_events(events)
    main_idx = spans.by_thread.get(spans.main, [])
    lo = min(spans.starts[i] for i in main_idx) if main_idx else min(spans.starts)
    hi = max([spans.ends[i] for i in main_idx] + [b for _, _, b, _, _ in device])
    layers = dict.fromkeys(LAYERS, 0.0)
    self_us: dict = {}
    total = outside = 0.0
    by_span: dict = {}
    for cat, a, b, tid, t in device:
        s = -1 if t is None else spans.charge(tid, t)
        dur = b - a
        total += dur
        name = NO_SPAN if s == -1 else spans.names[s]
        self_us[name] = self_us.get(name, 0.0) + dur
        if cat == "kernel":
            by_span.setdefault(name, [0, 0])[1] += 1
        if s == -1:
            outside += dur
            continue
        for metric, roots in LAYERS.items():
            if spans.chains[s].intersection(roots):
                layers[metric] += dur
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and e.get("name") in SYNC_CALLS:
            s = spans.charge(e.get("tid"), float(e["ts"]))
            by_span.setdefault(NO_SPAN if s == -1 else spans.names[s], [0, 0])[0] += 1
    idle: dict = {}
    busy = busy_spans([(None, a, b) for _, a, b, _, _ in device], lo, hi)
    edges = [lo] + [x for s in busy for x in s] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            s = spans.innermost(spans.main, 0.5 * (a + b))
            name = NO_SPAN if s == -1 else spans.names[s]
            idle[name] = idle.get(name, 0.0) + (b - a) * 1e-6
    counts = record.get("counts", {})
    ms = 1e-3 / steps
    return {
        "steps": steps,
        "window_s": (hi - lo) * 1e-6,
        "device_ms": {k: v * ms for k, v in layers.items()},
        "total_device_ms": total * ms,
        "outside_device_ms": outside * ms,
        "self_device_ms": {k: v * ms for k, v in sorted(self_us.items(), key=lambda kv: -kv[1])},
        "idle_by_span": [[k, v] for k, v in sorted(idle.items(), key=lambda kv: -kv[1])],
        "by_span": {k: [v[0] / steps, v[1] / steps] for k, v in sorted(by_span.items())},
        "pairs_per_render": counts["pairs"] / counts["renders"] if counts.get("renders") else None,
        "lost_kernels": lost,
    }


def record_steps(calls: list, profiling) -> dict:
    """Run the captured refine steps again under the program's exporter,
    CUDA activity alone on a card; returns the trace it wrote."""
    step = getattr(importlib.import_module(STEP_CAPTURE[0]), STEP_CAPTURE[1])
    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d, host_ops=False):
            for args, kwargs in calls:
                step(*args, **kwargs)
        with open(os.path.join(d, "trace.json")) as f:
            return json.load(f)


def measure(run) -> dict | None:
    """attribute() of the harness's traced steps run again with the
    program's spans on, again while the profiler loses kernel events, up to
    ATTEMPTS windows, the one that lost fewest kept (memoized on the trace;
    printed on the run's earlier lines); None where the traced steps called
    no refine step or the program has no recorder."""
    memo = run.trace.memo
    if "spans" not in memo:
        memo["spans"] = None
        calls = run.trace.captures.get(STEP_CAPTURE, [])
        profiling = importlib.import_module("gaustar_tpu_torch.utils.profiling") if calls else None
        if hasattr(profiling, "recording"):
            tries = []
            while len(tries) < ATTEMPTS and (not tries or tries[-1]["lost_kernels"]):
                m = attribute(record_steps(calls, profiling), len(calls))
                if m is None:
                    break
                tries.append(dict(m, attempts=len(tries) + 1))
            memo["spans"] = min(tries, key=lambda m: m["lost_kernels"], default=None)
        if memo["spans"] is not None:
            report(memo["spans"], run)
    return memo["spans"]


def report(m: dict, run):
    t = run.trace
    six = sum(m["device_ms"].values())
    print(f"# spans: traced step {1e3 * m['window_s'] / m['steps']:.3f} ms with the program's recorder on, "
          f"{1e3 * t.window_s / t.steps:.3f} ms in the harness's traced window (recorder off); kernels a step "
          f"{sum(v[1] for v in m['by_span'].values()):.4f}, synchronizes {sum(v[0] for v in m['by_span'].values()):.4f}; "
          f"device ms a step {m['total_device_ms']:.4f}, in the six layers {six:.4f}, outside every span "
          f"{m['outside_device_ms']:.4f}; kernels the profiler lost {m['lost_kernels']} (span window "
          f"{m['attempts']} of at most {ATTEMPTS})", flush=True)
    print(f"# device ms a step by innermost span: { {k: round(v, 4) for k, v in m['self_device_ms'].items()} }",
          flush=True)
    print(f"# syncs and launches by span (a step, [syncs, kernels]): {m['by_span']}", flush=True)
    print(f"# idle by span (s of the {m['window_s']:.4f} s traced window): "
          f"{[[k, round(v, 6)] for k, v in m['idle_by_span']]}", flush=True)


def device_ms(run, metric: str) -> float | None:
    m = measure(run)
    return None if m is None else m["device_ms"][metric]
