"""The traced window: a few steady steps under torch.profiler, read back into
device intervals, runtime calls and host operations.

On the card the profiler records CUDA activity alone (kernels, copies,
fills and the runtime calls that issued them): recording every host
operation as well slows a host-paced step several times and would inflate
the idle share it measures. The window runs from the end of a
torch.cuda.synchronize() before the steps to the end of one after them. On
the CPU (the tests) the host operations and a record_function span stand in.
The profiler's Chrome trace is written to a temporary file under TMPDIR,
read and deleted. A per-layer metric may name a program function to observe
(`CAPTURE = (module, attribute)` in its reader), and so may the cell's
program module (for its step_operations): during the traced steps that
function is wrapped to keep its arguments, which the reader then reads from
`Trace.captures[(module, attribute)]`. The same steps are run once untraced
with the capture on before the traced window, so that the memory the kept
arguments hold is already in the allocator's pool.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import importlib
import json
import os
import tempfile

import torch

WINDOW = "benchmark.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


@dataclasses.dataclass
class Trace:
    steps: int
    window: tuple  # (start, end) in seconds on the trace's clock: the steps' issue, then the device's tail
    issued: float  # when the host had issued the last step
    device: list  # [(name, start, end)] kernels, copies and fills
    kernels: list  # [(name, start, end)] kernels alone
    runtime: list  # [(name, start, end)] CUDA runtime and driver calls
    host: list  # [(name, start, end)] host operations
    captures: dict
    memo: dict = dataclasses.field(default_factory=dict)  # what readers work out once from the captures

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_s(self) -> float:
        """Seconds of the window in which some device event runs."""
        return sum(b - a for a, b in busy_spans(self.device, *self.window))


def busy_spans(events, lo: float, hi: float) -> list:
    """The union of the events' intervals clipped to [lo, hi], in order."""
    spans = sorted((max(a, lo), min(b, hi)) for _, a, b in events if b > lo and a < hi)
    out = []
    for a, b in spans:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@contextlib.contextmanager
def capturing(targets):
    """Wrap each (module, attribute) in `targets` to keep its arguments;
    yields {target: [(args, kwargs)]}."""
    store, undo = {}, []
    try:
        for target in targets:
            mod = importlib.import_module(target[0])
            original = getattr(mod, target[1])
            calls = store.setdefault(target, [])

            def wrapped(*args, _original=original, _calls=calls, **kwargs):
                _calls.append((args, kwargs))
                return _original(*args, **kwargs)

            setattr(mod, target[1], wrapped)
            undo.append((mod, target[1], original))
        yield store
    finally:
        for mod, name, original in reversed(undo):
            setattr(mod, name, original)


def record(step, n_steps: int, targets, on_card: bool = True) -> Trace:
    """Run `step()` n_steps times untraced with the captures on (then drop
    what they kept), then n_steps times under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    with capturing(targets):
        for _ in range(n_steps):
            step()
        sync()
    with capturing(targets) as store:
        with profile(activities=activities) as prof:
            sync()
            with record_function(WINDOW):
                for _ in range(n_steps):
                    step()
            sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return parse(events, n_steps, store)


def parse(events, n_steps: int, captures: dict) -> Trace:
    """A Trace from Chrome trace events (timestamps in microseconds)."""
    device, kernels, runtime, host = [], [], [], []
    window = None
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        span = (name, float(e["ts"]) * 1e-6, (float(e["ts"]) + float(e["dur"])) * 1e-6)
        if cat in DEVICE_CATS:
            device.append(span)
            if cat == "kernel":
                kernels.append(span)
        elif cat in ("cuda_runtime", "cuda_driver"):
            runtime.append(span)
        elif cat == "cpu_op":
            host.append(span)
        elif cat == "user_annotation" and name == WINDOW:
            window = span[1:]
    bracket = sorted(s for s in runtime if s[0] == "cudaDeviceSynchronize")
    if len(bracket) >= 2:
        window = (bracket[0][2], bracket[-1][1])
        runtime = [s for s in runtime if window[0] <= s[1] < window[1]]
    if window is None:
        raise RuntimeError(f"the profiler's trace holds no {WINDOW} span and no synchronize bracket")
    # The device runs on after the host has issued the last step.
    end = max([window[1]] + [b for _, a, b in device if a >= window[0]])
    return Trace(n_steps, (window[0], end), window[1], device, kernels, runtime, host, captures)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps summed by the host operation running at each gap's middle."""
    lo, hi = trace.window
    by_op: dict = {}
    for name, a, b in trace.device:
        if b > lo and a < hi:
            by_op[name] = by_op.get(name, 0.0) + min(b, hi) - max(a, lo)
    spans = busy_spans(trace.device, lo, hi)
    edges = [lo] + [x for s in spans for x in s] + [hi]
    by_host: dict = {}
    calls = sorted(trace.host + trace.runtime, key=lambda s: s[1])
    starts = [s[1] for s in calls]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "(host between CUDA calls)"
        # The latest-started call still running at the gap's middle: host
        # calls nest, so it lies a few calls back at most.
        for i in range(bisect.bisect_right(starts, mid) - 1, max(-1, bisect.bisect_right(starts, mid) - 200), -1):
            if calls[i][2] > mid:
                name = calls[i][0]
                break
        by_host[name] = by_host.get(name, 0.0) + (b - a)
    order = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:120], s] for n, s in order], "idle_gaps": [[n[:120], s] for n, s in gaps]}
