"""Timing, tracing and debug utilities (counterpart of gaustar_tpu/utils/profiling.py).

  - `cuda_ms`: the milliseconds per call of `fn()` after warm-up calls, the
    calls timed back to back between CUDA events on a card
    (utils/general.device_ms), on the host clock on the CPU: the one timer of
    the package, `chip_smoke.py`, `profile_step.py` and the bench;
  - `loop_bench`: the same in seconds for `fn(i, *args)`, the JAX
    package's signature.
  - `span`, `recording`: the program's spans, named host intervals at its
    layer boundaries (`with span(name):` or `@span(name)`), kept in memory
    while a `recording()` is open and free of cost but one flag check
    otherwise; `count`, `counts`, `COUNTS`: always-on named counters (the
    blend kernels' launches, the pairs and renders of the rasterizer).
  - `trace`: a torch.profiler trace (CPU and, on a card, CUDA activity)
    around a block, with the program's spans recorded in it, written as one
    Chrome trace into a directory: in Perfetto the layer spans sit on the
    host threads above the runtime calls and the kernels they launched.
  - `debug_validate`: finiteness and capacity guards for a training loop.

Spans are stamped with time.time_ns(), the clock of the profiler's Chrome
trace: an event's `ts` is microseconds after the trace's
`baseTimeNanoseconds` on that clock (torch 2.11 and 2.13, with and without
CUDA activity), so spans and kernels share one timeline.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import NamedTuple

import torch

from gaustar_tpu_torch.utils.general import device_ms, resolve_device


def cuda_ms(fn, iters: int, warmup: int = 2, device="cuda") -> float:
    """Milliseconds per call of `fn()` on `device`: `warmup` calls (first
    launches, builds, allocations), the card synchronised, then `iters`
    calls timed together."""
    dev = resolve_device(device)
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    _, ms = device_ms(dev, lambda: [fn() for _ in range(iters)])
    return ms / iters


def loop_bench(fn, *args, iters: int = 8, device="cuda") -> float:
    """Seconds per iteration of `fn(i, *args)` on `device`: one warm-up call
    fn(0, *args), then fn(i, *args) for i < `iters` timed together."""
    calls = iter([0, *range(iters)])
    return cuda_ms(lambda: fn(next(calls), *args), iters, warmup=1, device=device) / 1e3


# --- counters ---------------------------------------------------------------

# Always-on counters, name -> int: the blend kernels' launches ("blend_fwd",
# "blend_bwd", counted where ops/blend_cuda.py launches them) and each
# render's pairs ("pairs", "renders", ops/binning.py).
COUNTS: dict = {}


def count(name: str, n: int = 1) -> None:
    COUNTS[name] = COUNTS.get(name, 0) + n


def counts(*names) -> dict:
    """{name: count} of `names` (0 for a name never counted)."""
    return {k: COUNTS.get(k, 0) for k in names}


def reset_counts() -> None:
    COUNTS.clear()


# --- spans -------------------------------------------------------------------

SPAN_CAT = "program_span"  # the Chrome-trace category `trace` gives the spans
_RECORD = None  # the open Record; None while recording is off


class SpanEvent(NamedTuple):
    """One recorded span."""

    name: str
    thread: int  # the host thread's native id
    start_ns: int  # time.time_ns()
    end_ns: int
    parent: int  # index of the enclosing span on the same thread; -1 at the thread's top
    step: int | None  # the iteration of the enclosing `refine.step`-like span


_NO_OWN_STEP = object()  # marks a span entry that carries no step of its own


class Record:
    """The spans and counts of one recording. While it is open, spans are
    appended as [name, thread, start, end, parent, step, the step before it
    for a span that carries one]; `spans` holds SpanEvents once it has
    ended, `counts` what each counter added meanwhile. `main_thread` opened
    the recording; `idents` maps each recorded thread's native id to its
    threading.get_ident()."""

    def __init__(self):
        self.spans: list = []
        self.counts: dict = {}
        self.main_thread = threading.get_native_id()
        self.idents = {self.main_thread: threading.get_ident()}
        self.end_ns = None
        self._counts0 = dict(COUNTS)
        self._lock = threading.Lock()
        self._local = threading.local()
        self._step = None

    def _thread(self) -> tuple:
        """(this thread's stack of open span indices, its native id)."""
        state = getattr(self._local, "state", None)
        if state is None:
            state = self._local.state = ([], threading.get_native_id())
            self.idents[state[1]] = threading.get_ident()
        return state

    def open(self, name: str, step):
        stack, native = self._thread()
        if step is None:
            entry = [name, native, time.time_ns(), None, stack[-1] if stack else -1, self._step, _NO_OWN_STEP]
        else:
            entry = [name, native, time.time_ns(), None, stack[-1] if stack else -1, step, self._step]
            self._step = step
        with self._lock:
            stack.append(len(self.spans))
            self.spans.append(entry)

    def close(self):
        stack = self._thread()[0]
        if not stack:  # the span opened before the recording did
            return
        entry = self.spans[stack.pop()]
        entry[3] = time.time_ns()
        if entry[6] is not _NO_OWN_STEP:
            self._step = entry[6]

    def finish(self):
        """End the recording: spans still open end now."""
        self.end_ns = time.time_ns()
        self.spans = [SpanEvent(e[0], e[1], e[2], self.end_ns if e[3] is None else e[3], e[4], e[5])
                      for e in self.spans]
        self.counts = {k: v - self._counts0.get(k, 0) for k, v in COUNTS.items() if v != self._counts0.get(k, 0)}


class Span:
    """A named span: `with span(name):` or, on a function, `@span(name)`.
    While recording is off, entering and leaving cost one flag check each."""

    __slots__ = ("name", "step")

    def __init__(self, name: str, step=None):
        self.name, self.step = name, step

    def __enter__(self):
        if _RECORD is not None:
            _RECORD.open(self.name, self.step)
        return self

    def __exit__(self, *exc):
        if _RECORD is not None:
            _RECORD.close()
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _RECORD is None:
                return fn(*args, **kwargs)
            with self:
                return fn(*args, **kwargs)

        return wrapped


_SPANS: dict = {}  # one Span a name, reused while recording is off


def span(name: str, step=None) -> Span:
    """The span `name`; `step` (an iteration) is carried by the span and
    every span opened inside it, on any thread, until it closes."""
    if step is not None and _RECORD is not None:
        return Span(name, step)
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = Span(name)
    return s


@contextlib.contextmanager
def recording():
    """Record spans inside the block; yields the Record, complete once the
    block has ended. Recordings do not nest."""
    global _RECORD
    if _RECORD is not None:
        raise RuntimeError("a recording is already open")
    rec = _RECORD = Record()
    try:
        yield rec
    finally:
        _RECORD = None
        rec.finish()


def span_events(record: Record, trace_doc: dict) -> tuple:
    """The record's spans as Chrome-trace events on `trace_doc`'s clock and
    threads: `ts` in microseconds after its baseTimeNanoseconds; each span
    on the thread id the trace gives that host thread's runtime calls. With
    host operations recorded that is the native id; with CUDA activity alone
    it is kineto's: the low 32 bits of the pthread id as a signed int, its
    sign dropped. Returns (events, the recording thread's id in the trace);
    an event's args: the span's index, its parent's and its step."""
    base = int(trace_doc.get("baseTimeNanoseconds", 0))
    seen = {e.get("tid") for e in trace_doc.get("traceEvents", []) if e.get("cat") in ("cuda_runtime", "cuda_driver")}

    def tid(native):
        low = record.idents.get(native, native) & 0xFFFFFFFF
        kineto = abs(low - (1 << 32) if low >= 1 << 31 else low)
        return kineto if native not in seen and kineto in seen else native

    tids = {t: tid(t) for t in {s.thread for s in record.spans} | {record.main_thread}}
    pid = os.getpid()
    return [{"ph": "X", "cat": SPAN_CAT, "name": s.name, "pid": pid, "tid": tids[s.thread],
             "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"index": i, "parent": s.parent, "step": s.step}}
            for i, s in enumerate(record.spans)], tids[record.main_thread]


class trace:
    """Record a torch.profiler trace and the program's spans around a block
    and write both to `log_dir`/trace.json (Chrome trace format:
    chrome://tracing, Perfetto). CUDA activity is recorded when a card is
    present, host operations unless `host_ops` is False on a card (they slow
    a host-paced step several times). The trace's top level gains
    "programRecord": the thread that opened the recording (as the trace
    names it) and what each counter added. A profiler that cannot start
    raises.

        with trace("traces/step") as tr:
            step()
        tr.prof.key_averages(); tr.record.spans
    """

    def __init__(self, log_dir: str, host_ops: bool = True):
        self.log_dir = log_dir
        self.host_ops = host_ops
        self.prof = None
        self.record = None
        self._recording = None

    def __enter__(self):
        acts = []
        if self.host_ops or not torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CPU)
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self._recording = recording()
        self.record = self._recording.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._recording.__exit__(*exc)
        self.prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, "trace.json")
        self.prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        events, main = span_events(self.record, doc)
        doc["traceEvents"].extend(events)
        doc["programRecord"] = {"main_thread": main, "counts": self.record.counts}
        with open(path, "w") as f:
            json.dump(doc, f)
        return False


def _named(tree):
    if hasattr(tree, "named"):
        return tree.named()
    if isinstance(tree, dict):
        return list(tree.items())
    return [(str(i), x) for i, x in enumerate(tree)]


def debug_validate(params, grads=None, aux=None, max_pairs=None, name=""):
    """Host-side checks (each one syncs the device, so call them sparsely):
    raises FloatingPointError on a non-finite parameter or gradient and
    OverflowError when a render's pair count exceeds `max_pairs`. `params`
    and `grads` are SuGaRParams / GaussianParams, dicts or sequences of
    tensors."""
    for kind, tree in (("parameter", params), ("gradient", grads)):
        if tree is None:
            continue
        for key, leaf in _named(tree):
            if torch.is_tensor(leaf) and leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
                raise FloatingPointError(f"{name}: non-finite {kind} at {key}")
    if aux is not None and max_pairs is not None:
        npairs = int(aux.num_pairs)
        if npairs > max_pairs:
            raise OverflowError(f"{name}: rasterizer pair count {npairs} exceeds max_pairs={max_pairs}")
