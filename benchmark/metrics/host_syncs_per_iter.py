"""Synchronising runtime calls (stream, device and event synchronize) the
host made while issuing the traced steps, a step. None where the trace
records no runtime call."""

from benchmark.trace import SYNC_CALLS


def read(run):
    t = run.trace
    if not t.runtime:
        return None
    lo, hi = t.window[0], t.issued
    return sum(1 for name, a, _ in t.runtime if lo <= a < hi and name in SYNC_CALLS) / t.steps
