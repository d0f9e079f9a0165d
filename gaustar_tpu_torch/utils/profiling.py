"""Timing and debug utilities (counterpart of gaustar_tpu/utils/profiling.py).

  - `loop_bench`: the time per iteration of `fn(i, *args)` run `iters` times
    back to back, between CUDA events on a card (utils/general.device_ms),
    the host clock on the CPU.
  - `trace`: a torch.profiler trace (CPU and, on a card, CUDA activity)
    around a block, written as a Chrome trace into a directory.
  - `debug_validate`: finiteness and capacity guards for a training loop.
"""

from __future__ import annotations

import os

import torch

from gaustar_tpu_torch.utils.general import device_ms, resolve_device


def loop_bench(fn, *args, iters: int = 8, device="cuda") -> float:
    """Seconds per iteration of `fn(i, *args)` on `device`: one warm-up call
    (first launches, builds, allocations), then `iters` calls timed
    together."""
    dev = resolve_device(device)
    fn(0, *args)

    def run():
        for i in range(iters):
            fn(i, *args)

    _, ms = device_ms(dev, run)
    return ms / 1e3 / iters


class trace:
    """Record a torch.profiler trace around a block and write it to
    `log_dir`/trace.json (Chrome trace format: chrome://tracing, Perfetto).
    CUDA activity is recorded when a card is present. A profiler that
    cannot start raises.

        with trace("traces/step") as tr:
            step()
        tr.prof.key_averages()
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.prof.export_chrome_trace(os.path.join(self.log_dir, "trace.json"))
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
