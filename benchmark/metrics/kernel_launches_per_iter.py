"""CUDA kernels the traced window ran, a step."""


def read(run):
    t = run.trace
    lo, hi = t.window
    return sum(1 for _, a, _b in t.kernels if lo <= a < hi) / t.steps
