"""Share of the measured window in which no kernel, copy or fill runs on the
device: 100 (1 - b / s), b the device's busy seconds a step in the traced
steps (the union of their device intervals), s the measured window's
seconds a step. The traced window itself is not the denominator: the
profiler slows the host's issue of a step (a sphere step 29 to 48 ms), so
its own idle share (the result's busy_s over window_s) reads the
profiler's cost, while the device's busy time a step it leaves as it is.
The run's earlier lines give both step times."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - (t.busy_s() / t.steps) / (run.window_s / run.steps))
