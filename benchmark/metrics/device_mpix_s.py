"""Pixels (or rays) trained a second of the device's busy time: the pixels a
step trains, as the cell's program module counts them, x the traced steps,
over the seconds in which some kernel, copy or fill ran in them (the union
of their device intervals, trace.Trace.busy_s). The host's pace, which
decides train_mpix_s where the device idles between launches, is not in
it: it is the device's own cost of a step's work. The traced steps run
after the measured window, also in a run with --trace 0. None where no
device operation ran (a run on the CPU)."""

TRACE = True


def read(run):
    t = run.trace
    if t.busy_s() <= 0.0:
        return None
    return run.pixels_per_step * t.steps / t.busy_s() / 1e6
