"""The whole step's share of the card's float32 peak over the device's busy
time: the operations a step needs, as the cell's program module counts them
(Run.operations_per_step), over peak x the busy seconds of a traced step
(trace.Trace.busy_s). It stands beside the kernels' rooflines where a step's
throughput is device_mpix_s, as step_mfu, over the measured window, does
where it is train_mpix_s. None where the card has no peak in bounds.PEAKS,
the program counts nothing or no device operation ran."""

from benchmark import bounds


def read(run):
    peak = bounds.PEAKS.get(run.device_kind)
    t = run.trace
    if peak is None or run.operations_per_step is None or t.busy_s() <= 0.0:
        return None
    return 100.0 * run.operations_per_step * t.steps / (peak["f32_flops"] * t.busy_s())
