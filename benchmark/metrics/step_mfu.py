"""The whole step's share of the card's float32 peak over the measured
window: the operations a step needs, as the cell's program module counts
them from the step's inputs (benchmark/programs/<program>.py:
step_operations, Run.operations_per_step), times the window's steps, over
peak x the window's seconds. None where the card has no peak in
bounds.PEAKS or the program counts nothing."""

from benchmark import bounds


def read(run):
    peak = bounds.PEAKS.get(run.device_kind)
    if peak is None or run.operations_per_step is None:
        return None
    return 100.0 * run.operations_per_step * run.steps / (peak["f32_flops"] * run.window_s)
