"""The whole step's share of the card's float32 peak over the measured
window: the operations a step needs, counted from its inputs (both blends of
every render in the traced steps, bounds.blend_counts, a step; SSIM's
forward and backward a render; Adam over every parameter element), times
the window's steps, over peak x the window's seconds. The step's other work
(geometry, projection, sorting, the other losses) is not counted, so this is
a lower bound."""

from benchmark import bounds

CAPTURE = bounds.BLEND_CAPTURE


def read(run):
    t = run.trace
    peak = bounds.PEAKS.get(run.device_kind)
    if peak is None:
        return None
    per_step = sum(c["fwd_ops"] + c["bwd_ops"] for c in bounds.blend_calls(t)) / t.steps
    per_step += run.pixels_per_step * bounds.SSIM_OPS_PER_PIXEL
    per_step += run.param_elements * bounds.ADAM_OPS_PER_ELEMENT
    return 100.0 * per_step * run.steps / (peak["f32_flops"] * run.window_s)
