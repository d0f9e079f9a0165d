"""Device ms a traced step of the kernels launched inside the pixel losses'
backward (`loss.pixel_bwd`, gaustar_tpu_torch/ops/pixel_loss.py:
PixelLosses.backward, on the autograd engine's thread inside
`refine.backward`), the span's own device time; read by benchmark/spans.py
from the traced steps run again with the program's spans on. A program
without that span reads nothing."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    m = spans.measure(run)
    return None if m is None else m["self_device_ms"].get("loss.pixel_bwd")
