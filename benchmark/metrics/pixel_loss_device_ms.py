"""Device ms a traced step of the kernels, copies and fills launched inside the
camera-dependent losses (`loss.pixel`, train/refine.py:pixel_losses: L1, SSIM,
depth and mask), the span's subtree; read by benchmark/spans.py from the traced
steps run again with the program's spans on."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    return spans.device_ms(run, "pixel_loss_device_ms")
