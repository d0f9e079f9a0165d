"""Device ms a traced step of the kernels, copies and fills launched inside the
rasterizer's forward (`render.rasterize`, ops/rasterizer.py: preprocess,
binning, the pair gather, the forward blend kernels, assembly), the span's
subtree; read by benchmark/spans.py from the traced steps run again with the
program's spans on."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    return spans.device_ms(run, "raster_fwd_device_ms")
