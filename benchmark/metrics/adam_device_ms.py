"""Device ms a traced step of the kernels, copies and fills launched inside the
optimizer (`refine.adam`, train/optimizer.py:adam_step), the span's subtree;
read by benchmark/spans.py from the traced steps run again with the program's
spans on."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    return spans.device_ms(run, "adam_device_ms")
