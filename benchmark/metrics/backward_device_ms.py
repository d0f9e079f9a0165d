"""Device ms a traced step of the kernels, copies and fills launched inside the
backward (`refine.backward`, train/refine.py:named_grads, with the autograd
engine's thread: the backward blend kernels and the pair gather's backward in
their own spans, the rest in none of its own), the span's subtree; read by
benchmark/spans.py from the traced steps run again with the program's spans on."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    return spans.device_ms(run, "backward_device_ms")
