"""Device ms a traced step of the kernels, copies and fills launched inside
the field step's backward (train/init_mesh.py:field_step, with the
autograd engine's thread: the table rows' index-add, the MLPs' gradients) (`field.backward`), the span's subtree; read by benchmark/field_spans.py from the
traced field steps run again with the program's spans on. A cell of
another program reads nothing."""

from benchmark import field_spans

CAPTURE = field_spans.STEP_CAPTURE


def read(run):
    return field_spans.device_ms(run, "field_backward_device_ms")
