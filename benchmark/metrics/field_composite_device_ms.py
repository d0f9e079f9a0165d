"""Device ms a traced step of the kernels, copies and fills launched inside
the field's volume compositing (models/neural_field.py:render_rays:
alpha, the transmittance scan, the weighted sums) (`field.composite`), the span's subtree; read by benchmark/field_spans.py from the
traced field steps run again with the program's spans on. A cell of
another program reads nothing."""

from benchmark import field_spans

CAPTURE = field_spans.STEP_CAPTURE


def read(run):
    return field_spans.device_ms(run, "field_composite_device_ms")
