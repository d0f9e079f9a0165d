"""The hash encoding's share of its roofline: the bound time of the traced
steps' hash_encode calls, counted from their arguments by the benchmark's
own indexing (benchmark/field_bounds.py), over the device time of the
field.encode span (benchmark/field_spans.py). A cell of another program
reads nothing."""

from benchmark import field_bounds

CAPTURE = field_bounds.ENCODE_CAPTURE


def read(run):
    return field_bounds.roofline(run)
