"""Samples a traced field step evaluates: the program's counter
`field_samples` (models/neural_field.py:render_rays) over the traced field
steps run again with the program's spans on (benchmark/field_spans.py). A
count of work: a change of speed alone leaves it as it is. A cell of
another program reads nothing."""

from benchmark import field_spans

CAPTURE = field_spans.STEP_CAPTURE


def read(run):
    m = field_spans.measure(run)
    return None if m is None else m["samples_per_step"]
