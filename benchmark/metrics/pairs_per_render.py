"""(gaussian, tile) pairs a render in the traced steps run again with the
program's spans on: the program's counters `pairs` and `renders`
(ops/binning.py:bin_gaussians). The rasterizer's work: a change of speed
alone leaves it as it is."""

from benchmark import spans

CAPTURE = spans.STEP_CAPTURE


def read(run):
    m = spans.measure(run)
    return None if m is None else m["pairs_per_render"]
