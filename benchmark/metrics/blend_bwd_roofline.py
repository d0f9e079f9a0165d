"""The backward blend's share of its roofline (see blend_fwd_roofline)."""

from benchmark import bounds

CAPTURE = bounds.BLEND_CAPTURE


def read(run):
    return bounds.roofline(run, "bwd")
