"""The forward blend's share of its roofline: the summed bound time of the
traced window's blend calls (bounds.blend_counts, from their inputs alone)
over the summed device time of the forward blend kernels. Fails the run
where the captured calls and the blend kernels disagree (bounds.blend_calls)."""

from benchmark import bounds

CAPTURE = bounds.BLEND_CAPTURE


def read(run):
    return bounds.roofline(run, "fwd")
