"""Pixels (or rays) trained a second: the pixels a step trains, as the
cell's program module counts them (benchmark/programs/<program>.py:
pixels_per_step; the refine step's W x H x cameras a step), x the steps
completed in the window, over the window's wall seconds (its start to the
synchronize after its last step)."""


def read(run):
    return run.pixels_per_step * run.steps / run.window_s / 1e6
