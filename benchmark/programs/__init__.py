"""The programs a configuration can run, one module each, found by the
configuration's "program" key: benchmark/programs/<program>.py. A module
holds

  Program(scene, config, device)
      the system under test, built from the benchmark's inputs: step(cams,
      iteration), leaves(), first_moments(), free(), and optionally `parts`
      (seconds of its set-up's parts);
  pixels_per_step(inputs, config, mix)
      the pixels (or rays) a step trains, from the configuration, the mix
      and the inputs, never from a value the program returns;
  step_operations(run)
      the operations a step needs, counted by the benchmark from the traced
      run (the whole step's share of the card's peak, metrics/step_mfu,
      divides them by the peak), or None where there is nothing to count;
  CAPTURE (optional)
      the program function, as (module, attribute), whose arguments the
      traced window keeps for step_operations, as a metric's reader names
      one (benchmark/metrics/__init__.py).
"""

from __future__ import annotations

import time


class Laps:
    """Records into `parts` the seconds since the previous call (or since
    it was made) under each name it is called with."""

    def __init__(self, parts: dict):
        self.parts, self.last = parts, time.perf_counter()

    def __call__(self, name: str):
        now = time.perf_counter()
        self.parts[name] = now - self.last
        self.last = now
