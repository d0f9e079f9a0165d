"""Small versions of the benchmark's configurations for the CPU tests: the
same kinds and proportions, a 9 x 12 ellipsoid, 8 cameras at 64x48."""

from __future__ import annotations

import copy

from benchmark import scene


def small_config(name: str, cameras: int = 8, width: int = 64, height: int = 48) -> dict:
    c = copy.deepcopy(scene.load_json("configs", name))
    c["mesh"]["n_lat"], c["mesh"]["n_lon"] = 9, 12
    rig = c["rig"]
    # Four times the focal length scaled with the width: the model still
    # fills a good share of the small frame.
    rig["focal"] = 4.0 * rig["focal"] * width / rig["width"]
    rig["width"], rig["height"] = width, height
    for ring in rig["rings"]:
        ring["cameras"] = cameras // len(rig["rings"])
    return c


CELLS = {"refine.sphere160.b1": "gaustar_sphere160", "refine.body160.b4": "gaustar_body160"}
