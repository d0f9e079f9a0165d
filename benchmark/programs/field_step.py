"""The system under test: the port's mesh-initializer field step
(gaustar_tpu_torch.train.init_mesh.field_step) on the hash-grid NeRF at the
configuration's widths, built from the benchmark's inputs through the port's
constructors, and the work a step does by the benchmark's own count.

Set-up: the rig's Cameras (Camera.from_w2c), the GT images and the masks
(depth < the GT's miss), the visual hull carved from the masks
(neural_field.occupancy_from_masks), the field (neural_field.HashGridField)
from the benchmark's initial weights (benchmark/field_rays.py), and
torch.optim.Adam as train_field makes it. A step draws its rays
(field_rays.draw: the cameras and the iteration decide them) and calls
init_mesh.field_step through `run_field_step`, a module function whose
arguments the traced window keeps (CAPTURE): the span metrics
(benchmark/field_spans.py) run those steps again under the program's
exporter. The port is imported inside the functions that use it, so that
this module loads on a port that lacks the field step.
"""

from __future__ import annotations

import dataclasses

import torch

from benchmark import bounds, field_rays
from benchmark.programs import Laps

# The function whose arguments are one field step; the traced window keeps them.
CAPTURE = ("benchmark.programs.field_step", "run_field_step")

# Operations: the trilinear encoding, a point and level, 8 corners x (2
# weight multiplies + F multiply-adds); compositing, a sample, alpha (3),
# transmittance (3), weight (1), colour and opacity sums (8) forward and
# twice that backward; Adam, an element, as bounds.ADAM_OPS_PER_ELEMENT.
COMPOSITE_OPS_PER_SAMPLE = 3 * 15


def run_field_step(*args):
    """init_mesh.field_step(*args)."""
    from gaustar_tpu_torch.train import init_mesh

    return init_mesh.field_step(*args)


def field_config(config: dict):
    """The port's FieldConfig of the configuration's "field" block."""
    from gaustar_tpu_torch.models import neural_field as nf

    f = dict(config["field"])
    f["aabb_min"], f["aabb_max"] = tuple(f["aabb_min"]), tuple(f["aabb_max"])
    return nf.FieldConfig(**f)


class Program:
    """The port's field, frame data, occupancy, Adam state and step."""

    def __init__(self, scene, config: dict, device):
        self.parts = {}
        lap = Laps(self.parts)
        from gaustar_tpu_torch.cameras import Camera
        from gaustar_tpu_torch.models import neural_field as nf
        from gaustar_tpu_torch.train import init_mesh

        lap("port imports")
        t = config["train"]
        self.field_cfg = field_config(config)
        self.cfg = init_mesh.InitMeshConfig(rays_per_batch=t["rays_per_batch"], lr=t["lr"],
                                            mask_loss_weight=t["mask_loss_weight"],
                                            occupancy_res=t["occupancy_res"], occupancy_dilate=t["occupancy_dilate"])
        r = scene.rig
        self.height = r.height
        self.cameras = [Camera.from_w2c(r.w2c[i], r.fx[i], r.fy[i], r.cx[i], r.cy[i], r.width, r.height,
                                        device=device) for i in range(r.n)]
        self.images = scene.gt_images
        self.masks = (scene.gt_depths < config["gt"]["miss"]).to(torch.float32)
        self.fg = field_rays.foreground(self.masks)
        lap("cameras, masks and foreground")
        self.occupancy = nf.occupancy_from_masks(self.cameras, self.masks, self.field_cfg, res=t["occupancy_res"],
                                                 dilate=t["occupancy_dilate"])
        lap("occupancy")
        w = field_rays.initial_weights(config, scene, device)
        self.field = nf.HashGridField(w["tables"], w["sigma"], w["color"])
        self.opt = torch.optim.Adam(self.field.parameters(), lr=t["lr"], betas=tuple(t["betas"]), eps=t["eps"])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        lap("field and optimizer")

    def step(self, cams: list, iteration: int):
        """One field step over the cameras `cams`; returns its loss (a device
        tensor, not read here)."""
        n = self.cfg.rays_per_batch // len(cams)
        px, py, jitter = field_rays.draw(self.fg, cams, iteration, n, self.field_cfg.n_samples, self.height,
                                         self.masks.device)
        return run_field_step(self.field, self.opt, self.cameras, self.images, self.masks, list(cams), px, py,
                              jitter, self.occupancy, self.cfg, self.field_cfg)

    def _split(self, tensors: list) -> dict:
        """{leaf: tensor} of the field's parameters in order, the tables one
        leaf a level."""
        tables, *rest = tensors
        out = {f"tables.l{lvl:02d}": tables[lvl] for lvl in range(tables.shape[0])}
        names = [f"sigma.{k}{i}" for i in range(len(self.field.mlp_sigma) // 2) for k in "wb"]
        names += [f"color.{k}{i}" for i in range(len(self.field.mlp_color) // 2) for k in "wb"]
        out.update(zip(names, rest))
        return out

    def leaves(self) -> dict:
        return self._split([p.detach() for p in self.field.parameters()])

    def first_moments(self) -> dict:
        return self._split([self.opt.state[p].get("exp_avg", torch.zeros_like(p)) for p in self.field.parameters()])

    def free(self):
        for name in ("field", "opt", "occupancy", "masks", "fg", "cameras"):
            setattr(self, name, None)


def pixels_per_step(inputs, config: dict, mix: dict) -> int:
    """The rays a step trains: the mix's cameras a step x its rays a camera,
    which has to be the configuration's rays a step."""
    rays = mix["cameras_per_step"] * mix["rays_per_camera"]
    if rays != config["train"]["rays_per_batch"]:
        raise ValueError(f"the mix's {rays} rays a step differ from the configuration's "
                         f"{config['train']['rays_per_batch']}")
    return rays


def step_operations(run) -> float | None:
    """The operations a step needs, counted from the field's configuration
    as the traced steps passed it: the encoding's trilinear multiply-adds,
    the two MLPs' matrix products forward and backward (the backward twice
    the forward: the input's and the weights' gradients), compositing, and
    Adam at every element. The SH encoding, sampling and the gradient's
    scatter are not counted, so this is a lower bound. None where the traced
    steps called no field step."""
    calls = run.trace.captures.get(CAPTURE, [])
    if not calls:
        return None
    field_cfg = dataclasses.asdict(calls[0][0][-1])
    return operations(field_cfg, run.pixels_per_step, run.param_elements)


def operations(field: dict, rays: int, param_elements: int) -> float:
    """The operations of a step of `rays` rays of the field `field` (the
    configuration's "field" keys) with `param_elements` parameters."""
    points = rays * field["n_samples"]
    per_point = field["n_levels"] * 8 * (2 + 2 * field["n_features"])
    per_point += 3 * sum(2 * i * o for widths in field_rays.layer_widths(field).values() for i, o in widths)
    per_point += COMPOSITE_OPS_PER_SAMPLE
    return float(points * per_point + param_elements * bounds.ADAM_OPS_PER_ELEMENT)
