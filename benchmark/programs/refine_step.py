"""The system under test: gaustar_tpu_torch's refine step, built from the
benchmark's inputs through the port's public constructors, and the work a
step does by the benchmark's own count.

Of the modules a run loads, only this one and the span metrics'
(benchmark/spans.py) import the program. The loop set-up copies what the
port's refine loop does before its first step: fresh leaves from
init_sugar, make_lr_fn(OptimizationParams(), lr scale), adam_init and zero
unbind weights; every step is train.refine.train_step, with an int camera
at one camera a step and a list of indices at more.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import bounds
from benchmark.programs import Laps

# The traced window keeps the blend calls' arguments for step_operations.
CAPTURE = bounds.BLEND_CAPTURE


class Program:
    """The port's model, frame data, Adam state and step."""

    def __init__(self, scene, config: dict, device):
        self.parts = {}  # seconds of each part of the set-up, for the run's record
        lap = Laps(self.parts)
        from gaustar_tpu_torch.cameras import Camera, stack_cameras
        from gaustar_tpu_torch.mesh.topology import build_topology
        from gaustar_tpu_torch.models import sugar
        from gaustar_tpu_torch.ops.losses import edge_lengths, face_areas_normals
        from gaustar_tpu_torch.ops.rasterizer import RasterConfig
        from gaustar_tpu_torch.train import refine
        from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn

        self.refine = refine
        lap("port imports")
        verts = scene.verts.cpu().numpy()
        faces = scene.faces.cpu().numpy().astype(np.int32)
        self.params, self.model = sugar.init_sugar(
            verts, faces, vertex_colors=scene.colors.cpu().numpy(),
            n_gaussians_per_face=config["gaussians_per_face"], sh_levels=config["sh_degree"] + 1, device=device)
        lap("init_sugar")
        r = scene.rig
        cams = [Camera.from_w2c(r.w2c[i], r.fx[i], r.fy[i], r.cx[i], r.cy[i], r.width, r.height, device=device)
                for i in range(r.n)]
        lap("cameras")
        topo = build_topology(faces, len(verts))
        v = torch.as_tensor(verts, device=device)
        edges = torch.as_tensor(topo.edges, dtype=torch.int64, device=device)
        data = refine.FrameData(
            cameras=stack_cameras(cams),
            gt_images=scene.gt_images,
            gt_depths=scene.gt_depths,
            margins=torch.as_tensor(refine.compute_margins(r.cx, r.cy, r.width, r.height), dtype=torch.int64,
                                    device=device),
            ref_edge_len=edge_lengths(v, edges),
            ref_area=face_areas_normals(v, torch.as_tensor(faces, dtype=torch.int64, device=device))[0],
            edges=edges,
            adj_faces=torch.as_tensor(topo.adj_faces, dtype=torch.int64, device=device),
        )
        self.data = refine.with_face_edge_tables(data, faces)
        lap("topology and tables")
        self.raster = RasterConfig()
        self.cfg = refine.RefineConfig(**config["refine"])
        self.sh_deg = config["sh_degree"]
        self.lr_fn = make_lr_fn(OptimizationParams(), config["lr_scale"])
        self.opt = adam_init(self.params)
        n = self.params.scales.shape[0]
        self.unbind = torch.zeros(n, device=device)
        self.pre_sh_dc = self.params.sh_dc.detach()[:, 0, :] * 0.0
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        lap("optimizer state")

    def step(self, cams: list, iteration: int):
        """One train_step over the cameras `cams`; returns its loss (a
        device tensor, not read here)."""
        cam = cams[0] if len(cams) == 1 else list(cams)
        loss, _ = self.refine.train_step(self.params, self.opt, self.lr_fn, self.model, self.data, cam, iteration,
                                         self.cfg, self.raster, self.sh_deg, self.unbind, self.pre_sh_dc)
        return loss

    def leaves(self) -> dict:
        """{group: leaf tensor} of the model."""
        return dict(self.params.named())

    def first_moments(self) -> dict:
        """{group: Adam's first moment}."""
        return self.opt.mu

    def free(self):
        """Drop the program's state (its share of the GT stays with the
        benchmark's inputs)."""
        for name in ("params", "model", "data", "opt", "unbind", "pre_sh_dc", "lr_fn"):
            setattr(self, name, None)


def pixels_per_step(inputs, config: dict, mix: dict) -> int:
    """The pixels a step trains: W x H x the mix's cameras a step."""
    return inputs.rig.width * inputs.rig.height * mix["cameras_per_step"]


def step_operations(run) -> float:
    """The operations a step needs, counted from its inputs: both blends of
    every render in the traced steps (bounds.blend_counts) a step, SSIM's
    forward and backward a pixel, Adam an element of every parameter. The
    step's other work (geometry, projection, sorting, the other losses) is
    not counted, so this is a lower bound."""
    t = run.trace
    per_step = sum(c["fwd_ops"] + c["bwd_ops"] for c in bounds.blend_calls(t)) / t.steps
    per_step += run.pixels_per_step * bounds.SSIM_OPS_PER_PIXEL
    per_step += run.param_elements * bounds.ADAM_OPS_PER_ELEMENT
    return per_step
