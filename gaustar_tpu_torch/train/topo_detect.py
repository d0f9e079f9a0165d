"""Topology-change detection, detect_topo_err (counterpart of
gaustar_tpu/train/topo_detect.py; refined_mesh.py:697-920).

For every camera: render the mean depth and the SOLID-surface depth (small
in-plane scales raised to their mean so the surface is opaque); a vertex is
visible where its projected depth agrees with the solid-surface depth and it
lies away from GT depth edges; its loss is min(|gt - render| * (1 - edge) *
10, 2) sampled at its projection, averaged over the >= min_observe cameras
that see it; floor vertices are zeroed; the values are propagated over the
mesh adjacency, voxel-pooled (1 cm) and KNN-8 re-interpolated. Returns a
per-FACE weight in [0, 1], the mean of the face's vertex weights.

The per-camera work (both depth renders through the blend kernel, the GT
edge map, the projection, the gates and the sampling) runs on the device,
one camera after another; the [C, V] loss and visibility stacks stay there
and cross to the host once. The graph stages (propagation, voxel pooling)
run on the host in float64 numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
import time
import warnings

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, index_camera
from gaustar_tpu_torch.mesh.topology import MeshTopology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.image import depth_edge, query_bilinear, query_nearest
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.tools import geometry as geo
from gaustar_tpu_torch.utils.general import device_ms

log = logging.getLogger("gaustar_tpu_torch.topo_detect")


@dataclasses.dataclass(frozen=True)
class TopoDetectConfig:
    """The JAX package's TopoDetectConfig, field for field; see its comments
    for why each default departs from the reference (reference_mode() turns
    them all back)."""

    max_depth: float = 10.0
    depth_scalar: float = 3.0
    min_observe: int = 4
    voxel_size: float = 0.01
    mesh_prop: int = 20  # propagation rounds (refine.py passes 20)
    detect_floor: bool = True
    depth_agreement: float = 0.005  # 5 mm visibility floor
    # Per-vertex gate: max(depth_agreement, agreement_px * z / min(fx, fy),
    # agreement_edge * mean_edge); 0 = the reference's fixed threshold.
    agreement_px: float = 2.0
    agreement_edge: float = 1.0
    edge_threshold: float = 0.1  # refined_mesh.py:803 edge visibility cutoff
    edge_ker: int = 3
    edge_scalar: float = 1000.0  # edge-variance normalization (refined_mesh.py:800)
    # Let the blended depth's leftover transmittance fall on the
    # alpha-normalized surface depth instead of the far plane.
    composite_over_surface: bool = True
    # Opacity of every gaussian in the detection renders; None = trained.
    solid_opacity: float | None = 0.995
    # Bilinear (vs the reference's nearest-pixel) sampling at the projections.
    bilinear_query: bool = True
    aggregate: str = "trim1"  # "mean" (reference) | "trim1" | "median"

    def as_reference_mode(self) -> "TopoDetectConfig":
        """The reference's raw detection in one switch: residual
        transmittance on the far plane, trained opacities, nearest-pixel
        sampling, the fixed gate and the plain mean (refined_mesh.py:724-813)."""
        return dataclasses.replace(
            self,
            composite_over_surface=False,
            solid_opacity=None,
            bilinear_query=False,
            agreement_px=0.0,
            agreement_edge=0.0,
            aggregate="mean",
        )


def reference_mode(**overrides) -> TopoDetectConfig:
    """TopoDetectConfig preset of the reference's raw detection behaviour."""
    return TopoDetectConfig(**overrides).as_reference_mode()


@dataclasses.dataclass
class DetectTelemetry:
    """Visibility coverage of one detect_topo_err call: a gate that rejects
    every vertex would otherwise return all zeros with no signal."""

    coverage_per_cam: np.ndarray  # [C] fraction of verts passing the gate per camera
    observed_fraction: float  # fraction of verts seen by >= min_observe cameras
    flagged_faces: int  # faces with weight >= 0.6 (update_mesh_topo's cut)
    n_cameras: int = 0
    n_vertices: int = 0
    seconds: float = 0.0  # wall clock of the call, the device synchronised
    # The per-camera loop (both renders, the gates, the [C, V] stacks):
    # between CUDA events on a card, the host clock on the CPU.
    device_ms: float = 0.0
    # The largest pair demand (num_pairs) over the cameras of the normal
    # depth render and of the solid-surface one: what a static pair capacity
    # must hold for these renders to be whole.
    max_pairs: int = 0
    max_pairs_solid: int = 0

    @property
    def healthy(self) -> bool:
        return self.observed_fraction > 0.01

    def as_dict(self) -> dict:
        return {
            "detect/coverage_mean": float(self.coverage_per_cam.mean()),
            "detect/coverage_min": float(self.coverage_per_cam.min()),
            "detect/observed_fraction": float(self.observed_fraction),
            "detect/flagged_faces": int(self.flagged_faces),
            "detect/max_pairs": int(self.max_pairs),
            "detect/max_pairs_solid": int(self.max_pairs_solid),
        }


#: Telemetry of the most recent detect_topo_err call (None until the first).
last_telemetry: DetectTelemetry | None = None


def _detect_cam_body(
    render_params: sugar.SuGaRParams,
    config: sugar.SuGaRConfig,
    cam: Camera,
    gt_depth: torch.Tensor,
    gate_floor: float,
    raster_cfg: RasterConfig,
    cfg: TopoDetectConfig,
):
    """One camera's detection work on the device: ([V] masked vertex loss,
    [V] bool visibility, (num_pairs of the normal render, of the solid
    one)). The pair counts are host ints each render already synced."""
    render_depth, aux_r = sugar.render_depth(
        render_params, config, cam, max_depth=cfg.max_depth, raster_config=raster_cfg
    )
    surface_depth, aux_s = sugar.render_depth(
        render_params, config, cam, max_depth=cfg.max_depth, raster_config=raster_cfg,
        use_solid_surface=True,
    )

    if cfg.composite_over_surface:
        # Undo the bg = max_depth term, alpha-normalize the solid surface and
        # let the blended depth's leftover transmittance fall onto it.
        t_r = aux_r.final_T
        t_s = aux_s.final_T
        alpha_s = 1.0 - t_s
        sum_s = surface_depth - t_s * cfg.max_depth
        surface_depth = torch.where(
            alpha_s > 1e-3, sum_s / torch.clamp_min(alpha_s, 1e-3),
            torch.full_like(sum_s, cfg.max_depth),
        )
        render_depth = (render_depth - t_r * cfg.max_depth) + t_r * surface_depth

    edge_depth_gt = depth_edge(gt_depth, cfg.edge_ker)
    depth_diff = torch.abs(torch.clamp_max(gt_depth, cfg.max_depth) - render_depth)

    # Project the vertices to (row, col), the principal point at the image
    # centre (geometry.project, warp_mesh.py:57-76).
    verts = render_params.points
    view = cam.view
    local = verts @ view[:3, :3].T + view[:3, 3]
    focal = torch.stack([cam.fy, cam.fx]).to(torch.float32)
    center = 0.5 * torch.tensor([cam.height, cam.width], dtype=torch.float32, device=verts.device)
    rc = local[:, [1, 0]] / local[:, 2:3] * focal + center

    query = query_bilinear if cfg.bilinear_query else query_nearest
    pix_depth, valid = query(surface_depth, rc)
    gate = torch.maximum(
        local.new_tensor(gate_floor),
        cfg.agreement_px * local[:, 2] / torch.minimum(focal[0], focal[1]),
    )
    visual = valid & (torch.abs(local[:, 2] - pix_depth) < gate)

    edge_max = edge_depth_gt.max()
    edge_vis = torch.clamp_max(edge_depth_gt / torch.clamp_min(edge_max, 1e-12) * cfg.edge_scalar, 1.0)
    edge_w, _ = query(edge_vis, rc)
    visual = visual & (edge_w < cfg.edge_threshold)

    loss_map = torch.clamp_max(depth_diff * (1.0 - edge_vis) * 10.0, 2.0)
    vert_loss, _ = query(loss_map, rc)
    return torch.where(visual, vert_loss, torch.zeros_like(vert_loss)), visual, (aux_r.num_pairs, aux_s.num_pairs)


def detection_params(params: sugar.SuGaRParams, solid_opacity: float | None) -> sugar.SuGaRParams:
    """Detached copies of the leaves for a forward-only render, every opacity
    logit set to that of `solid_opacity` unless it is None. The trainee's
    leaves and graph are untouched."""
    with torch.no_grad():
        fields = {k: v.detach() for k, v in params.named()}
        if solid_opacity is not None:
            # x / (1 - x) in float64 and the log in float32, as the JAX package
            # evaluates inverse_sigmoid of a Python float.
            logit = torch.log(torch.tensor(solid_opacity / (1.0 - solid_opacity), dtype=torch.float32))
            fields["densities"] = torch.full_like(params.densities, float(logit))
    return sugar.SuGaRParams(**fields)


@torch.no_grad()
def detect_topo_err(
    params: sugar.SuGaRParams,
    config: sugar.SuGaRConfig,
    cameras: Camera,  # batched
    gt_depths,  # [C, H, W] tensor or array
    topo: MeshTopology,
    raster_cfg: RasterConfig = RasterConfig(),
    cfg: TopoDetectConfig = TopoDetectConfig(),
) -> np.ndarray:
    """Per-face weight [F] in [0, 1] (1 = topology changed), float64."""
    t_start = time.perf_counter()
    dev = params.points.device
    verts = params.points.detach().cpu().numpy().astype(np.float64)
    faces = config.faces.cpu().numpy()
    vert_num = int(topo.vert_adj.shape[0])
    verts = verts[:vert_num]

    render_params = detection_params(params, cfg.solid_opacity)

    # Mesh-discretization floor of the visibility gate: mean edge length of
    # the current mesh (TopoDetectConfig.agreement_edge).
    e0, e1 = np.asarray(topo.edges).T
    mean_edge = float(np.linalg.norm(verts[e0] - verts[e1], axis=1).mean()) if len(e0) else 0.0
    gate_floor = float(np.float32(max(cfg.depth_agreement, cfg.agreement_edge * mean_edge)))

    gt = torch.as_tensor(gt_depths, dtype=torch.float32, device=dev)
    n_cams = gt.shape[0]

    def camera_loop():
        bodies = [_detect_cam_body(render_params, config, index_camera(cameras, i), gt[i], gate_floor,
                                   raster_cfg, cfg) for i in range(n_cams)]
        return torch.stack([b[0] for b in bodies]), torch.stack([b[1] for b in bodies]), [b[2] for b in bodies]

    (vls, viss, pairs), loop_ms = device_ms(dev, camera_loop)
    # The [C, V] stacks cross to the host once.
    vert_loss_total = vls.cpu().numpy().astype(np.float64)[:, :vert_num]
    vert_visual_total = viss.cpu().numpy()[:, :vert_num]

    vert_cnt = vert_visual_total.sum(axis=0)
    observed = vert_cnt >= cfg.min_observe

    masked_losses = vert_loss_total * vert_visual_total

    global last_telemetry
    last_telemetry = DetectTelemetry(
        coverage_per_cam=vert_visual_total.mean(axis=1),
        observed_fraction=float(observed.mean()),
        flagged_faces=0,  # filled below once face weights exist
        n_cameras=n_cams,
        n_vertices=vert_num,
        device_ms=loop_ms,
        max_pairs=max(p[0] for p in pairs),
        max_pairs_solid=max(p[1] for p in pairs),
    )
    if not last_telemetry.healthy:
        msg = (
            f"detect_topo_err: visibility coverage collapsed — "
            f"{last_telemetry.observed_fraction:.2%} of {vert_num} vertices pass "
            f"the depth-agreement gate on >= {cfg.min_observe} cameras "
            f"(per-camera coverage mean "
            f"{last_telemetry.coverage_per_cam.mean():.2%}). Detection output "
            f"is all-zero noise; check depth_agreement/agreement_px "
            f"({cfg.depth_agreement} m / {cfg.agreement_px} px) against the "
            f"rig's pixel footprint, and the GT depth units."
        )
        log.warning(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=2)
    vert_loss_avg = np.zeros(vert_num)
    if cfg.aggregate == "median":
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-nan columns
            med = np.nanmedian(
                np.where(vert_visual_total, vert_loss_total, np.nan), axis=0
            )
        vert_loss_avg[observed] = med[observed]
    else:
        sums = masked_losses.sum(axis=0)
        denom = vert_cnt.astype(np.float64)
        if cfg.aggregate == "trim1":
            # Drop the largest observation where there is slack beyond
            # min_observe (TopoDetectConfig.aggregate).
            trim = vert_cnt > cfg.min_observe
            sums = np.where(trim, sums - masked_losses.max(axis=0), sums)
            denom = np.where(trim, denom - 1.0, denom)
        vert_loss_avg[observed] = sums[observed] / denom[observed]
    vert_loss_sum = vert_loss_avg[:, None].repeat(3, axis=1) * cfg.depth_scalar

    if cfg.detect_floor:
        vy = verts[:, 1]
        floor = vy < vy.min() + 0.02
        vert_loss_sum[floor] = 0
        vert_cnt = vert_cnt.copy()
        vert_cnt[floor] = cfg.min_observe + 1
        observed = vert_cnt >= cfg.min_observe

    if cfg.mesh_prop:
        vert_loss_sum = geo.mesh_vert_propagate(
            topo.vert_adj, topo.vert_adj_count, observed, vert_loss_sum, max_ite=cfg.mesh_prop
        )

    centers, vals = geo.build_voxel_from_pc(verts, vert_loss_sum, cfg.voxel_size)
    vert_loss_sum = geo.interpolate_in_voxel(verts, centers, vals, cfg.voxel_size, knn_k=8)

    # The reference reads trimesh's face colours (mean of the face's vertex
    # colours) of the vertex weights.
    vert_w = np.minimum(vert_loss_sum[:, 0], 1.0)
    face_w = vert_w[faces].mean(axis=1)
    last_telemetry.flagged_faces = int((face_w >= 0.6).sum())
    last_telemetry.seconds = time.perf_counter() - t_start
    log.info(
        "detect_topo_err: coverage mean %.1f%% (min %.1f%%), observed %.1f%%, "
        "%d/%d faces flagged",
        100 * last_telemetry.coverage_per_cam.mean(),
        100 * last_telemetry.coverage_per_cam.min(),
        100 * last_telemetry.observed_fraction,
        last_telemetry.flagged_faces,
        len(face_w),
    )
    return face_w
