"""Per-frame refinement loop, the hot training loop of GauSTAR (counterpart of
gaustar_tpu/train/refine.py; gaustar_trainers/refine.py:39-866).

Loss stack (refine.py:584-748):
  rgb      0.8*L1 + 0.2*DSSIM on margin-masked images, green background
  depth    0.1 * L1 on foreground (gt_depth < max_depth)
  mask     1.0 * L1 pulling background rendered depth to max_depth
  sh_reg   1.0 * L2 between current and previous-frame dc SH (if enabled)
  nc       0.5 * mesh normal consistency
  edge_iso, area_iso   factor * isometry terms
  unbind   100 * w*|delta_t| + 1 * w*|delta_r.xyz| (once loose-bound)
  opacity  relu(0.8 - opacity).mean()
  laplacian, area_reg   default-off (use_laplacian_smoothing, area_reg_from)
RGB and depth come from one fused 4-channel render, channels-major.

`refine_frame` takes the topology-detection hook (`detect_topo_fn`,
refine.py:720-737): called once, at `loose_bind_from`, it may loose-bind the
model. It writes the run's config.json (`config_dump_path`) and a mid-frame
refine state every `checkpoint_every` iterations (`checkpoint_path`), from
which `resume` continues on the schedule of an uninterrupted run. Not
needed on the GPU: the JAX package's capacity probing (`auto_size_caps`; the
port sizes its pair buffers exactly), traced hyperparameters and the scanned
camera batch.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, index_camera
from gaustar_tpu_torch.io import checkpoint as ckpt_io
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import losses, pixel_loss
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.ops.segment import gather_tables
from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, adam_step, make_lr_fn
from gaustar_tpu_torch.utils.profiling import span


@dataclasses.dataclass(frozen=True)
class RefineConfig:
    """Hyperparameters of refined_training (refine.py:24-163 + opti_config)."""

    num_iterations: int = 2000
    sh_levels: int = 3
    bg_color: tuple = (0.0, 1.0, 0.0)
    dssim_factor: float = 0.2
    use_margin: bool = True
    depth_loss_factor: float = 0.1
    depth_loss_from: int = 0
    mask_loss_factor: float = 1.0
    mask_loss_from: int = 0
    max_depth: float = 10.0
    sh_reg_loss_factor: float = 1.0
    use_sh_reg: bool = False
    normal_consistency_factor: float = 0.5
    edge_iso_factor: float = 1000.0
    edge_iso_from: int = 0
    area_iso_factor: float = 1000.0
    area_iso_from: int = 0
    # Default-off knobs of the reference (refine.py:117-122, 143-144).
    use_laplacian_smoothing: bool = False
    laplacian_smoothing_factor: float = 5.0  # the "uniform" method
    area_reg_loss_factor: float = 0.1
    area_reg_from: int = 999999  # inactive unless below num_iterations
    use_opacity_reg: bool = True
    min_opacity: float = 0.8
    loose_bind_from: int = 1000
    unbind_threshold: int = 100  # fully flagged gaussians needed to unbind (refine.py:720-737)
    loose_bind_factor_t: float = 100.0
    loose_bind_factor_r: float = 1.0
    do_sh_warmup: bool = True


@dataclasses.dataclass
class FrameData:
    """Per-frame training data on the device."""

    cameras: Camera  # batched (leading axis C)
    gt_images: torch.Tensor  # [C, H, W, 3], green background composited
    gt_depths: torch.Tensor  # [C, H, W], background >= max_depth
    margins: torch.Tensor  # [C, 4] int (left, right, top, bottom)
    ref_edge_len: torch.Tensor  # [E]
    ref_area: torch.Tensor  # [F]
    edges: torch.Tensor  # [E, 2] int64
    adj_faces: torch.Tensor  # [E_int, 2] int64
    # Fused edge-iso tables (losses.face_edge_tables): the edge-iso loss then
    # rides the shared verts[faces] gather.
    face_edge_ref: Any = None  # [F, 3]
    face_edge_w: Any = None  # [F, 3]
    # Static backward tables of the normals[adj_faces] gather.
    adj_gather: Any = None


def with_face_edge_tables(data: FrameData, faces) -> FrameData:
    """Attach the fused edge-iso tables and the normals[adj_faces] tables."""
    dev = data.ref_area.device
    adj = data.adj_faces.cpu().numpy()
    ref, w = losses.face_edge_tables(
        np.asarray(faces), data.edges.cpu().numpy(), data.ref_edge_len.cpu().numpy()
    )
    return dataclasses.replace(
        data,
        face_edge_ref=torch.as_tensor(ref, device=dev),
        face_edge_w=torch.as_tensor(w, device=dev),
        adj_gather=gather_tables(adj, len(faces), dev),
    )


def compute_margins(cx, cy, width, height) -> np.ndarray:
    """Per-camera crop margins from the principal point (refine.py:255-270)."""
    c = len(np.atleast_1d(cx))
    m = np.ones((c, 4), np.int32)
    cx = np.atleast_1d(np.asarray(cx))
    cy = np.atleast_1d(np.asarray(cy))
    for i in range(c):
        if cx[i] < width / 2:
            m[i, 0] = int(width / 2 - cx[i]) + 1
        else:
            m[i, 1] = int(cx[i] - width / 2) + 1
        if cy[i] < height / 2:
            m[i, 2] = int(height / 2 - cy[i]) + 1
        else:
            m[i, 3] = int(cy[i] - height / 2) + 1
    return m


@span("loss.pixel")
def pixel_losses(data: FrameData, cam_idx: int, iteration: int, cfg: RefineConfig, img_cm, pred_depth):
    """The camera-dependent terms (rgb + depth + mask) of a channels-major
    render, from the four means of ops/pixel_loss (one CUDA forward and one
    backward on the card)."""
    margin = data.margins[cam_idx] if cfg.use_margin else None
    l1, ssim_v, depth_l1, mask_l1 = pixel_loss.pixel_loss_means(
        img_cm, pred_depth, data.gt_images[cam_idx], data.gt_depths[cam_idx], margin, cfg.max_depth).unbind()
    f = cfg.dssim_factor
    rgb = (1.0 - f) * l1 + f * (1.0 - ssim_v)
    loss = rgb
    loss_dict = {"rgb_loss": rgb}
    depth_loss = cfg.depth_loss_factor * depth_l1
    mask_loss = cfg.mask_loss_factor * mask_l1
    if iteration > cfg.depth_loss_from:
        loss = loss + depth_loss
    if iteration > cfg.mask_loss_from:
        loss = loss + mask_loss
    loss_dict["depth_loss"] = depth_loss
    loss_dict["mask_loss"] = mask_loss
    return loss, loss_dict


def _abs(x):
    """|x| with the JAX package's gradient: +1 at x = 0, where torch.abs has 0.
    The deltas start at 0, so this decides the unbind terms' first steps."""
    return torch.where(x >= 0, x, -x)


@span("loss.mesh")
def shared_losses(params, model_config, data: FrameData, iteration: int, cfg: RefineConfig,
                  unbind_weight=None, pre_sh_dc=None):
    """The camera-independent terms: sh_reg, mesh losses, unbind, opacity."""
    loss = 0.0
    loss_dict = {}
    if cfg.use_sh_reg and pre_sh_dc is not None:
        sh_reg = cfg.sh_reg_loss_factor * ((pre_sh_dc - params.sh_dc[:, 0, :]) ** 2).mean()
        loss = loss + sh_reg
        loss_dict["sh_reg_loss"] = sh_reg

    verts, faces = sugar.surface_mesh(params, model_config)
    reg = losses.mesh_regularizers(
        verts, faces, data.adj_faces, data.ref_area,
        face_edge_ref=data.face_edge_ref, face_edge_w=data.face_edge_w,
        edges=data.edges, ref_edge_len=data.ref_edge_len,
        tables=model_config.face_gather, adj_tables=data.adj_gather,
    )
    nc = cfg.normal_consistency_factor * reg["nc"]
    loss = loss + nc
    loss_dict["nc_loss"] = nc

    edge = cfg.edge_iso_factor * reg["edge"]
    if iteration > cfg.edge_iso_from:
        loss = loss + edge
    loss_dict["edge_loss"] = edge

    area = cfg.area_iso_factor * reg["area"]
    if iteration > cfg.area_iso_from:
        loss = loss + area
    loss_dict["area_loss"] = area

    if cfg.use_laplacian_smoothing:
        lap = cfg.laplacian_smoothing_factor * losses.mesh_laplacian_smoothing_loss(verts, data.edges)
        loss = loss + lap
        loss_dict["laplacian_loss"] = lap
    if cfg.area_reg_from < cfg.num_iterations:
        area_reg = cfg.area_reg_loss_factor * losses.mesh_area_reg_loss(verts, faces)
        if iteration > cfg.area_reg_from:
            loss = loss + area_reg
        loss_dict["area_reg_loss"] = area_reg

    if model_config.loose_bind and unbind_weight is not None:
        w = unbind_weight[:, None]
        loss = loss + cfg.loose_bind_factor_t * (w * _abs(params.delta_t)).mean()
        loss = loss + cfg.loose_bind_factor_r * (w * _abs(params.delta_r[..., 1:])).mean()

    if cfg.use_opacity_reg:
        op_reg = torch.relu(cfg.min_opacity - sugar.strengths(params)).mean()
        loss = loss + op_reg
        loss_dict["opacity_reg"] = op_reg
    return loss, loss_dict


def compute_losses(params, model_config, data: FrameData, cam_idx: int, iteration: int,
                   cfg: RefineConfig, raster_cfg: RasterConfig, sh_deg: int,
                   unbind_weight=None, pre_sh_dc=None, geom=None):
    """One iteration's full loss (refine.py:552-748); differentiable in params.
    Returns (loss, loss_dict)."""
    camera = index_camera(data.cameras, cam_idx)
    img, pred_depth, aux = sugar.render_rgbd(
        params, model_config, camera, bg=cfg.bg_color, sh_deg=sh_deg,
        max_depth=cfg.max_depth, raster_config=raster_cfg, geom=geom, layout="cm",
    )
    loss, loss_dict = losses_after_render(params, model_config, data, cam_idx, iteration, cfg, img, pred_depth,
                                          unbind_weight, pre_sh_dc)
    loss_dict["num_pairs"] = aux.num_pairs
    return loss, loss_dict


def losses_after_render(params, model_config, data: FrameData, cam_idx: int, iteration: int,
                        cfg: RefineConfig, img_cm, pred_depth, unbind_weight=None, pre_sh_dc=None):
    """The whole loss stack given a channels-major render (img_cm [3, H, W],
    pred_depth [H, W]): one implementation for the single-device step
    (compute_losses) and the gaussian-sharded one (parallel/gauss2d.py).
    Returns (loss, loss_dict)."""
    loss, loss_dict = pixel_losses(data, cam_idx, iteration, cfg, img_cm, pred_depth)
    s_loss, s_dict = shared_losses(params, model_config, data, iteration, cfg, unbind_weight, pre_sh_dc)
    loss_dict.update(s_dict)
    return loss + s_loss, loss_dict


def compute_losses_multi(params, model_config, data: FrameData, cam_idxs, iteration: int,
                         cfg: RefineConfig, raster_cfg: RasterConfig, sh_deg: int,
                         unbind_weight=None, pre_sh_dc=None):
    """Mean of compute_losses over a batch of cameras. The gaussian
    primitives are computed once and shared by the B renders; `num_pairs`
    reports the largest camera's pair count."""
    geom = sugar.geom_primitives(params, model_config)
    total = None
    b_dict: dict = {}
    for cam in cam_idxs:
        loss_b, ld_b = compute_losses(
            params, model_config, data, int(cam), iteration, cfg, raster_cfg, sh_deg,
            unbind_weight, pre_sh_dc, geom=geom,
        )
        total = loss_b if total is None else total + loss_b
        for k, v in ld_b.items():
            if k == "num_pairs":
                b_dict[k] = max(b_dict.get(k, 0), v)
            else:
                b_dict[k] = v if k not in b_dict else b_dict[k] + v
    inv = 1.0 / len(cam_idxs)
    for k in b_dict:
        if k != "num_pairs":
            b_dict[k] = b_dict[k] * inv
    return total * inv, b_dict


@span("refine.backward")
def named_grads(loss, params) -> dict:
    """{group: gradient of loss} for every named group (zeros where unused)."""
    named = params.named()
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(named, gs)}


def sh_deg_at(iteration: int, cfg: RefineConfig) -> int:
    """SH warmup: degree 0, +1 level every num_iterations/4 (refine.py:151-156)."""
    if not cfg.do_sh_warmup:
        return cfg.sh_levels - 1
    every = max(cfg.num_iterations // 4, 1)
    return min(iteration // every + 1, cfg.sh_levels) - 1


def train_step(params, opt_state, lr_fn, model_config, data: FrameData, cam_idx, iteration: int,
               cfg: RefineConfig, raster_cfg: RasterConfig, sh_deg: int,
               unbind_weight=None, pre_sh_dc=None):
    """One refine step (the body of the JAX make_train_step): loss, gradients
    of every parameter group, named-group Adam in place. `cam_idx` is an int
    or a sequence of ints (a camera batch). Returns (loss, loss_dict). The
    span `refine.step` carries the iteration to every span inside it."""
    with span("refine.step", step=iteration):
        if isinstance(cam_idx, (list, tuple)):
            loss, loss_dict = compute_losses_multi(
                params, model_config, data, cam_idx, iteration, cfg, raster_cfg, sh_deg,
                unbind_weight, pre_sh_dc,
            )
        else:
            loss, loss_dict = compute_losses(
                params, model_config, data, cam_idx, iteration, cfg, raster_cfg, sh_deg,
                unbind_weight, pre_sh_dc,
            )
        adam_step(params, named_grads(loss, params), opt_state, lr_fn)
        return loss.detach(), {k: (v.detach() if torch.is_tensor(v) else v) for k, v in loss_dict.items()}


def refine_frame(
    params: sugar.SuGaRParams,
    model_config: sugar.SuGaRConfig,
    data: FrameData,
    cfg: RefineConfig,
    raster_cfg: RasterConfig = RasterConfig(),
    opt_params: OptimizationParams | None = None,
    spatial_lr_scale: float | None = None,
    detect_topo_fn: Callable | None = None,
    pre_sh_dc=None,
    seed: int = 0,
    log_every: int = 50,
    log_fn: Callable | None = None,
    config_dump_path: str | None = None,
    checkpoint_every: int = 0,
    checkpoint_path: str | None = None,
    resume: bool = False,
):
    """Refinement of one frame (refined_training, refine.py:39-866), on the
    device the params live on. The caller's params are left as they were.

    `detect_topo_fn(params, config) -> [F] face weights in [0, 1]` is called
    once, before the step at `cfg.loose_bind_from`. If at least
    `cfg.unbind_threshold` gaussians are fully flagged, the model is
    loose-bound: the same leaves and Adam state, with the delta regularizers
    on; `log_fn` then receives the decision with `refine_max_pairs`, the
    largest pair demand of one render among the iterations before it.
    Returns (params, model_config, history).

    `config_dump_path`: write the run's hyperparameters as json
    (refine.py:459-519). `checkpoint_every` > 0 with `checkpoint_path`:
    save the refine state (io/checkpoint.save_refine_state) after every
    `checkpoint_every`-th step. `resume` with an existing `checkpoint_path`:
    restore params, Adam state and iteration, replay the loose-bind
    transition, and fast-forward the camera-order rng, so the run continues
    exactly as one that was never interrupted."""
    params = sugar.fresh_params(params)
    n_faces = model_config.faces.shape[0]
    if spatial_lr_scale is None:
        # refine.py:408: 10 * bbox_radius / sqrt(n_faces)
        pts = params.points.detach().cpu().numpy()
        radius = float(np.linalg.norm(pts.max(0) - pts.min(0)) / 2.0)
        spatial_lr_scale = 10.0 * radius / np.sqrt(n_faces)
    if opt_params is None:
        opt_params = OptimizationParams(iterations=cfg.num_iterations)
    lr_fn = make_lr_fn(opt_params, spatial_lr_scale)
    opt_state = adam_init(params)

    if config_dump_path:
        dump = {
            **dataclasses.asdict(cfg),
            "spatial_lr_scale": float(spatial_lr_scale),
            "n_faces": int(n_faces),
            "n_gaussians": int(params.scales.shape[0]),
            "opt": dataclasses.asdict(opt_params),
            "raster": dataclasses.asdict(raster_cfg),
        }
        with open(config_dump_path, "w") as f:
            json.dump(dump, f, indent=2, sort_keys=True)

    n_cams = data.gt_images.shape[0]
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_cams)
    cursor = 0
    unbind_weight = torch.zeros(params.scales.shape[0], device=params.scales.device)
    if pre_sh_dc is None:
        pre_sh_dc = params.sh_dc.detach()[:, 0, :] * 0.0
    history = []
    max_pairs = 0

    start_it = 1
    if resume and checkpoint_path is not None and os.path.exists(checkpoint_path):
        params, opt_state, done_it, uw_saved, was_loose = ckpt_io.load_refine_state(
            checkpoint_path, params.points.device)
        if was_loose and not model_config.loose_bind:
            params, model_config = sugar.loose_bound(params, model_config)
        if uw_saved is not None:
            unbind_weight = uw_saved
        start_it = done_it + 1
        for _ in range(done_it):
            if cursor >= n_cams:
                order = rng.permutation(n_cams)
                cursor = 0
            cursor += 1

    for it in range(start_it, cfg.num_iterations + 1):
        if cursor >= n_cams:
            order = rng.permutation(n_cams)
            cursor = 0
        cam_idx = int(order[cursor])
        cursor += 1

        # One-time unbind decision (refine.py:720-737), in float64 numpy as
        # the JAX package takes it: a gaussian counts only where all three
        # of its face's vertex weights saturate, so w == 0 exactly.
        if it == cfg.loose_bind_from and detect_topo_fn is not None and not model_config.loose_bind:
            face_weight = np.asarray(detect_topo_fn(params, model_config))
            w = 1.0 - np.repeat(face_weight, model_config.n_gaussians_per_face)
            n_changed = int((w == 0).sum())
            if n_changed >= cfg.unbind_threshold:
                params, model_config = sugar.loose_bound(params, model_config)
                unbind_weight = torch.as_tensor(w, dtype=torch.float32, device=unbind_weight.device)
            if log_fn:
                log_fn({"iteration": it, "unbind_changed": n_changed, "loose_bind": model_config.loose_bind,
                        "refine_max_pairs": max_pairs})

        loss, loss_dict = train_step(
            params, opt_state, lr_fn, model_config, data, cam_idx, it, cfg, raster_cfg,
            sh_deg_at(it, cfg), unbind_weight, pre_sh_dc,
        )
        max_pairs = max(max_pairs, loss_dict["num_pairs"])
        if log_every and it % log_every == 0:
            entry = {k: float(v) for k, v in loss_dict.items()}
            entry["iteration"] = it
            entry["loss"] = float(loss)
            history.append(entry)
            if log_fn:
                log_fn(entry)
        if checkpoint_every and checkpoint_path and it % checkpoint_every == 0:
            ckpt_io.save_refine_state(checkpoint_path, params, opt_state, it, unbind_weight, model_config.loose_bind)
    return params, model_config, history
