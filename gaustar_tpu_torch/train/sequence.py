"""Per-frame sequence driver (counterpart of gaustar_tpu/train/sequence.py;
train_seq.py:101-249).

`run_sequence` runs, for each frame of an on-disk dataset (io/dataset.py):
  1. `refine_one_frame`: bind a SuGaR model to the coarse mesh (frame 0:
     init_mesh with edge-iso 1000 and area-iso 5000; later frames: the
     flow-warped warp_smooth mesh, area-iso 1000, edge-iso off, SH-reg prior
     and SH initialisation from the previous frame's checkpoint) and refine
     it, with unbind detection at iters/2 unless disabled;
  2. `update_frame_topology`, if the model loose-bound: TSDF-fuse the
     rendered views, detect again, update the mesh topology, recolour the
     new vertices from the GT views and re-refine on the updated mesh for
     iters/2 with unbinding off; run_sequence writes updated_mesh.obj and
     face_corr.npz (track_face_mask + ref_area);
  3. exports: checkpoint (.npz + .json), 3DGS .ply, color_mesh.obj;
  4. the flow warp of the color mesh (tools/warp_mesh.py) that initializes
     the next frame.

File contracts mirror the reference (SURVEY section 1) and the JAX package:
  work/<NNNN>/<iters>.npz (+.json), color_mesh.obj, <NNNN>.ply,
  work/<NNNN>/face_corr.npz, updated_mesh.obj, config.json, metrics.jsonl,
  work/<NNNN+interval>/coarse_mesh/warp_smooth.obj

The JAX package's compile-reuse devices (face-count bucketing, background
prewarm of the detection and fusion programs, probed pair capacities) have
no use in an eager program; SequenceConfig keeps their fields, and setting
them raises.
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch

from gaustar_tpu_torch.cameras import stack_cameras
from gaustar_tpu_torch.io import checkpoint as ckpt_io
from gaustar_tpu_torch.io import dataset as ds
from gaustar_tpu_torch.io.meshio import read_obj, write_obj
from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.losses import edge_lengths, face_areas_normals
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.tools import warp_mesh
from gaustar_tpu_torch.train import mesh_update, refine, topo_detect
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.logging import MetricLogger


@dataclasses.dataclass
class SequenceConfig:
    """train_seq.py:17-98 argument surface, the JAX package's fields and
    defaults, except that `face_bucket` and `prewarm_programs` default to
    off: the port has neither, and a config that sets them (or
    `auto_size_caps`) is refused by refine_one_frame."""

    data_root: str = ""
    work_root: str = ""
    frame_0: int = 0
    frame_end: int = 1
    interval: int = 1
    refinement_iterations: int = 2000
    gaussians_per_triangle: int = 6
    disable_mesh_update: bool = False
    sh_reg: bool = True
    from_humanrf: bool = True
    downscale: float = 1.0
    init_mesh_name: str = "init_mesh_100k.obj"
    max_depth: float = 10.0
    # scale clamps relative to ref mesh mean edge (refine.py:307-311)
    max_gaussian_scalar: float = 5.0
    min_gaussian_scalar: float = 0.1
    # mesh-surgery overrides (reference defaults; toy scales need looser values)
    force_watertight: bool = True
    boundary_pad: float = 0.02
    update_cc_face_threshold: int = 80
    unbind_threshold: int = 100  # refine.py:720-737 flagged-gaussian count
    # TSDF fusion (refined_mesh.py:312 defaults assume meter-scale rigs);
    # fusion_simplify_face_num > 0 decimates the fused mesh before grafting.
    fusion_voxel_size: float = 0.008
    fusion_sdf_trunc: float = 0.02
    fusion_depth_trunc: float = 6.0
    fusion_max_dim: int = 512
    fusion_simplify_face_num: int = 0
    fusion_use_orbit: bool = True  # 60 orbit cams + rig (refined_mesh.py:342-345)
    fusion_solid_opacity: float | None = None  # see extract_mesh_fusion
    # None = the reference's 10 * bbox_radius / sqrt(n_faces) (refine.py:408).
    # Short budgets may boost it so unbound gaussians reach new surfaces.
    spatial_lr_scale: float | None = None
    # Seed the grafted faces' colours by multi-view GT voting instead of the
    # fusion colours (ahq2gaustar:124-160). Off = the reference's behaviour.
    recolor_new_faces: bool = True
    recolor_depth_agreement: float = 0.02
    # Compile-reuse devices of the JAX package; the port refuses them.
    auto_size_caps: float | None = None
    prewarm_programs: bool = False
    face_bucket: int | None = None


def _check_supported(seq: SequenceConfig):
    for name, off in (("face_bucket", None), ("auto_size_caps", None), ("prewarm_programs", False)):
        if getattr(seq, name) != off:
            raise NotImplementedError(
                f"SequenceConfig.{name}={getattr(seq, name)!r}: a compile-reuse device of the JAX "
                f"package, which the eager port does not have; set it to {off!r}")


def _recolor_new_vertices(um, track_face_mask, cams, gt_images, gt_depths,
                          vc, depth_agreement=0.02, max_depth=10.0):
    """Replace colors of vertices introduced by the mesh update with multi-view
    GT color votes (projection + depth-visibility, like ahq2gaustar.py:124-160).
    Vertices also used by tracked faces, and unobserved vertices, keep `vc`.
    Host numpy; `gt_images` / `gt_depths` are arrays."""
    faces = np.asarray(um.faces)
    # Surviving tracked faces are the PREFIX of the updated mesh (the
    # tracking-prefix invariant, refined_mesh.py:656-664).
    n_tracked = int(np.asarray(track_face_mask, bool).sum())
    tracked = np.zeros(len(faces), bool)
    tracked[:n_tracked] = True
    used_by_tracked = np.zeros(len(um.verts), bool)
    used_by_new = np.zeros(len(um.verts), bool)
    if tracked.any():
        used_by_tracked[np.unique(faces[tracked])] = True
    if (~tracked).any():
        used_by_new[np.unique(faces[~tracked])] = True
    new_verts = used_by_new & ~used_by_tracked
    if not new_verts.any():
        return vc

    verts = np.asarray(um.verts, np.float64)[new_verts]
    acc = np.zeros((len(verts), 3))
    cnt = np.zeros(len(verts))
    for ci, cam in enumerate(cams):
        view = cam.view.cpu().numpy()
        local = verts @ view[:3, :3].T + view[:3, 3]
        z = local[:, 2]
        fx = cam.width / (2.0 * float(cam.tanfovx))
        fy = cam.height / (2.0 * float(cam.tanfovy))
        px = local[:, 0] / np.maximum(z, 1e-6) * fx + float(cam.cx)
        py = local[:, 1] / np.maximum(z, 1e-6) * fy + float(cam.cy)
        ix = np.int32(px + 0.5)
        iy = np.int32(py + 0.5)
        ok = (z > 1e-3) & (ix >= 0) & (ix < cam.width) & (iy >= 0) & (iy < cam.height)
        ixc = np.clip(ix, 0, cam.width - 1)
        iyc = np.clip(iy, 0, cam.height - 1)
        d = np.asarray(gt_depths[ci])[iyc, ixc]
        vis = ok & (np.abs(z - d) < depth_agreement) & (d < max_depth)
        col = np.asarray(gt_images[ci])[iyc, ixc]
        acc[vis] += col[vis]
        cnt[vis] += 1
    seen = cnt >= 1
    out = np.array(vc, np.float64, copy=True)
    idx = np.flatnonzero(new_verts)[seen]
    out[idx] = acc[seen] / cnt[seen, None]
    return out


def _mesh_stats(verts, faces):
    """(topology, reference edge lengths, reference face areas) of a mesh,
    the lengths and areas in float32 as the losses compute them."""
    topo = build_topology(faces, len(verts))
    v = torch.as_tensor(np.asarray(verts, np.float32))
    el = edge_lengths(v, torch.as_tensor(topo.edges, dtype=torch.int64)).numpy()
    areas, _ = face_areas_normals(v, torch.as_tensor(np.asarray(faces), dtype=torch.int64))
    return topo, el, areas.numpy()


def _build_frame_data(cams, gt_images, gt_depths, topo, ref_edge_len, ref_area, faces=None,
                      device="cuda") -> refine.FrameData:
    dev = resolve_device(device)
    batch = stack_cameras(cams)
    margins = refine.compute_margins(
        batch.cx.cpu().numpy(), batch.cy.cpu().numpy(), batch.width, batch.height
    )

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    def i64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int64, device=dev)

    data = refine.FrameData(
        cameras=batch,
        gt_images=f32(gt_images),
        gt_depths=f32(gt_depths),
        margins=i64(margins),
        ref_edge_len=f32(ref_edge_len),
        ref_area=f32(ref_area),
        edges=i64(topo.edges),
        adj_faces=i64(topo.adj_faces),
    )
    if faces is not None:
        data = refine.with_face_edge_tables(data, faces)
    return data


def refine_one_frame(
    seq: SequenceConfig,
    frame: int,
    mesh_verts: np.ndarray,
    mesh_faces: np.ndarray,
    mesh_colors: np.ndarray | None,
    cams,
    gt_images,
    gt_depths,
    raster_cfg: RasterConfig,
    is_first_frame: bool,
    pre_sh: np.ndarray | None = None,
    ref_area_override: np.ndarray | None = None,
    num_iterations: int | None = None,
    enable_unbind: bool = True,
    detect_cfg: topo_detect.TopoDetectConfig | None = None,
    init_sh: tuple | None = None,
    log_fn=None,
    log_every: int = 50,
    device="cuda",
    config_dump_path: str | None = None,
    metrics_path: str | None = None,
):
    """One refined_training invocation. Returns (params, config, data, topo,
    history).

    `cams` is a list of Cameras on `device`; `gt_images` [C, H, W, 3] and
    `gt_depths` [C, H, W] arrays or tensors. `init_sh = (sh_dc [N,1,3],
    sh_rest [N,K-1,3])` initializes the SH coefficients from the previous
    frame's checkpoint (refine.py:325-383); ignored if the gaussian count
    changed. `log_fn` receives refine_frame's log entries every `log_every`
    iterations, the detection's telemetry and the unbind decision;
    `metrics_path` also appends them to a JSONL metric stream
    (utils/logging.MetricLogger, one run_meta line per call), and
    `config_dump_path` receives the run's config.json."""
    _check_supported(seq)
    dev = resolve_device(device)
    topo, ref_edge_len, ref_area = _mesh_stats(mesh_verts, mesh_faces)
    if ref_area_override is not None:
        ref_area = ref_area_override

    mean_edge = float(ref_edge_len.mean())
    params, config = sugar.init_sugar(
        mesh_verts,
        mesh_faces,
        vertex_colors=mesh_colors,
        n_gaussians_per_face=seq.gaussians_per_triangle,
        min_scale=mean_edge * seq.min_gaussian_scalar,
        max_scale=mean_edge * seq.max_gaussian_scalar,
        device=dev,
    )
    if init_sh is not None:
        dc, rest = init_sh
        if (
            dc is not None
            and tuple(dc.shape) == tuple(params.sh_dc.shape)
            and tuple(rest.shape) == tuple(params.sh_rest.shape)
        ):
            with torch.no_grad():
                params.sh_dc.copy_(torch.as_tensor(np.asarray(dc, np.float32)))
                params.sh_rest.copy_(torch.as_tensor(np.asarray(rest, np.float32)))

    data = _build_frame_data(
        cams, gt_images, gt_depths, topo, ref_edge_len, ref_area, faces=mesh_faces, device=dev
    )

    iters = num_iterations or seq.refinement_iterations
    unbind = enable_unbind and not seq.disable_mesh_update
    cfg = refine.RefineConfig(
        num_iterations=iters,
        edge_iso_factor=1000.0,
        edge_iso_from=0 if is_first_frame else 999_999,
        area_iso_factor=5000.0 if is_first_frame else 1000.0,
        use_sh_reg=seq.sh_reg and pre_sh is not None,
        loose_bind_from=(iters // 2) if unbind else 999_999,
        unbind_threshold=seq.unbind_threshold,
        max_depth=seq.max_depth,
    )

    logger = None
    if metrics_path is not None:
        logger = MetricLogger(metrics_path, run_meta={"frame": frame, "iters": iters})
        log_fn = _tee(logger.as_log_fn(), log_fn)

    detect_fn = None
    if unbind:
        dcfg = detect_cfg or topo_detect.TopoDetectConfig(max_depth=seq.max_depth)

        def detect_fn(p, c):
            fw = topo_detect.detect_topo_err(p, c, data.cameras, data.gt_depths, topo, raster_cfg, dcfg)
            if log_fn is not None:
                log_fn({"step": -1, **topo_detect.last_telemetry.as_dict()})
            return fw

    try:
        params, config, history = refine.refine_frame(
            params,
            config,
            data,
            cfg,
            raster_cfg,
            spatial_lr_scale=seq.spatial_lr_scale,
            detect_topo_fn=detect_fn,
            pre_sh_dc=None if pre_sh is None else torch.as_tensor(pre_sh, dtype=torch.float32, device=dev),
            log_every=log_every,
            log_fn=log_fn,
            config_dump_path=config_dump_path,
        )
    finally:
        if logger is not None:
            logger.close()
    return params, config, data, topo, history


def _tee(*fns):
    """One log_fn that calls each of `fns` that is not None."""
    fns = [f for f in fns if f is not None]

    def fn(entry):
        for f in fns:
            f(entry)

    return fn


def _clock(seconds: dict, name: str, dev: torch.device, fn):
    """fn(), with its wall seconds (the device synchronised on both ends)
    added to seconds[name]."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
    return out


def update_frame_topology(
    seq: SequenceConfig,
    frame: int,
    params: sugar.SuGaRParams,
    config: sugar.SuGaRConfig,
    data: refine.FrameData,
    topo,
    cams,
    gt_images,
    gt_depths,
    raster_cfg: RasterConfig,
    detect_cfg: topo_detect.TopoDetectConfig | None = None,
    log_fn=None,
    log_every: int = 50,
):
    """The topology event of a refined frame (run_sequence's mesh-update
    block, train_seq.py:150-213), with no file writes. Runs only if the model
    loose-bound. Returns (params, config, data, topo, event): the updated
    model and frame tables, and update_mesh_with_fusion's result
    (`cc_update_num`, and when it is > 0 `updated_mesh`, `track_face_mask`,
    `new_ref_area`, `aabb_pad`, `max_dist_in_connection`) with the re-refine's
    `history` and the stages' `seconds` (wall clock, device synchronised)."""
    _check_supported(seq)
    if not config.loose_bind or seq.disable_mesh_update:
        return params, config, data, topo, {"cc_update_num": 0, "seconds": {}}
    dev = params.points.device
    seconds = {}

    def clock(name, fn):
        return _clock(seconds, name, dev, fn)

    fusion = clock("fusion", lambda: mesh_update.extract_mesh_fusion(
        params, config, data.cameras, raster_cfg,
        voxel_size=seq.fusion_voxel_size,
        sdf_trunc=seq.fusion_sdf_trunc,
        depth_trunc=seq.fusion_depth_trunc,
        max_dim=seq.fusion_max_dim,
        simplify_face_num=seq.fusion_simplify_face_num,
        use_orbit_cameras=seq.fusion_use_orbit,
        solid_opacity=seq.fusion_solid_opacity,
    ))
    dcfg = detect_cfg or topo_detect.TopoDetectConfig(max_depth=seq.max_depth)
    face_w = clock("detect", lambda: topo_detect.detect_topo_err(
        params, config, data.cameras, data.gt_depths, topo, raster_cfg, dcfg))
    out = clock("surgery", lambda: mesh_update.update_mesh_with_fusion(
        params, config, fusion, face_w,
        force_watertight=seq.force_watertight,
        boundary_pad=seq.boundary_pad,
        cc_face_threshold=seq.update_cc_face_threshold,
    ))
    out["fusion_mesh"] = fusion
    if out.get("cc_update_num", 0) > 0:
        um = out["updated_mesh"]
        # Re-refine on the updated mesh, half iterations, no unbind.
        vc = _face_colors_to_vertex(um)
        if seq.recolor_new_faces:
            gt_i = np.asarray(torch.as_tensor(gt_images).cpu())
            gt_d = np.asarray(torch.as_tensor(gt_depths).cpu())
            vc = clock("recolor", lambda: _recolor_new_vertices(
                um, out["track_face_mask"], cams, gt_i, gt_d, vc,
                seq.recolor_depth_agreement, seq.max_depth,
            ))
        params, config, data, topo, out["history"] = clock("re_refine", lambda: refine_one_frame(
            seq, frame, um.verts.astype(np.float32), um.faces.astype(np.int32),
            vc, cams, gt_images, gt_depths, raster_cfg,
            is_first_frame=False,
            pre_sh=None,
            ref_area_override=out["new_ref_area"],
            num_iterations=seq.refinement_iterations // 2,
            enable_unbind=False,
            log_fn=log_fn,
            log_every=log_every,
            device=dev,
        ))
    out["seconds"] = seconds
    return params, config, data, topo, out


def run_sequence(
    seq: SequenceConfig,
    raster_cfg: RasterConfig | None = None,
    detect_cfg: topo_detect.TopoDetectConfig | None = None,
    warp_cfg: warp_mesh.WarpConfig | None = None,
    device="cuda",
    log_fn=None,
    log_every: int = 50,
):
    """The full per-frame loop (train_seq.py:101-249), writing the file
    contract of the module docstring under `seq.work_root`.

    `log_fn` receives every frame's refine log entries (as metrics.jsonl
    does) and the re-refine's. Returns (params, config, frames): the last
    frame's exported model, and per frame its telemetry {"frame",
    "cc_update_num" (the topology event's, None without one), "decode_ms"
    (the frame's JPEG decodes, io/dataset.last_load), "warp"
    (tools/warp_mesh.last_warp or None) and "seconds" per stage (wall,
    device synchronised): load, refine, event, export_npz, export_ply,
    export_obj, warp}. No frame's model is kept: each frame's files hold
    it."""
    _check_supported(seq)
    dev = resolve_device(device)
    raster_cfg = raster_cfg or RasterConfig()
    warp_cfg = warp_cfg or warp_mesh.WarpConfig()
    cmr = ds.load_rgb_cameras(os.path.join(seq.data_root, "rgb_cameras.npz"))
    cams = ds.cameras_from_npz(cmr, seq.downscale, dev)
    n_cams = len(cams)
    iters = seq.refinement_iterations

    pre_sh = None
    prev_sh_full = None  # (sh_dc, sh_rest): the checkpoint colour prior (refine.py:325-383)
    frames = []
    for f_idx in range(seq.frame_0, seq.frame_end, seq.interval):
        seconds = {}

        def clock(name, fn):
            return _clock(seconds, name, dev, fn)

        fdir = os.path.join(seq.work_root, f"{f_idx:04d}")
        os.makedirs(fdir, exist_ok=True)
        is_first = f_idx == seq.frame_0
        if is_first:
            mesh_path = os.path.join(seq.data_root, seq.init_mesh_name)
        else:
            mesh_path = os.path.join(fdir, "coarse_mesh", "warp_smooth.obj")
        verts, faces, colors = clock("load", lambda: read_obj(mesh_path))
        gt_images, gt_depths = clock("load", lambda: ds.load_frame_images(
            seq.data_root, f_idx, n_cams, seq.from_humanrf, seq.max_depth, device=dev))
        decode_ms = ds.last_load["decode_ms"]

        params, config, data, topo, _ = clock("refine", lambda: refine_one_frame(
            seq, f_idx, verts, faces, colors, cams, gt_images, gt_depths, raster_cfg, is_first,
            pre_sh=pre_sh, detect_cfg=detect_cfg, init_sh=prev_sh_full, log_fn=log_fn, log_every=log_every,
            device=dev, config_dump_path=os.path.join(fdir, "config.json"),
            metrics_path=os.path.join(fdir, "metrics.jsonl")))

        # --- mesh update if unbound (train_seq.py:150-213) ---
        event = None
        if config.loose_bind and not seq.disable_mesh_update:
            params, config, data, topo, event = clock("event", lambda: update_frame_topology(
                seq, f_idx, params, config, data, topo, cams, gt_images, gt_depths, raster_cfg,
                detect_cfg=detect_cfg, log_fn=log_fn, log_every=log_every))
            if event.get("cc_update_num", 0) > 0:
                um = event["updated_mesh"]
                write_obj(os.path.join(fdir, "updated_mesh.obj"), um.verts, um.faces)
                np.savez_compressed(os.path.join(fdir, "face_corr.npz"),
                                    track_face_mask=event["track_face_mask"], ref_area=event["new_ref_area"])

        # --- exports (refine.py:845-864, refined_mesh.py:1223-1228) ---
        clock("export_npz", lambda: ckpt_io.save_sugar(os.path.join(fdir, f"{iters}.npz"), params, config))
        clock("export_ply", lambda: ckpt_io.export_refined_ply(
            os.path.join(fdir, f"{f_idx:04d}.ply"), params, config))
        color_mesh = mesh_update.get_color_mesh(params, config)
        vc = _face_colors_to_vertex(color_mesh)
        clock("export_obj", lambda: write_obj(
            os.path.join(fdir, "color_mesh.obj"), color_mesh.verts, color_mesh.faces, vc))

        sh_dc = params.sh_dc.detach().cpu().numpy()
        pre_sh = sh_dc[:, 0, :]
        # The full-SH checkpoint prior for the next frame. After a mesh update
        # the params live on the updated topology, the mesh the warp carries
        # forward, so the mapping through face_corr is implicit.
        prev_sh_full = (sh_dc, params.sh_rest.detach().cpu().numpy())

        # --- warp to the next frame (train_seq.py:242-245) ---
        warp = None
        next_f = f_idx + seq.interval
        if next_f < seq.frame_end:
            def warp_to_next():
                depths_next = ds.load_frame_depths(seq.data_root, next_f, n_cams, seq.from_humanrf, seq.max_depth)
                flows_f, flows_b = ds.load_frame_flows(
                    seq.data_root, f_idx, n_cams, seq.interval, shape=tuple(cmr["shape"][0]))
                warped, _, _ = warp_mesh.warp_mesh_using_flow(
                    color_mesh.verts, color_mesh.faces, cmr, flows_f, flows_b,
                    list(gt_depths.cpu().numpy()), list(depths_next), warp_cfg)
                out_dir = os.path.join(seq.work_root, f"{next_f:04d}", "coarse_mesh")
                os.makedirs(out_dir, exist_ok=True)
                write_obj(os.path.join(out_dir, "warp_smooth.obj"), warped, color_mesh.faces, vc)

            clock("warp", warp_to_next)
            warp = dict(warp_mesh.last_warp)
        frames.append({"frame": f_idx, "cc_update_num": None if event is None else event.get("cc_update_num", 0),
                       "decode_ms": decode_ms, "warp": warp, "seconds": seconds})
    return params, config, frames


def _face_colors_to_vertex(mesh) -> np.ndarray:
    """Average face colors onto vertices (for OBJ vertex-color export)."""
    vc = np.zeros((len(mesh.verts), 3))
    cnt = np.zeros(len(mesh.verts))
    fc = mesh.face_colors if mesh.face_colors is not None else np.full((len(mesh.faces), 3), 0.5)
    for k in range(3):
        np.add.at(vc, mesh.faces[:, k], fc[:, :3])
        np.add.at(cnt, mesh.faces[:, k], 1)
    return vc / np.maximum(cnt, 1)[:, None]
