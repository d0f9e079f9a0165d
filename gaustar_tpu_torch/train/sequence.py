"""Per-frame sequence driver, partial (counterpart of
gaustar_tpu/train/sequence.py; train_seq.py:101-249).

What is here is one frame and its topology event:
  1. `refine_one_frame` binds a SuGaR model to the frame's mesh and refines
     it, with unbind detection at iters/2 unless disabled;
  2. `update_frame_topology` is the sequence driver's mesh-update block
     (train_seq.py:150-213) for a model that loose-bound: TSDF-fuse the
     rendered views, detect again, update the mesh topology, recolour the new
     vertices from the GT views and re-refine on the updated mesh for iters/2
     with unbinding off. It writes no files; the caller gets the event.

The JAX package's compile-reuse devices (face-count bucketing, background
prewarm of the detection and fusion programs, probed pair capacities) have
no use in an eager program; SequenceConfig keeps their fields, and setting
them raises. The sequence loop itself (warp, exports, checkpoints) is not
ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gaustar_tpu_torch.cameras import stack_cameras
from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.losses import edge_lengths, face_areas_normals
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.train import mesh_update, refine, topo_detect
from gaustar_tpu_torch.utils.general import resolve_device


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
    # TSDF fusion (refined_mesh.py:312 defaults assume meter-scale rigs).
    # fusion_simplify_face_num > 0 needs the native decimation (not ported).
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
):
    """One refined_training invocation. Returns (params, config, data, topo,
    history).

    `cams` is a list of Cameras on `device`; `gt_images` [C, H, W, 3] and
    `gt_depths` [C, H, W] arrays or tensors. `init_sh = (sh_dc [N,1,3],
    sh_rest [N,K-1,3])` initializes the SH coefficients from the previous
    frame's checkpoint (refine.py:325-383); ignored if the gaussian count
    changed. `log_fn` receives refine_frame's log entries every `log_every`
    iterations and the unbind decision."""
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

    detect_fn = None
    if unbind:
        dcfg = detect_cfg or topo_detect.TopoDetectConfig(max_depth=seq.max_depth)

        def detect_fn(p, c):
            fw = topo_detect.detect_topo_err(p, c, data.cameras, data.gt_depths, topo, raster_cfg, dcfg)
            if log_fn is not None:
                log_fn({"step": -1, **topo_detect.last_telemetry.as_dict()})
            return fw

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
    )
    return params, config, data, topo, history


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
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[name] = time.perf_counter() - t0
        return out

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


def _face_colors_to_vertex(mesh) -> np.ndarray:
    """Average face colors onto vertices (for OBJ vertex-color export)."""
    vc = np.zeros((len(mesh.verts), 3))
    cnt = np.zeros(len(mesh.verts))
    fc = mesh.face_colors if mesh.face_colors is not None else np.full((len(mesh.faces), 3), 0.5)
    for k in range(3):
        np.add.at(vc, mesh.faces[:, k], fc[:, :3])
        np.add.at(cnt, mesh.faces[:, k], 1)
    return vc / np.maximum(cnt, 1)[:, None]
