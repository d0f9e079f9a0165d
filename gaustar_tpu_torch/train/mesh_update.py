"""TSDF mesh extraction and the topology-update driver (counterpart of
gaustar_tpu/train/mesh_update.py).

extract_mesh_fusion (refined_mesh.py:311-459): render RGB and alpha-normalized
depth from 60 orbit cameras (12 azimuths x 5 elevations) plus every rig
camera, drop background (alpha < 0.5) and depth-edge pixels, integrate into
the dense TSDF volume (voxel 8 mm, trunc 2 cm) on the device, extract the
fused surface on the host; optionally Laplacian-smooth and decimate it with
the native mesh library (native/).

update_mesh_with_fusion (refined_mesh.py:924-1062): try update_mesh_topo over
aabb_pad in {10, 15, 20, 25, 30} mm and keep the attempt with the smallest
boundary connection distance.

postprocess_border_faces (refined_mesh.py:1155-1217): the optional
--postprocess_mesh step, which peels low-density border faces.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gaustar_tpu_torch import native
from gaustar_tpu_torch.cameras import Camera, index_camera, orbit_cameras, stack_cameras
from gaustar_tpu_torch.mesh import surgery, tsdf
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import image as image_ops
from gaustar_tpu_torch.ops import segment
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.ops.sh import sh_to_rgb_dc
from gaustar_tpu_torch.train.topo_detect import detection_params
from gaustar_tpu_torch.utils.general import device_ms

#: What the most recent extract_mesh_fusion call did: views, volume, times.
last_fusion: dict | None = None
#: The most recent postprocess_border_faces call's "peeled" and "readded" faces.
last_postprocess: dict = {}

@torch.no_grad()
def render_rgbd_for_fusion(
    params: sugar.SuGaRParams,
    config: sugar.SuGaRConfig,
    camera: Camera,
    raster_cfg: RasterConfig = RasterConfig(),
    sh_deg: int | None = None,
    remove_depth_edge: bool = True,
):
    """(rgb [H, W, 3], depth [H, W]) on the device, background and depth-edge
    pixels zeroed (refined_mesh.py:350-437): depth = blend(z) / alpha, and
    alpha < 0.5 -> 0.

    One fused 4-channel pass (r, g, b, z over bg (0, 1, 0, 0)): the reference
    renders twice (RGB, then depth and alpha), both with the same per-pair
    weights, and alpha = 1 - final_T is in the pass's aux output."""
    if sh_deg is None:
        sh_deg = config.sh_levels - 1
    geom = sugar.geom_primitives(params, config)
    positions = geom[0]
    rgb_pts = sugar.points_rgb(params, positions, camera.camera_center, sh_deg)
    view = camera.view
    z = positions @ view[2, :3] + view[2, 3]
    colors4 = torch.cat([rgb_pts, z[:, None]], dim=-1)
    cfg4 = dataclasses.replace(raster_cfg, channels=4)
    img4, aux = sugar.render(
        params, config, camera, bg=(0.0, 1.0, 0.0, 0.0), raster_config=cfg4,
        point_colors=colors4, geom=geom,
    )
    rgb = torch.clamp(img4[..., :3], 0.0, 1.0)
    alpha = 1.0 - aux.final_T
    depth = img4[..., 3] / (alpha + 1e-8)
    depth = torch.where(alpha < 0.5, torch.zeros_like(depth), depth)
    if remove_depth_edge:
        edge = image_ops.depth_edge(depth, 3)
        edge_vis = torch.clamp_max(edge / torch.clamp_min(edge.max(), 1e-12) * 1000.0, 1.0)
        depth = torch.where(edge_vis > 0.5, torch.zeros_like(depth), depth)
    return rgb, depth


def _intrinsics(cam: Camera) -> torch.Tensor:
    zero = torch.zeros_like(cam.fx)
    return torch.stack([
        torch.stack([cam.fx, zero, cam.cx]),
        torch.stack([zero, cam.fy, cam.cy]),
        torch.stack([zero, zero, torch.ones_like(cam.fx)]),
    ])


def fusion_cameras(pts: np.ndarray, cameras: Camera, use_orbit_cameras: bool = True) -> Camera:
    """The fusion views, batched: 60 orbit cameras (12 azimuths x 5
    elevations, cameras.orbit_cameras) around the points' mean, then the rig
    (refined_mesh.py:311-340)."""
    cam_list = [index_camera(cameras, i) for i in range(cameras.fx.shape[0])]
    if use_orbit_cameras:
        c0 = cam_list[0]
        orbit = orbit_cameras(pts.mean(axis=0), 3.0, c0.width, c0.height, float(c0.fx), n_azim=12,
                              device=cameras.device)
        cam_list = orbit + cam_list
    return stack_cameras(cam_list)


@torch.no_grad()
def extract_mesh_fusion(
    params: sugar.SuGaRParams,
    config: sugar.SuGaRConfig,
    cameras: Camera,  # batched rig cameras
    raster_cfg: RasterConfig = RasterConfig(),
    voxel_size: float = 0.008,
    sdf_trunc: float = 0.02,
    depth_trunc: float = 6.0,
    use_orbit_cameras: bool = True,
    max_dim: int = 512,
    smooth: bool = False,
    simplify_face_num: int = 0,
    solid_opacity: float | None = None,
) -> surgery.Mesh:
    """TSDF-fuse rendered RGB-D into a mesh (refined_mesh.py:311-459).

    `solid_opacity` sets every opacity for the fusion renders (None = the
    trained ones, the reference's behaviour): short-budget runs need it, since
    under-trained opacities mix front and back surface depths. One volume
    block lives on the device at a time; each block re-renders the views and
    is copied to the host for extraction. `smooth`: 10 Laplacian iterations
    of the fused vertices; `simplify_face_num` > 0: quadric decimation to
    that many faces, after which the faces carry no colour (zeros), as in
    the JAX package."""
    global last_fusion
    if smooth or simplify_face_num:
        native.build()  # a missing compiler raises before the renders, not after
    dev = params.points.device
    params = detection_params(params, solid_opacity)
    pts = sugar.gaussian_centers(params, config).cpu().numpy()
    plan = tsdf.fit_tiled_volume(pts, voxel_size, sdf_trunc, pad=0.06, max_block=max_dim)
    cams = fusion_cameras(pts, cameras, use_orbit_cameras)
    n_views = cams.fx.shape[0]
    sh_deg = config.sh_levels - 1

    def fuse_block(b):
        vol = plan.make_block(b, dev)
        for i in range(n_views):
            cam = index_camera(cams, i)
            rgb, depth = render_rgbd_for_fusion(params, config, cam, raster_cfg, sh_deg)
            tsdf.integrate(vol, depth, rgb, _intrinsics(cam), cam.view, depth_trunc=depth_trunc)
        return vol

    host_blocks, fuse_ms = [], 0.0
    for b in range(plan.n_blocks):
        vol, ms = device_ms(dev, lambda: fuse_block(b))
        fuse_ms += ms
        host_blocks.append((vol.tsdf.cpu().numpy(), vol.weight.cpu().numpy(), vol.color.cpu().numpy()))
        del vol

    t0 = time.perf_counter()
    verts, faces, colors = tsdf.extract_mesh_tiled(plan, host_blocks)
    if smooth and len(faces):
        verts = native.laplacian_smooth(verts, faces, iterations=10).astype(np.float32)
    if simplify_face_num and len(faces) > simplify_face_num:
        verts, faces = native.decimate(verts, faces, simplify_face_num)
        verts = verts.astype(np.float32)
        colors = None
    face_colors = colors[faces].mean(axis=1) if (colors is not None and len(faces)) else np.zeros((len(faces), 3))
    mesh = surgery.Mesh(verts.astype(np.float64), faces.astype(np.int64), face_colors)
    last_fusion = {
        "views": n_views, "blocks": plan.n_blocks, "block_dims": plan.block_dims,
        "global_dims": plan.global_dims, "device_ms": fuse_ms,
        "host_ms": 1e3 * (time.perf_counter() - t0), "verts": len(verts), "faces": len(faces),
    }
    return mesh


def get_color_mesh(params: sugar.SuGaRParams, config: sugar.SuGaRConfig) -> surgery.Mesh:
    """Vertex/face mesh with per-face mean dc color (sugar_model.py:578-588)."""
    verts = params.points.detach().cpu().numpy().astype(np.float64)
    faces = config.faces.cpu().numpy().astype(np.int64)
    ng = config.n_gaussians_per_face
    dc = params.sh_dc.detach()[:, 0, :].cpu().numpy().reshape(len(faces), ng, 3).mean(axis=1)
    rgb = np.clip(sh_to_rgb_dc(dc), 0, 1)
    return surgery.Mesh(verts, faces, rgb)


def update_mesh_with_fusion(
    params: sugar.SuGaRParams,
    config: sugar.SuGaRConfig,
    fusion_mesh: surgery.Mesh,
    face_delta: np.ndarray,
    aabb_pads=(0.010, 0.015, 0.020, 0.025, 0.030),
    **kwargs,
):
    """Try update_mesh_topo over several aabb paddings, keep the attempt with the
    smallest max boundary-connection distance (refined_mesh.py:1034-1052)."""
    base = get_color_mesh(params, config)
    ng = config.n_gaussians_per_face
    with torch.no_grad():
        gs_pts = sugar.gaussian_centers(params, config).cpu().numpy().reshape(-1, ng, 3)

    best = None
    for pad in aabb_pads:
        out = surgery.update_mesh_topo(
            base, fusion_mesh, face_delta, gauss_points=gs_pts, aabb_pad=pad, **kwargs
        )
        out["fusion_volume_truncated"] = False  # the tiled volume covers the bbox
        if out.get("cc_update_num", 0) in (-1,):
            return out  # nothing flagged at all
        if out.get("cc_update_num", 0) <= 0:
            continue
        if best is None or out["max_dist_in_connection"] < best["max_dist_in_connection"]:
            best = out
            best["aabb_pad"] = pad
    if best is not None:
        return best
    return {"cc_update_num": 0, "fusion_volume_truncated": False}


def postprocess_border_faces(params: sugar.SuGaRParams, config: sugar.SuGaRConfig,
                             density_threshold: float = 0.1, iterations: int = 5, k: int = 16):
    """Remove border triangles that carry low-density gaussians (defaults
    from train_seq.py:49-56). Peels, `iterations` times, every face that owns
    a boundary edge (an edge no other kept face shares), then re-adds the
    peeled faces whose centre density (sugar.compute_density over the k
    nearest gaussians) exceeds `density_threshold`. Returns
    ((params, config) subset to the kept faces, face_mask [F] bool); the
    vertices are unchanged. Edges are counted exactly by integer keys, where
    the reference matches them with a knn_points distance under 0.01
    (refined_mesh.py:1173-1177)."""
    faces = config.faces.cpu().numpy()
    e = np.stack([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=1)
    e.sort(axis=-1)
    ekey = e[..., 0].astype(np.int64) * (int(faces.max()) + 1) + e[..., 1]

    face_mask = np.ones(len(faces), bool)
    for _ in range(iterations):
        _, inv, counts = np.unique(ekey[face_mask].reshape(-1), return_inverse=True, return_counts=True)
        inside = (counts[inv.reshape(-1)] >= 2).reshape(-1, 3).all(axis=-1)
        if inside.all():
            break
        face_mask[face_mask] = inside

    removed = ~face_mask
    if removed.any():
        dev = params.points.device
        sel = torch.as_tensor(faces[removed], device=dev)
        centers = params.points.detach()[sel].mean(dim=1)
        face_mask[removed] = (sugar.compute_density(params, config, centers, k=k) > density_threshold).cpu().numpy()
    last_postprocess.clear()
    last_postprocess.update(peeled=int(removed.sum()), readded=int(face_mask[removed].sum()))
    return subset_sugar_faces(params, config, face_mask), face_mask


def subset_sugar_faces(params: sugar.SuGaRParams, config: sugar.SuGaRConfig, face_mask):
    """Subset a SuGaR model to the faces where `face_mask` is True, slicing the
    per-face gaussian parameter groups (refined_mesh.py:1185-1216: vertices
    stay, faces and their gaussians are filtered). The sliced groups are new
    leaves; the vertex leaf is shared."""
    face_mask = np.asarray(face_mask, bool)
    ng = config.n_gaussians_per_face
    keep = torch.as_tensor(np.repeat(face_mask, ng), device=params.points.device)

    def per_face(x):
        return x.detach()[keep].clone().requires_grad_(x.requires_grad)

    new_params = dataclasses.replace(
        params, **{k: per_face(v) for k, v in params.named() if k != "points"}
    )
    faces = config.faces[torch.as_tensor(face_mask, device=config.faces.device)]
    new_config = dataclasses.replace(
        config, faces=faces,
        face_gather=segment.gather_tables(faces.cpu().numpy(), params.points.shape[0], faces.device),
    )
    return new_params, new_config
