"""Synthetic scenes for tests, dry runs and the chip smoke run (counterpart
of gaustar_tpu/utils/synthetic.py). Everything is made from a seed."""

from __future__ import annotations

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, stack_cameras
from gaustar_tpu_torch.mesh.primitives import icosphere, uv_sphere
from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import binning
from gaustar_tpu_torch.ops.losses import edge_lengths, face_areas_normals
from gaustar_tpu_torch.ops.projection import TILE, preprocess
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.train.refine import FrameData, compute_margins, with_face_edge_tables
from gaustar_tpu_torch.utils.general import inverse_sigmoid, resolve_device

# The full-width refine workload of the JAX package's bench.py (build_scene):
# a 100,000-face sphere x 6 gaussians/face = 600,000 gaussians, four ring
# cameras at 1600 x 1024 (1.6 MP), focal length 1600.
REF_W, REF_H = 1600, 1024
REF_LAT, REF_LON = 201, 250
REF_FOCAL = 1600.0


def ring_cameras(n=4, dist=4.0, w=48, h=48, focal=60.0, center_z=4.0, device="cuda"):
    cams = []
    for i in range(n):
        a = 2 * np.pi * i / n
        pos = np.array([dist * np.sin(a), 0.0, center_z - dist * np.cos(a)])
        target = np.array([0.0, 0.0, center_z])
        z = target - pos
        z /= np.linalg.norm(z)
        up = np.array([0.0, -1.0, 0.0])
        x = np.cross(up, z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z], axis=1)
        w2c = np.eye(4)
        w2c[:3, :3] = R.T
        w2c[:3, 3] = -R.T @ pos
        cams.append(Camera.from_w2c(w2c, focal, focal, w / 2, h / 2, w, h, device=device))
    return cams


def _frame_data(verts, faces, cams, gt_images, gt_depths, dev) -> FrameData:
    topo = build_topology(np.asarray(faces), len(verts))
    v = torch.as_tensor(verts, device=dev)
    edges = torch.as_tensor(topo.edges, dtype=torch.int64, device=dev)
    ref_area, _ = face_areas_normals(v, torch.as_tensor(faces, dtype=torch.int64, device=dev))
    batch = stack_cameras(cams)
    w, h = batch.width, batch.height
    margins = compute_margins(batch.cx.cpu().numpy(), batch.cy.cpu().numpy(), w, h)
    return FrameData(
        cameras=batch,
        gt_images=torch.as_tensor(gt_images, device=dev),
        gt_depths=torch.as_tensor(gt_depths, device=dev),
        margins=torch.as_tensor(margins, dtype=torch.int64, device=dev),
        ref_edge_len=edge_lengths(v, edges),
        ref_area=ref_area,
        edges=edges,
        adj_faces=torch.as_tensor(topo.adj_faces, dtype=torch.int64, device=dev),
    )


@torch.no_grad()
def synthetic_frame(n_cams=4, w=48, h=48, subdiv=1, seed=0, raster_cfg=None, radius=0.6,
                    target_opacity=0.95, device="cuda"):
    """(init_params, config, FrameData, target_params, raster_cfg): GT rendered
    from an opaque target model with random vertex colors; the trainee starts
    gray."""
    dev = resolve_device(device)
    raster_cfg = raster_cfg or RasterConfig()
    rng = np.random.default_rng(seed)
    verts, faces = icosphere(subdiv, radius=radius, center=(0, 0, 4.0))
    colors = rng.uniform(0.2, 0.9, size=(len(verts), 3)).astype(np.float32)

    target, config = sugar.init_sugar(verts, faces, vertex_colors=colors, device=dev)
    target.densities.fill_(float(inverse_sigmoid(torch.tensor(target_opacity, dtype=torch.float32))))

    cams = ring_cameras(n_cams, w=w, h=h, device=dev)
    gts, depths = [], []
    for cam in cams:
        img, _ = sugar.render(target, config, cam, bg=(0, 1, 0), raster_config=raster_cfg)
        gts.append(img)
        d, _ = sugar.render_depth(target, config, cam, max_depth=10.0, raster_config=raster_cfg,
                                  use_solid_surface=True)
        depths.append(torch.where(d > 9.0, torch.full_like(d, 10.5), d))
    data = _frame_data(verts, faces, cams, torch.stack(gts), torch.stack(depths), dev)
    init_params, _ = sugar.init_sugar(verts, faces, vertex_colors=None, device=dev)
    return init_params, config, data, target, raster_cfg


def reference_scene(device="cuda"):
    """The full-width refine workload of bench.py:build_scene, built by the
    port: (params, config, FrameData, RasterConfig). GT content does not
    change the work: a gray disc where the sphere projects on a green
    screen, depth 4 inside and 10.5 outside."""
    dev = resolve_device(device)
    verts, faces = uv_sphere(REF_LAT, REF_LON, radius=0.6, center=(0.0, 0.0, 4.0))
    rng = np.random.default_rng(0)
    colors = rng.uniform(0.2, 0.9, size=(len(verts), 3)).astype(np.float32)
    params, config = sugar.init_sugar(verts, faces, vertex_colors=colors, device=dev)
    cams = ring_cameras(4, w=REF_W, h=REF_H, focal=REF_FOCAL, device=dev)

    yy, xx = np.mgrid[0:REF_H, 0:REF_W].astype(np.float32)
    r_px = REF_FOCAL * 0.6 / 3.4
    disc = ((xx - REF_W / 2) ** 2 + (yy - REF_H / 2) ** 2) < r_px**2
    gt = np.where(disc[..., None], 0.5, np.array([0.0, 1.0, 0.0], np.float32))
    gt_img = np.broadcast_to(gt, (4, REF_H, REF_W, 3)).astype(np.float32)
    gt_depth = np.broadcast_to(np.where(disc, 4.0, 10.5).astype(np.float32), (4, REF_H, REF_W))
    with torch.no_grad():
        data = _frame_data(verts, faces, cams, np.ascontiguousarray(gt_img),
                           np.ascontiguousarray(gt_depth), dev)
    data = with_face_edge_tables(data, faces)
    return params, config, data, RasterConfig()


# The topology event's workload: reference_scene's sphere as the trainee and,
# in the GT, a blob touching it (the new-blob scenario of
# tests/test_topology_e2e.py scaled x1.2), seen by a ring of 8 cameras.
TOPO_SPHERE_CENTER = (0.0, 0.0, 4.0)
TOPO_SPHERE_RADIUS = 0.6
TOPO_BLOB_CENTER = (0.696, 0.096, 4.0)
TOPO_BLOB_RADIUS = 0.264
TOPO_CAMS = 8
TOPO_SIZES = {
    # (lat, lon) of the trainee's uv_sphere, blob icosphere subdivisions,
    # image width, height, focal length
    "full": (REF_LAT, REF_LON, 4, REF_W, REF_H, REF_FOCAL),
    "small": (17, 24, 2, 96, 96, 120.0),
}


@torch.no_grad()
def topology_scene(device="cuda", size="full", seed=0):
    """The topology-change workload: {verts, faces, colors} of the trainee
    mesh (the full size is reference_scene's uv_sphere(201, 250): 100,000
    faces, 600,000 gaussians), `cams` (a list of 8 ring cameras),
    `gt_images` [8, H, W, 3] and `gt_depths` [8, H, W] on the device.

    The GT is rendered by the port from a target made of the sphere and the
    blob at opacity 0.995, as synthetic_frame renders: RGB over green, the
    solid-surface depth with background 10.5. `size="small"` is the CPU
    tests' variant."""
    dev = resolve_device(device)
    lat, lon, blob_subdiv, w, h, focal = TOPO_SIZES[size]
    rng = np.random.default_rng(seed)
    verts, faces = uv_sphere(lat, lon, radius=TOPO_SPHERE_RADIUS, center=TOPO_SPHERE_CENTER)
    colors = rng.uniform(0.2, 0.9, size=(len(verts), 3)).astype(np.float32)
    bv, bf = icosphere(blob_subdiv, radius=TOPO_BLOB_RADIUS, center=TOPO_BLOB_CENTER)
    bc = rng.uniform(0.2, 0.9, size=(len(bv), 3)).astype(np.float32)

    target, t_config = sugar.init_sugar(
        np.concatenate([verts, bv]), np.concatenate([faces, bf + len(verts)]),
        vertex_colors=np.concatenate([colors, bc]), device=dev,
    )
    target.densities.fill_(float(inverse_sigmoid(torch.tensor(0.995, dtype=torch.float32))))
    cams = ring_cameras(TOPO_CAMS, w=w, h=h, focal=focal, device=dev)
    raster_cfg = RasterConfig()
    gts, depths = [], []
    for cam in cams:
        img, _ = sugar.render(target, t_config, cam, bg=(0, 1, 0), raster_config=raster_cfg)
        gts.append(img)
        d, _ = sugar.render_depth(target, t_config, cam, max_depth=10.0, raster_config=raster_cfg,
                                  use_solid_surface=True)
        depths.append(torch.where(d > 9.0, torch.full_like(d, 10.5), d))
    return {"verts": verts, "faces": faces, "colors": colors, "cams": cams,
            "gt_images": torch.stack(gts), "gt_depths": torch.stack(depths), "raster_cfg": raster_cfg}


@torch.no_grad()
def render_inputs(params, config, camera):
    """(means, cov3d, opacities, features [N, 4], camera) of one camera's
    fused RGB+depth render of `params`: feature 3 is the view depth."""
    pos, cov = sugar.geom_primitives(params, config)
    rgb = sugar.points_rgb(params, pos, camera.camera_center, config.sh_levels - 1)
    z = pos @ camera.view[2, :3] + camera.view[2, 3]
    return pos, cov, sugar.strengths(params), torch.cat([rgb, z[:, None]], 1), camera


@torch.no_grad()
def blend_inputs(means, cov, opac, feats, camera, channels, top_tiles=None):
    """(pair_data, tile_start, tile_count, grid_x, W, H): the blend kernels'
    inputs, as ops/rasterizer.rasterize builds them. `top_tiles` keeps only
    the busiest tiles (the others get count 0)."""
    W, H = camera.width, camera.height
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    g = preprocess(means, cov, opac, feats[:, :channels].contiguous(), camera)
    b = binning.bin_gaussians(g, gx, gy)
    pd = binning.gather_pair_data(g, b).contiguous()
    count = b.tile_count
    if top_tiles is not None:
        keep = torch.topk(count, top_tiles).indices
        count = torch.zeros_like(count).index_copy_(0, keep, count[keep])
    return pd, b.tile_start.contiguous(), count.contiguous(), gx, W, H
