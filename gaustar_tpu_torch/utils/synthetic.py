"""Synthetic scenes for tests, dry runs and the chip smoke run (counterpart
of gaustar_tpu/utils/synthetic.py). Everything is made from a seed."""

from __future__ import annotations

import os

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, stack_cameras
from gaustar_tpu_torch.eval.lpips_convert import LIN_CHANNELS
from gaustar_tpu_torch.eval.metrics import VGG_CFG
from gaustar_tpu_torch.mesh.primitives import icosphere, uv_sphere
from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import binning
from gaustar_tpu_torch.ops.losses import edge_lengths, face_areas_normals
from gaustar_tpu_torch.ops.projection import TILE, preprocess
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.tools import geometry as geo
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


def rig_cameras(n=160, rows=5, dist=4.0, w=48, h=48, focal=60.0, center_z=4.0, elev_deg=(-40.0, 40.0),
                device="cuda"):
    """Multi-elevation capture rig: `rows` rings of cameras on a sphere of
    radius `dist`, elevations spanning `elev_deg`, all looking at the scene
    centre (the geometry of the ActorsHQ rig, cameras at many heights)."""
    cams = []
    elevs = np.linspace(elev_deg[0], elev_deg[1], rows)
    per_row = [n // rows + (1 if i < n % rows else 0) for i in range(rows)]
    target = np.array([0.0, 0.0, center_z])
    for ri, (el, nr) in enumerate(zip(elevs, per_row)):
        el = np.deg2rad(el)
        for i in range(nr):
            a = 2 * np.pi * (i + 0.5 * (ri % 2)) / max(nr, 1)
            pos = np.array([dist * np.cos(el) * np.sin(a), dist * np.sin(el), center_z - dist * np.cos(el) * np.cos(a)])
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


def reference_scene(device="cuda", w=None, h=None, n_lat=None, n_lon=None, n_cams=4):
    """The full-width refine workload of bench.py:build_scene, built by the
    port: (params, config, FrameData, RasterConfig). GT content does not
    change the work: a gray disc where the sphere projects on a green
    screen, depth 4 inside and 10.5 outside. The keywords shrink it for
    tests (`w`, `h`, the sphere's `n_lat` x `n_lon`) or widen the ring of
    cameras (`n_cams`); the focal length stays REF_FOCAL, as in build_scene.
    The sizes left out are the module's REF_* at call time."""
    dev = resolve_device(device)
    w, h = w or REF_W, h or REF_H
    n_lat, n_lon = n_lat or REF_LAT, n_lon or REF_LON
    verts, faces = uv_sphere(n_lat, n_lon, radius=0.6, center=(0.0, 0.0, 4.0))
    rng = np.random.default_rng(0)
    colors = rng.uniform(0.2, 0.9, size=(len(verts), 3)).astype(np.float32)
    params, config = sugar.init_sugar(verts, faces, vertex_colors=colors, device=dev)
    cams = ring_cameras(n_cams, w=w, h=h, focal=REF_FOCAL, device=dev)

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    r_px = REF_FOCAL * 0.6 / 3.4
    disc = ((xx - w / 2) ** 2 + (yy - h / 2) ** 2) < r_px**2
    gt = np.where(disc[..., None], 0.5, np.array([0.0, 1.0, 0.0], np.float32))
    gt_img = np.broadcast_to(gt, (n_cams, h, w, 3)).astype(np.float32)
    gt_depth = np.broadcast_to(np.where(disc, 4.0, 10.5).astype(np.float32), (n_cams, h, w))
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


# The sequence's workload: a two-frame on-disk dataset in the reference's
# layout (io/dataset.py), the sphere translated by SEQ_DX along x between the
# frames, seen by 8 ring cameras. "full" is reference_scene's sphere at full
# width; "small" is tests/test_sequence.py's 96-pixel dataset.
SEQ_DX = 0.03
SEQ_CAMS = 8
SEQ_OPACITY = 0.98
# The warp's settings (tools/warp_mesh.WarpConfig) for these 8 ring cameras:
# 45 degrees apart, they see a vertex inside the 60-degree view cone
# (cmr_view_max_cos -0.5) from at most 3 cameras, so min_observe 2 (the
# reference's 4 assumes its ~160 cameras); the depth-edge scale 100 instead
# of 10,000, under which the sphere's own slope over the 7-pixel window
# reads as an edge everywhere outside a narrow facing cone.
SEQ_WARP = {"min_observe": 2, "edge_scalar": 100.0}
SEQ_CENTER = (0.0, 0.0, 4.0)
SEQ_SIZES = {
    # trainee mesh of a given radius, that radius, image width, height, focal length
    "full": (lambda r: uv_sphere(REF_LAT, REF_LON, radius=r, center=SEQ_CENTER), 0.6, REF_W, REF_H, REF_FOCAL),
    "small": (lambda r: icosphere(2, radius=r, center=SEQ_CENTER), 0.5, 96, 96, 120.0),
}


def sphere_depth(view, focal, shape, center, radius, background=999.0) -> np.ndarray:
    """z-depth [H, W] float32 of a sphere seen by a camera (world-to-camera
    `view`, focal length `focal`, principal point at the image centre) along
    each pixel's ray as tools/geometry lifts pixels, `background` where the
    ray misses it."""
    h, w = shape
    pix = np.stack(np.mgrid[0:h, 0:w], -1).astype(np.float64)
    rays = geo.pixel_to_local_rays(pix, np.diag([focal, focal, 1.0]), shape)
    o = view[:3, :3] @ np.asarray(center, np.float64) + view[:3, 3]
    b = rays @ o
    rr = (rays * rays).sum(-1)
    disc = b * b - rr * (o @ o - radius * radius)
    z = (b - np.sqrt(np.maximum(disc, 0.0))) / rr
    return np.where(disc > 0, z, background).astype(np.float32)


def sequence_geometry(root: str, size: str = "full", seed: int = 0) -> dict:
    """Write the host-made part of the two-frame dataset to `root` in the
    reference layout (gaustar_tpu/io/dataset.py:3-9): rgb_cameras.npz; per
    frame and camera the sphere's analytic depth (sphere_depth, 999 off the
    sphere), where the reference's datasets carry a mesh-rendered depth (the
    full uv_sphere's facets lie within 0.05 mm of the sphere;
    tests/test_sequence.py stores the blended 3DGS depth instead); analytic
    flows 0 -> 1 at half resolution, stored (x, y) like RAFT's;
    init_mesh_100k.obj with random vertex colours. Returns {"views",
    "verts", "faces", "colors", "dx"}."""
    from gaustar_tpu_torch.io.meshio import write_obj

    make_mesh, radius, w, h, focal = SEQ_SIZES[size]
    views = [c.view.numpy().astype(np.float64) for c in ring_cameras(SEQ_CAMS, w=w, h=h, focal=focal, device="cpu")]
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "rgb_cameras.npz"), intrinsics=np.stack([np.diag([focal, focal, 1.0])] * SEQ_CAMS),
             extrinsics=np.stack(views), shape=np.stack([[h, w]] * SEQ_CAMS))
    rng = np.random.default_rng(seed)
    verts0, faces = make_mesh(radius)
    colors = rng.uniform(0.2, 0.9, size=(len(verts0), 3)).astype(np.float32)
    for fi, shift in enumerate([0.0, SEQ_DX]):
        fdir = os.path.join(root, f"{fi:04d}")
        for sub in ["images", "masks_humanrf", "depth_humanrf", "flow_bi"]:
            os.makedirs(os.path.join(fdir, sub), exist_ok=True)
        for ci, view in enumerate(views):
            depth = sphere_depth(view, focal, (h, w), np.add(SEQ_CENTER, (shift, 0.0, 0.0)), radius)
            np.savez(os.path.join(fdir, "depth_humanrf", f"img_{ci:04d}_depth.npz"), depth=depth)

    # Analytic flow 0 -> 1 at half resolution, stored (x, y): the pixel shift
    # of a world dx at depth ~4, d(col) = f R[0, :] . dx / z.
    f0 = os.path.join(root, "0000", "flow_bi")
    for ci, view in enumerate(views):
        dlocal = view[:3, :3] @ np.array([SEQ_DX, 0, 0])
        half = np.zeros((h // 2, w // 2, 2), np.float32)
        half[..., 0] = focal * dlocal[0] / 4.0 / 2.0
        half[..., 1] = focal * dlocal[1] / 4.0 / 2.0
        np.savez(os.path.join(f0, f"{ci:04d}_f.npz"), flow=half)
        np.savez(os.path.join(f0, f"{ci:04d}_b.npz"), flow=-half)
    write_obj(os.path.join(root, "init_mesh_100k.obj"), verts0, faces, colors)
    return {"views": views, "verts": verts0, "faces": faces, "colors": colors, "dx": SEQ_DX}


@torch.no_grad()
def sequence_dataset(root: str, size: str = "full", device="cuda", seed: int = 0) -> dict:
    """Write the two-frame dataset to `root`, as tests/test_sequence.py
    builds it but for its depth: sequence_geometry's files, and per frame
    and camera the port's render of the coloured sphere (opacity
    SEQ_OPACITY, SH degree 2) over black as JPEG (quality 95) and its mask
    alpha > 0.5 as PNG. Returns sequence_geometry's dict and "cams"."""
    from gaustar_tpu_torch.io import image_codec

    dev = resolve_device(device)
    info = sequence_geometry(root, size, seed)
    _, _, w, h, focal = SEQ_SIZES[size]
    cams = ring_cameras(SEQ_CAMS, w=w, h=h, focal=focal, device=dev)
    rcfg = RasterConfig()
    for fi, shift in enumerate([0.0, SEQ_DX]):
        params, config = sugar.init_sugar(info["verts"] + np.array([shift, 0, 0], np.float32), info["faces"],
                                          vertex_colors=info["colors"], device=dev)
        params.densities.fill_(float(inverse_sigmoid(torch.tensor(SEQ_OPACITY, dtype=torch.float32))))
        fdir = os.path.join(root, f"{fi:04d}")
        for ci, cam in enumerate(cams):
            img, aux = sugar.render(params, config, cam, bg=(0, 0, 0), raster_config=rcfg)
            image_codec.write_jpeg(os.path.join(fdir, "images", f"img_{ci:04d}.jpg"),
                                   (torch.clamp(img, 0, 1) * 255).to(torch.uint8), quality=95)
            mask = ((1.0 - aux.final_T) > 0.5).to(torch.uint8) * 255
            image_codec.write_png(os.path.join(fdir, "masks_humanrf", f"img_{ci:04d}_alpha.png"), mask)
    return {**info, "cams": cams}


@torch.no_grad()
def lpips_checkpoints(root: str, seed: int = 0) -> tuple[str, str]:
    """Seeded synthetic stand-ins for the published VGG16 and LPIPS(vgg)
    checkpoints, in their layouts (a torchvision state dict with its
    classifier head, the lpips package's `lin{i}.model.1.weight`), written
    to `root`: (vgg16.pth, lpips_vgg.pth). The draws are those of the JAX
    package's tests/test_lpips.py. Scores with them are not LPIPS scores."""
    g = torch.Generator().manual_seed(seed)
    state, in_ch, idx = {}, 3, 0
    for v in VGG_CFG:
        if v == "M":
            idx += 1
            continue
        state[f"features.{idx}.weight"] = torch.randn(v, in_ch, 3, 3, generator=g) * 0.05
        state[f"features.{idx}.bias"] = torch.zeros(v)
        in_ch, idx = v, idx + 2
    state["classifier.0.weight"] = torch.zeros(1, 1)
    lins = {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) + 0.01 for i, c in enumerate(LIN_CHANNELS)}
    paths = (os.path.join(root, "vgg16.pth"), os.path.join(root, "lpips_vgg.pth"))
    torch.save(state, paths[0])
    torch.save(lins, paths[1])
    return paths


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
