"""Scenes of the reference-scale runs: the rigs and their ground truth
(counterparts of the scene functions in examples/refscale_frame.py,
refscale_seq.py, refscale_real.py and refscale_warp160.py).

Analytic geometry is computed in numpy on the host, term for term as the
JAX scripts compute it, so masks and depths equal theirs; it reaches torch
on the caller's device. Renders of a GT model go through the port's
rasterizer (on a card, the CUDA blend). Every random draw comes from a
generator the caller passes, seeded as the scripts seed theirs:
`default_rng(0)` for the camera draws, `default_rng(7)` for the capture of
real.py.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera, stack_cameras
from gaustar_tpu_torch.mesh.primitives import icosphere, uv_sphere
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.tools import mesh_render
from gaustar_tpu_torch.utils.synthetic import REF_FOCAL, REF_H, REF_LAT, REF_LON, REF_W, ring_cameras

# The reference scene's sphere (utils/synthetic.reference_scene) and the GT's
# only inconsistency between views: an 8 cm dent inside a 13 cm ball on the
# sphere at CENTER + RADIUS x (examples/refscale_frame.py:61-110).
CENTER = np.array([0.0, 0.0, 4.0])
RADIUS = 0.6
DENT_DEPTH = 0.08
DENT_BALL = 0.13
DENT_CENTER = CENTER + RADIUS * np.array([1.0, 0.0, 0.0])
FRAME_MISS = 10.5  # GT depth off the sphere in the frame's rig (refscale_frame.py:88)
SEQ_MISS = 999.0  # and in the on-disk datasets (refscale_seq.py:64)


def ray_sphere(view, fx: float, fy: float, w: int, h: int, center, radius: float, miss: float):
    """(t, hit, vx, vy): the z-depth [H, W] (float64) where each pixel's ray
    (vx, vy, 1), vx = (x - W / 2) / fx, meets the sphere, `miss` where it
    does not, as the scripts compute it (refscale_frame.py:80-90,
    refscale_seq.py:50-62, refscale_warp160.py:28-40)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    view = np.asarray(view, np.float64)
    c_cam = view[:3, :3] @ center + view[:3, 3]
    vx = (xx - w / 2.0) / fx
    vy = (yy - h / 2.0) / fy
    a = vx * vx + vy * vy + 1.0
    b = -2.0 * (vx * c_cam[0] + vy * c_cam[1] + c_cam[2])
    c0 = float(c_cam @ c_cam) - radius * radius
    disc = b * b - 4.0 * a * c0
    hit = disc > 0
    t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a), miss)
    return t, hit, vx, vy


def dent_mask(view, t, hit, vx, vy) -> np.ndarray:
    """Pixels whose surface point lies in the dent's ball (world space: the
    same 3D change in every view)."""
    view = np.asarray(view, np.float64)
    pw = (np.stack([vx * t, vy * t, t], axis=-1) - view[:3, 3]) @ view[:3, :3]
    return hit & (np.linalg.norm(pw - (CENTER + RADIUS * np.array([1.0, 0.0, 0.0])), axis=-1) < DENT_BALL)


def _view(cam: Camera) -> np.ndarray:
    return cam.view.cpu().numpy().astype(np.float64)


@torch.no_grad()
def reference_rig(data, n_cams: int, w: int = REF_W, h: int = REF_H, focal: float = REF_FOCAL):
    """`data` (a FrameData of utils/synthetic.reference_scene) on a ring of
    `n_cams` cameras with analytic GT (widen_rig, refscale_frame.py:61-110):
    the ray-sphere depth, 8 cm deeper in the dent; grey 0.5 on the sphere,
    0.15 in the dent, green off it; every camera with camera 0's margins.
    On data's device."""
    dev = data.gt_images.device
    cams = ring_cameras(n_cams, w=w, h=h, focal=focal, device=dev)
    imgs, depths = [], []
    for cam in cams:
        view = _view(cam)
        t, hit, vx, vy = ray_sphere(view, float(cam.fx), float(cam.fy), w, h, CENTER, RADIUS, FRAME_MISS)
        dent = dent_mask(view, t, hit, vx, vy)
        depths.append(np.where(dent, t + DENT_DEPTH, t).astype(np.float32))
        img = np.where(hit[..., None], np.float32(0.5), np.array([0.0, 1.0, 0.0], np.float32))
        imgs.append(np.where(dent[..., None], np.float32(0.15), img).astype(np.float32))
    return dataclasses.replace(
        data,
        cameras=stack_cameras(cams),
        gt_images=torch.as_tensor(np.stack(imgs), device=dev),
        gt_depths=torch.as_tensor(np.stack(depths), device=dev),
        margins=data.margins[:1].expand(n_cams, 4).contiguous(),
    )


def analytic_frame(view, focal: float, w: int, h: int, dent: bool):
    """(rgb [H, W, 3] uint8 before compositing, alpha uint8, depth float32)
    of one camera of the on-disk sequence (_analytic_frame,
    refscale_seq.py:48-76): 128 on the sphere, 38 in frame 1's dent."""
    t, hit, vx, vy = ray_sphere(view, focal, focal, w, h, CENTER, RADIUS, SEQ_MISS)
    dmask = dent_mask(view, t, hit, vx, vy) if dent else np.zeros_like(hit)
    t = np.where(dmask, t + DENT_DEPTH, t)
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[hit] = 128
    rgb[dmask] = 38
    alpha = (hit * 255).astype(np.uint8)
    return rgb, alpha, np.where(hit, t, SEQ_MISS).astype(np.float32)


def write_sequence_dataset(root: str, n_cams: int, w: int = REF_W, h: int = REF_H, focal: float = REF_FOCAL,
                           device="cuda") -> int:
    """Write the two-frame dataset of refscale_seq.py:78-107 to `root` in
    the reference's layout (io/dataset.py): rgb_cameras.npz; per frame and
    camera the JPEG (quality 95, through the port's codec on `device`), the
    alpha PNG and the analytic depth npz (uncompressed), frame 1 with the dent; zero
    bidirectional flows at half resolution for frame 0 (the dent is new
    geometry, not motion); the reference scene's 100,000-face uv_sphere as
    init mesh, grey. Depths are stored uncompressed, which the loader reads
    alike. Returns the mesh's face count."""
    from gaustar_tpu_torch.io import image_codec
    from gaustar_tpu_torch.io.meshio import write_obj

    os.makedirs(root, exist_ok=True)
    views = [_view(c) for c in ring_cameras(n_cams, w=w, h=h, focal=focal, device="cpu")]
    np.savez(os.path.join(root, "rgb_cameras.npz"), intrinsics=np.stack([np.diag([focal, focal, 1.0])] * n_cams),
             extrinsics=np.stack(views), shape=np.stack([[h, w]] * n_cams))
    for fi, dent in ((0, False), (1, True)):
        fdir = os.path.join(root, f"{fi:04d}")
        for sub in ("images", "masks_humanrf", "depth_humanrf", "flow_bi"):
            os.makedirs(os.path.join(fdir, sub), exist_ok=True)
        for ci, view in enumerate(views):
            rgb, alpha, depth = analytic_frame(view, focal, w, h, dent)
            image_codec.write_jpeg(os.path.join(fdir, "images", f"img_{ci:04d}.jpg"),
                                   torch.as_tensor(rgb, device=device), quality=95)
            image_codec.write_png(os.path.join(fdir, "masks_humanrf", f"img_{ci:04d}_alpha.png"), alpha)
            np.savez(os.path.join(fdir, "depth_humanrf", f"img_{ci:04d}_depth.npz"), depth=depth)
        if fi == 0:
            zero = np.zeros((h // 2, w // 2, 2), np.float32)
            for ci in range(n_cams):
                for d in ("f", "b"):
                    np.savez_compressed(os.path.join(fdir, "flow_bi", f"{ci:04d}_{d}.npz"), flow=zero)
    verts, faces = uv_sphere(REF_LAT, REF_LON, radius=RADIUS, center=tuple(CENTER))
    write_obj(os.path.join(root, "init_mesh_100k.obj"), verts, faces, np.full((len(verts), 3), 0.5, np.float32))
    return len(faces)


# --- real.py's capture (refscale_real.py:51-191): a 100,000-face ellipsoid
# body at ActorsHQ's footprint (f = 3500 px at 1600 px width and 3.5 m: about
# 1 mm/px) with a 12 cm blob added in frame 1. ---
BODY_R = np.array([0.25, 0.45, 0.25])  # semi-axes, about 1.1 m^2 of surface
BODY_C = np.array([0.0, 0.0, 3.5])
BLOB_R = 0.12
BLOB_C = BODY_C + np.array([0.30, 0.05, -0.05])
REAL_MAX_DEPTH = 10.0
REAL_DIST = 3.5


def real_focal(w: int) -> float:
    """The footprint's focal length at image width `w`."""
    return 3500.0 * w / 1600.0


def ellipsoid_mesh(n_faces: int):
    """A uv ellipsoid of about `n_faces` triangles (verts float32, faces)."""
    ratio = 1.4  # lat/lon density balance for the elongated axis
    n_lon = int(np.sqrt(n_faces / (2 * ratio)))
    n_lat = int(ratio * n_lon) + 1
    v, f = uv_sphere(n_lat, n_lon, radius=1.0, center=(0, 0, 0))
    v = v * BODY_R[None, :] + BODY_C[None, :]
    return v.astype(np.float32), f


def blob_mesh():
    return icosphere(4, radius=BLOB_R, center=tuple(BLOB_C))


def texture(verts, rng: np.random.Generator) -> np.ndarray:
    """Multi-octave procedural per-vertex albedo (4 x 3 phases from rng)."""
    p = (verts - BODY_C[None, :]) * 12.0
    c = np.zeros((len(verts), 3))
    for k, amp in ((1.0, 0.25), (3.1, 0.15), (9.7, 0.08), (29.0, 0.05)):
        phase = rng.uniform(0, 2 * np.pi, size=3)
        for ch in range(3):
            c[:, ch] += amp * np.sin(k * (p[:, ch % 3] + 0.7 * p[:, (ch + 1) % 3]) + phase[ch])
    base = np.array([0.55, 0.45, 0.40])
    return np.clip(base[None, :] + c, 0.05, 0.95).astype(np.float32)


def real_rig(n_cams: int, w: int = REF_W, h: int = REF_H, device="cuda") -> list[Camera]:
    """Two elevation rings (0.25 and -0.2 rad) of n_cams / 2 cameras each,
    3.5 m from the body, the second ring offset by half a step."""
    focal = real_focal(w)
    cams = []
    n_per = n_cams // 2
    for ring, elev in ((0, 0.25), (1, -0.2)):
        for i in range(n_per):
            a = 2 * np.pi * (i + 0.5 * ring) / n_per
            eye = BODY_C + REAL_DIST * np.array([np.sin(a) * np.cos(elev), np.sin(elev), -np.cos(a) * np.cos(elev)])
            fwd = BODY_C - eye
            fwd /= np.linalg.norm(fwd)
            up = np.array([0.0, -1.0, 0.0])
            right = np.cross(up, fwd)
            right /= np.linalg.norm(right)
            upv = np.cross(fwd, right)
            R = np.stack([right, upv, fwd])  # w2c rows
            w2c = np.eye(4, dtype=np.float32)
            w2c[:3, :3] = R
            w2c[:3, 3] = -R @ eye
            cams.append(Camera.from_w2c(w2c, focal, focal, w / 2, h / 2, w, h, device=device))
    return cams


def imperfect_mask(valid: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Matting-like corruption: 35% of a 1-2 px boundary band flipped."""
    band = np.zeros(valid.shape, bool)
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0), (0, 2), (2, 0)):
        band |= np.roll(valid, (dy, dx), (0, 1)) != valid
    flip = band & (rng.uniform(size=valid.shape) < 0.35)
    out = valid.copy()
    out[flip] = ~valid[flip]
    return out


def mesh_depth(verts, faces, cam: Camera) -> tuple[np.ndarray, np.ndarray]:
    """(depth, valid): the mesh's z-buffer, 999 where empty, capped at
    REAL_MAX_DEPTH + 0.5, as the scripts store GT depth."""
    d, valid, _ = mesh_render.render_mesh_depth(verts, faces, cam)
    valid = np.asarray(valid) > 0.5
    d = np.where(valid, np.asarray(d), 999.0)
    return np.minimum(d, REAL_MAX_DEPTH + 0.5).astype(np.float32), valid


@torch.no_grad()
def render_gt(params, config, cams, raster_cfg, rng: np.random.Generator):
    """(images [C, H, W, 3], depths [C, H, W], masks [C, H, W]) numpy: the GT
    model's render over green composited through an imperfect mask, plus
    sensor noise of 1.5/255; the depth its clean mesh z-buffer (the
    reference's depth_humanrf maps are mesh renders)."""
    imgs, depths, masks = [], [], []
    green = np.array([0.0, 1.0, 0.0], np.float32)
    points, faces = params.points.cpu().numpy(), config.faces.cpu().numpy()
    for cam in cams:
        img, _ = sugar.render(params, config, cam, bg=(0, 1, 0), raster_config=raster_cfg)
        d, valid = mesh_depth(points, faces, cam)
        mask = imperfect_mask(valid, rng)
        img = np.where(mask[..., None], img.cpu().numpy(), green[None, None])
        imgs.append(np.clip(img + rng.normal(0, 1.5 / 255.0, img.shape), 0, 1).astype(np.float32))
        depths.append(d)
        masks.append(mask)
    return np.stack(imgs), np.stack(depths), np.stack(masks)


def surface_distance(pts: np.ndarray):
    """(lower, upper) bound of each point's distance to the analytic
    body + blob surface (exact for a sphere, good near the ellipsoid)."""
    q = (pts - BODY_C[None]) / BODY_R[None]
    r = np.linalg.norm(q, axis=1)
    d_body = np.abs(r - 1.0) * np.min(BODY_R)
    d_body_ub = np.abs(r - 1.0) * np.max(BODY_R)
    d_blob = np.abs(np.linalg.norm(pts - BLOB_C[None], axis=1) - BLOB_R)
    return np.minimum(d_body, d_blob), np.minimum(d_body_ub, d_blob)


def camera_dict(cams: list[Camera]) -> dict:
    """The warp's camera dict {intrinsics, extrinsics, shape} of a rig."""
    return {
        "intrinsics": np.stack([np.array([[float(c.fx), 0, float(c.cx)], [0, float(c.fy), float(c.cy)], [0, 0, 1.0]])
                                for c in cams]),
        "extrinsics": np.stack([_view(c) for c in cams]),
        "shape": np.stack([(c.height, c.width) for c in cams]),
    }


# --- warp160.py's scene (refscale_warp160.py): the reference sphere seen by
# a 160-camera multi-elevation rig at f = 2000 px from 2.5 m (about 1.25
# mm/px), moved rigidly by SHIFT between the frames. ---
WARP_FOCAL = 2000.0
WARP_DIST = 2.5
WARP_SHIFT = np.array([0.02, 0.0, 0.0])


def sphere_depth(view, fx: float, fy: float, w: int, h: int, center):
    """(depth [H, W] float32, 999 off the sphere; hit; (vx, vy)) of the
    reference sphere about `center` (refscale_warp160.py:28-40)."""
    t, hit, vx, vy = ray_sphere(view, fx, fy, w, h, center, RADIUS, SEQ_MISS)
    return t.astype(np.float32), hit, (vx, vy)
