"""Initial-mesh reconstruction, the HumanRF run_mesh_extract_GauSTAR.py path
(counterpart of gaustar_tpu/train/init_mesh.py).

Train the hash-grid field on the multiview frame (photometric + mask losses
over random ray batches, humanrf/trainer.py:118-209's dynamic batching
simplified to fixed batches), then extract the iso-surface as
trainer.py:630-752 does: dense density grid -> surface at the iso threshold ->
drop outlier connected components -> 10x Laplacian smoothing -> quadric
decimation to the 100k-face target -> init_mesh_100k.obj.

The rays are the JAX package's: the same numpy draws of camera and pixels
from the seed. Only the samples' jitter differs (the JAX package draws it
with jax.random, which torch cannot reproduce): here it comes from a
torch.Generator seeded with the seed, or from the caller (`jitter`).

`last_train` and `last_extract` keep the last call's stage times.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from gaustar_tpu_torch import native
from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.mesh import tsdf as tsdf_mod
from gaustar_tpu_torch.mesh.surgery import Mesh, get_outlier_cc_mask
from gaustar_tpu_torch.models import neural_field as nf
from gaustar_tpu_torch.utils.general import StepClock, device_ms, l2norm

# The last train_field call: "occupancy_ms" (carving, device), "step_ms" (each
# iteration from its draws to the optimizer step, between CUDA events on a
# card), "rays" per batch. The last extract_init_mesh call: "grid_ms" (the
# density grid, device) and the host's "tets_ms", "cc_filter_ms", "smooth_ms",
# "decimate_ms".
last_train: dict = {}
last_extract: dict = {}


@dataclasses.dataclass(frozen=True)
class InitMeshConfig:
    iterations: int = 2000
    rays_per_batch: int = 8192
    lr: float = 1e-2
    mask_loss_weight: float = 0.1
    iso_level: float = 100.0  # trainer.py:703 mcubes iso
    grid_res: int = 256
    target_faces: int = 100_000  # trainer.py:661
    smooth_iters: int = 10  # trainer.py:744
    outlier_face_threshold: int = 1000
    # Occupancy guidance (HumanRF ray_sampler.cu / occupancy_grid_generation.cu):
    # carve a visual-hull grid from the masks, tighten every training ray's
    # sample slab to it, and mask the extraction density grid with it.
    use_occupancy: bool = True
    occupancy_res: int = 64
    occupancy_dilate: int = 1


def rays_for_pixels(camera: Camera, px: torch.Tensor, py: torch.Tensor):
    """World-space rays (origins, unit directions) [N, 3] through pixel
    positions (px, py) [N] on the camera's device."""
    fx = camera.width / (2.0 * camera.tanfovx)
    fy = camera.height / (2.0 * camera.tanfovy)
    x = (px - camera.cx) / fx
    y = (py - camera.cy) / fy
    d_local = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d_world = d_local @ camera.view[:3, :3]  # R^T applied to rows
    d_world = d_world / l2norm(d_world)
    return camera.camera_center.expand(d_world.shape), d_world


def train_field(
    cameras: list[Camera],
    images,  # [C, H, W, 3] in [0, 1], numpy or tensor
    masks,  # [C, H, W] in [0, 1], numpy or tensor
    cfg: InitMeshConfig = InitMeshConfig(),
    field_cfg: nf.FieldConfig | None = None,
    seed: int = 0,
    log_fn=None,
    jitter=None,
):
    """Optimize the field on a multiview frame, on the cameras' device.

    Returns (field, field_cfg, occupancy). With cfg.use_occupancy the
    visual-hull grid tightens every ray's sample slab (ray_sampler.cu) and
    must also mask the extraction grid (pass it to extract_init_mesh): space
    outside the hull is never sampled, so the field keeps its initial
    density there (trainer.py:676-700). `jitter`: None draws each batch's
    sample jitter from a torch.Generator seeded with `seed`; otherwise a
    function of the iteration returning its [R, S] uniforms in [0, 1)."""
    if field_cfg is None:
        field_cfg = nf.FieldConfig()
    dev = cameras[0].device
    field = nf.init_field(field_cfg, seed, dev)
    opt = torch.optim.Adam(field.parameters(), lr=cfg.lr, betas=(0.9, 0.99), eps=1e-15)

    occ, occ_ms = None, 0.0
    if cfg.use_occupancy:
        occ, occ_ms = device_ms(dev, lambda: nf.occupancy_from_masks(
            cameras, masks, field_cfg, res=cfg.occupancy_res, dilate=cfg.occupancy_dilate))

    masks_np = masks.cpu().numpy() if torch.is_tensor(masks) else np.asarray(masks)
    images_t = torch.as_tensor(images, dtype=torch.float32, device=dev)
    masks_t = torch.as_tensor(masks_np, dtype=torch.float32, device=dev)
    c, h, w = masks_np.shape
    fg_cache = {}
    gen = torch.Generator(device=dev).manual_seed(seed) if jitter is None else None
    clock = StepClock(dev)

    rng = np.random.default_rng(seed)
    n = cfg.rays_per_batch
    for it in range(cfg.iterations):
        clock.mark()
        ci = int(rng.integers(c))
        # Half the rays inside the mask, half uniform (foreground focus).
        px = rng.integers(0, w, n)
        py = rng.integers(0, h, n)
        if ci not in fg_cache:
            fg_cache[ci] = np.argwhere(masks_np[ci] > 0.5)
        fg = fg_cache[ci]
        if len(fg):
            pick = fg[rng.integers(0, len(fg), n // 2)]
            py[: n // 2] = pick[:, 0]
            px[: n // 2] = pick[:, 1]
        px_t = torch.as_tensor(px, device=dev)
        py_t = torch.as_tensor(py, device=dev)
        o, d = rays_for_pixels(cameras[ci], px_t.to(torch.float32) + 0.5, py_t.to(torch.float32) + 0.5)
        gt_rgb = images_t[ci, py_t, px_t]
        gt_mask = masks_t[ci, py_t, px_t]

        rgb, alpha, _ = nf.render_rays(field, o, d, field_cfg, gen if jitter is None else jitter(it),
                                       occupancy=occ)
        photo = ((rgb - gt_rgb) ** 2 * gt_mask[:, None]).mean()
        mask_l = ((alpha - gt_mask) ** 2).mean()
        loss = photo + cfg.mask_loss_weight * mask_l
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        clock.mark()
        if log_fn and (it + 1) % 200 == 0:
            log_fn({"iteration": it + 1, "loss": float(loss.detach())})
    last_train.clear()
    last_train.update(occupancy_ms=occ_ms, step_ms=clock.intervals_ms(), rays=n)
    return field, field_cfg, occ


def extract_init_mesh(field: nf.HashGridField, field_cfg: nf.FieldConfig, cfg: InitMeshConfig = InitMeshConfig(),
                      occupancy=None) -> Mesh:
    """Density grid -> iso surface -> CC filter -> smooth -> decimate
    (humanrf trainer.py:630-752). `occupancy` ([G, G, G] from
    occupancy_from_masks) masks the density grid before extraction, like the
    reference's occupancy-masked grid (trainer.py:676-700). The grid is
    computed on the field's device; the rest runs on the host."""
    dev = field.tables.device
    grid, grid_ms = device_ms(dev, lambda: nf.density_grid(field, field_cfg, res=cfg.grid_res))
    grid = grid.cpu().numpy()
    t0 = time.perf_counter()
    if occupancy is not None:
        occ = occupancy.cpu().numpy() if torch.is_tensor(occupancy) else np.asarray(occupancy)
        g = occ.shape[0]
        # nearest-upsample the occupancy to the extraction grid
        scale = cfg.grid_res / g
        ix = np.minimum((np.arange(cfg.grid_res) / scale).astype(np.int64), g - 1)
        grid = grid * occ[np.ix_(ix, ix, ix)].astype(grid.dtype)
    # Signed field: positive outside (density below iso), negative inside,
    # packaged as a pseudo-TSDF volume for the marching-tets extractor.
    lo = np.asarray(field_cfg.aabb_min)
    hi = np.asarray(field_cfg.aabb_max)
    voxel = float((hi - lo).max() / (cfg.grid_res - 1))
    sdf = np.clip((cfg.iso_level - grid) / max(cfg.iso_level, 1e-6), -1.0, 1.0)
    vol = tsdf_mod.make_volume(lo, grid.shape, voxel, 1.0, device="cpu")
    vol = dataclasses.replace(vol, tsdf=torch.as_tensor(sdf.astype(np.float32)),
                              weight=torch.ones(grid.shape, dtype=torch.float32))
    verts, faces, _ = tsdf_mod.extract_mesh(vol, with_color=False)
    last_extract.clear()
    last_extract.update(grid_ms=grid_ms, tets_ms=1e3 * (time.perf_counter() - t0))
    if len(faces) == 0:
        return Mesh(verts.astype(np.float64), faces.astype(np.int64))

    t0 = time.perf_counter()
    keep = get_outlier_cc_mask(faces, cfg.outlier_face_threshold)
    mesh = Mesh(verts.astype(np.float64), faces.astype(np.int64))
    mesh.update_faces(keep)
    mesh.remove_unreferenced_vertices()
    last_extract["cc_filter_ms"] = 1e3 * (time.perf_counter() - t0)

    t0 = time.perf_counter()
    if cfg.smooth_iters:
        mesh.verts = native.laplacian_smooth(mesh.verts, mesh.faces, iterations=cfg.smooth_iters)
    last_extract["smooth_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    if len(mesh.faces) > cfg.target_faces:
        v, f = native.decimate(mesh.verts, mesh.faces, cfg.target_faces)
        mesh = Mesh(v, f.astype(np.int64))
    last_extract["decimate_ms"] = 1e3 * (time.perf_counter() - t0)
    return mesh
