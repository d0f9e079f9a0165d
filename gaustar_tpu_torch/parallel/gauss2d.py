"""2D ("cam", "gauss") training: camera data parallelism composed with
gaussian-axis model parallelism (counterpart of
gaustar_tpu/parallel/gauss2d.py).

Per rank at mesh coordinate (c, g), D_g = the gauss axis's size:

  1. parameters: `points` (the mesh vertices) replicated; every per-gaussian
     leaf and `config.faces` sharded over "gauss" by whole faces
     (shard_sugar). The SuGaR primitives, SH colour and preprocess run on the
     local shard only.
  2. each rank expands its (gaussian, tile) pairs; the pair keys (tile,
     depth, global gaussian id) are gathered over "gauss" (their counts
     differ per rank: collectives.gather_varlen), and so are the
     per-GAUSSIAN blend fields (differentiable, collectives.all_gather).
  3. two stable sorts, by depth and then by tile, of the keys gathered in
     gaussian-id order give ops/binning.bin_gaussians' pair order exactly:
     by tile, then depth, then global id, culled gaussians out. So the strip
     blend is the same arithmetic as the single-device blend.
  4. rank (c, g) blends strip g of the tiles, [g tpd, (g + 1) tpd) with
     tpd = ceil(T / D_g), through the CUDA kernels with tile_base = g tpd;
     the last strip is padded with empty tiles.
  5. the strips are gathered over "gauss" into the full image (padding
     dropped), and each rank computes the whole refine loss stack
     (refine.losses_after_render) on it, divided by D_g.
  6. gradients: `points` summed over "gauss" (its render path is per-shard
     partial, and the mesh losses were divided by D_g), then every leaf and
     the loss averaged over "cam"; Adam runs on each rank's shard, `points`
     replicated.

Why the sums are exact: each rank's loss is L / D_g, so the sum over a gauss
row is L. The per-gaussian regularizers (sh_reg, opacity, unbind) see only
the local shard, so each is a shard mean; with equal shards the D_g shard
means, each / D_g, sum to the global mean. The gathers' backward sums the
ranks' cotangents, so every gaussian gets the full image's gradient.

Buffers are sized exactly, as everywhere in the port: no pair capacities.
"""

from __future__ import annotations

import dataclasses

import torch

from gaustar_tpu_torch.cameras import Camera, index_camera
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops import binning, segment
from gaustar_tpu_torch.ops.blend_cuda import blend_raw, state_row
from gaustar_tpu_torch.ops.projection import TILE, Gaussians2D, preprocess
from gaustar_tpu_torch.ops.rasterizer import assemble_image_cm
from gaustar_tpu_torch.parallel import collectives, launch
from gaustar_tpu_torch.parallel.sharding import max_over_ranks, mean_over_cams, shard_cameras
from gaustar_tpu_torch.train import refine
from gaustar_tpu_torch.train.refine import FrameData, RefineConfig, named_grads


def assert_shardable(config: sugar.SuGaRConfig, d_gauss: int):
    f = config.faces.shape[0]
    if f % d_gauss != 0:
        raise ValueError(
            f"gauss2d: face count {f} must divide the gauss-axis size {d_gauss} (pad or decimate the mesh; "
            "padded gaussians would bias the regularizers' means, so no padding is done implicitly)")


def shard_bounds(n: int, d_gauss: int, rank: int) -> slice:
    """Rows [rank n / d, (rank + 1) n / d) of an axis of n rows."""
    return slice(rank * n // d_gauss, (rank + 1) * n // d_gauss)


def local_config(config: sugar.SuGaRConfig, d_gauss: int, rank: int) -> sugar.SuGaRConfig:
    """The config over this rank's faces (its gather tables rebuilt)."""
    assert_shardable(config, d_gauss)
    faces = config.faces[shard_bounds(config.faces.shape[0], d_gauss, rank)]
    n_verts = int(config.face_gather[1].shape[0]) - 1 if config.face_gather is not None else None
    tables = segment.gather_tables(faces.cpu().numpy(), n_verts, faces.device) if n_verts is not None else None
    return dataclasses.replace(config, faces=faces, face_gather=tables)


def shard_sugar(params: sugar.SuGaRParams, config: sugar.SuGaRConfig, d_gauss: int, rank: int):
    """(params, config) of rank `rank` of the gauss axis: the faces and every
    per-gaussian leaf cut into d_gauss blocks of whole faces, `points`
    replicated. The leaves are fresh copies requiring grad."""
    config_l = local_config(config, d_gauss, rank)
    n = params.scales.shape[0]
    rows = shard_bounds(n, d_gauss, rank)
    return sugar.fresh_params(params, **{k: v[rows] for k, v in params.named() if k != "points"}), config_l


def render_strip_sharded(g2d: Gaussians2D, camera: Camera, mesh: launch.Mesh, channels: int):
    """The collective render of one camera on one gauss row of the mesh.

    Returns (image [C, H, W] channels-major with NO background, final T
    [H, W], the camera's pair count): the full frame, equal on every rank of
    the row."""
    W, H = camera.width, camera.height
    gx, gy = (W + TILE - 1) // TILE, (H + TILE - 1) // TILE
    n_tiles = gx * gy
    d, g, grp = mesh.gauss, mesh.gauss_rank, mesh.gauss_group
    n_local = g2d.mean2d.shape[0]
    dev = g2d.mean2d.device

    # Local pairs in gaussian order; keys (tile, depth bits, global id).
    touched = g2d.tiles_touched.to(torch.int64)
    n_pairs = int(touched.sum())
    gi, tile = binning.expand_pairs(touched, g2d.rect_min, g2d.rect_max, gx, n_pairs)
    depth_bits = g2d.depth.detach().contiguous().view(torch.int32).to(torch.int64)[gi]
    keys = torch.stack([tile, depth_bits, gi + g * n_local], dim=1)
    keys, counts = collectives.gather_varlen(keys, grp)

    # Gathered in global-id order, so two stable sorts give (tile, depth, id).
    depth = keys[:, 1].to(torch.int32).view(torch.float32)
    keys = keys[torch.sort(depth, stable=True).indices]
    keys = keys[torch.sort(keys[:, 0], stable=True).indices]
    bounds = torch.searchsorted(keys[:, 0].contiguous(), torch.arange(n_tiles + 1, device=dev))

    tpd = -(-n_tiles // d)
    t0, t1 = min(g * tpd, n_tiles), min((g + 1) * tpd, n_tiles)
    lo, hi = bounds[[t0, t1]].tolist()
    start = torch.zeros(tpd, dtype=torch.int32, device=dev)
    count = torch.zeros(tpd, dtype=torch.int32, device=dev)
    start[: t1 - t0] = (bounds[t0:t1] - lo).to(torch.int32)
    count[: t1 - t0] = (bounds[t0 + 1:t1 + 1] - bounds[t0:t1]).to(torch.int32)

    src = torch.cat([g2d.mean2d, g2d.conic, g2d.opacity[:, None], g2d.color], dim=-1)
    src_all = collectives.all_gather(src, grp)  # [N, 6 + C]
    pair_data = src_all[keys[lo:hi, 2]].T.contiguous()
    raw = blend_raw(pair_data, start, count, gx, W, H, channels, tile_base=g * tpd)

    rows = [state_row(ch) for ch in range(channels)] + [3]
    maps = collectives.all_gather(raw[:, rows], grp)[:n_tiles]
    maps = assemble_image_cm(maps, gx, gy, W, H)
    return maps[:channels], maps[channels], sum(counts)


def _local_loss(p_local, config_local, config_full, local_data: FrameData, cam_idx: int, iteration: int,
                cfg: RefineConfig, sh_deg: int, mesh: launch.Mesh, unbind_weight, pre_sh_dc):
    """(this rank's loss = the camera's whole refine loss / D_g, loss dict,
    the camera's pair count). The pixel and mesh losses are computed alike
    on every rank of the row; the per-gaussian regularizers on the shard."""
    camera = index_camera(local_data.cameras, cam_idx)
    positions, cov = sugar.geom_primitives(p_local, config_local)
    rgb = sugar.points_rgb(p_local, positions, camera.camera_center, sh_deg)
    view = camera.view
    z = positions @ view[2, :3] + view[2, 3]
    g2d = preprocess(positions, cov, sugar.strengths(p_local), torch.cat([rgb, z[:, None]], dim=-1), camera)
    img4, final_t, num_pairs = render_strip_sharded(g2d, camera, mesh, channels=4)
    bg4 = torch.tensor((*cfg.bg_color, cfg.max_depth), dtype=torch.float32, device=positions.device)
    img4 = img4 + final_t[None] * bg4[:, None, None]
    loss, loss_dict = refine.losses_after_render(p_local, config_full, local_data, cam_idx, iteration, cfg,
                                                 img4[:3], img4[3], unbind_weight, pre_sh_dc)
    return loss / mesh.gauss, loss_dict, num_pairs


def make_gauss2d_train_step(model_config: sugar.SuGaRConfig, data: FrameData, cfg: RefineConfig, optimizer,
                            mesh: launch.Mesh):
    """make_step(sh_deg) -> step(params, opt_state, cam_idx, iteration,
    unbind_weight=None, pre_sh_dc=None) -> (loss, {"num_pairs"}).

    `model_config` and `data` are whole (every face, every camera); `params`,
    `unbind_weight` and `pre_sh_dc` are this rank's gauss shard
    (shard_sugar, shard_bounds), and `opt_state` its Adam state. `cam_idx`
    is a LOCAL index into this rank's camera block (block mesh.cam_rank).
    `optimizer(params, grads, opt_state)` updates in place
    (train/optimizer.py: adam, sgd). The loss is the mean over the camera
    ranks of each camera's whole loss; num_pairs the largest camera's."""
    config_l = local_config(model_config, mesh.gauss, mesh.gauss_rank)
    local = shard_cameras(data, mesh.cam, mesh.cam_rank)

    def make_step(sh_deg: int):
        def step(params, opt_state, cam_idx, iteration, unbind_weight=None, pre_sh_dc=None):
            loss, _, num_pairs = _local_loss(params, config_l, model_config, local, int(cam_idx), iteration, cfg,
                                             sh_deg, mesh, unbind_weight, pre_sh_dc)
            grads = named_grads(loss, params)
            loss_g, grads["points"] = collectives.all_reduce_flat(
                [loss.detach().reshape(1), grads["points"]], mesh.gauss_group)
            loss, grads = mean_over_cams(loss_g[0], grads, mesh)
            optimizer(params, grads, opt_state)
            return loss, {"num_pairs": max_over_ranks(num_pairs, loss.device)}

        return step

    return make_step
