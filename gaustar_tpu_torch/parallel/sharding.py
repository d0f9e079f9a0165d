"""Camera data parallelism (counterpart of gaustar_tpu/parallel/sharding.py).

Each rank renders and differentiates its own cameras of the rig against
replicated parameters; the loss and every gradient are averaged over the
"cam" ranks with one flat all_reduce, and the named-group Adam then runs
replicated: every rank applies the same update to the same parameters, so
they stay equal. The step reports the largest pair count over the ranks.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from gaustar_tpu_torch.cameras import index_camera
from gaustar_tpu_torch.parallel import collectives, launch
from gaustar_tpu_torch.train.refine import FrameData, compute_losses_multi, named_grads


def make_camera_mesh(device=None) -> launch.Mesh:
    """A mesh of every rank on the "cam" axis."""
    return launch.make_mesh(gauss=1, device=device)


def shard_cameras(data: FrameData, n_shards: int, shard: int) -> FrameData:
    """The FrameData of camera block `shard` of `n_shards` equal blocks (the
    JAX package's P("cam") on the camera axis); the mesh data is shared."""
    c = data.gt_images.shape[0]
    if c % n_shards != 0:
        raise ValueError(f"{c} cameras do not split into {n_shards} equal shards")
    lo, hi = shard * c // n_shards, (shard + 1) * c // n_shards
    return dataclasses.replace(
        data, cameras=index_camera(data.cameras, slice(lo, hi)), gt_images=data.gt_images[lo:hi],
        gt_depths=data.gt_depths[lo:hi], margins=data.margins[lo:hi])


def mean_over_cams(loss, grads: dict, mesh: launch.Mesh):
    """(loss, grads) averaged over the "cam" ranks with ONE flat all_reduce
    (the loss rides in the same buffer)."""
    names = list(grads)
    vals = collectives.all_reduce_flat([loss.detach().reshape(1)] + [grads[k] for k in names], mesh.cam_group)
    inv = 1.0 / mesh.cam
    return vals[0][0] * inv, {k: v * inv for k, v in zip(names, vals[1:])}


def max_over_ranks(n: int, device) -> int:
    """The largest of every rank's integer."""
    t = torch.tensor([n], dtype=torch.int64, device=device)
    if dist.is_initialized():
        (t,) = collectives.all_reduce_flat([t], dist.group.WORLD, dist.ReduceOp.MAX)
    return int(t)


def make_sharded_train_step(model_config, data: FrameData, cfg, raster_cfg, optimizer, mesh: launch.Mesh):
    """make_step(sh_deg) -> step(params, opt_state, cam_idx, iteration,
    unbind_weight=None, pre_sh_dc=None) -> (loss, {"num_pairs"}).

    `data` holds every camera; this rank renders block mesh.cam_rank of them,
    and `cam_idx` (B ints) are LOCAL indices into that block.
    `optimizer(params, grads, opt_state)` updates the parameters in place
    (train/optimizer.py: adam, sgd). The mesh has no gauss axis."""
    if mesh.gauss != 1:
        raise ValueError("make_sharded_train_step takes a camera mesh (gauss = 1); see parallel/gauss2d.py")
    local = shard_cameras(data, mesh.cam, mesh.cam_rank)

    def make_step(sh_deg: int):
        def step(params, opt_state, cam_idx, iteration, unbind_weight=None, pre_sh_dc=None):
            loss, loss_dict = compute_losses_multi(params, model_config, local, list(cam_idx), iteration, cfg,
                                                   raster_cfg, sh_deg, unbind_weight, pre_sh_dc)
            loss, grads = mean_over_cams(loss, named_grads(loss, params), mesh)
            optimizer(params, grads, opt_state)
            return loss, {"num_pairs": max_over_ranks(loss_dict["num_pairs"], loss.device)}

        return step

    return make_step
