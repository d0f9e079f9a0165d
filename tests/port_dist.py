"""Ranks for the port's distributed CPU tests (tests/test_torch_parallel.py):
gloo on the CPU, one process per rank, spawned with a file:// rendezvous in
the test's temporary directory, so that parallel test workers never share a
port. This module imports only torch and the port: the spawned ranks import
it, and not the test module (which imports JAX)."""

import os
import time

import numpy as np
import torch

TIMEOUT_S = 300


def start(fn, world: int, root, *args):
    """Start fn(rank, world, init_method, out_dir, *args) in `world` spawned
    processes; returns the handle that `collect` joins."""
    import torch.multiprocessing as mp

    out = os.path.join(str(root), f"ranks_{fn.__name__}_{world}")
    os.makedirs(out, exist_ok=True)
    init = f"file://{os.path.join(out, 'rendezvous')}"
    ctx = mp.start_processes(fn, args=(world, init, out, *args), nprocs=world, join=False, start_method="spawn")
    return ctx, out, world, fn.__name__


def collect(handle):
    """Wait for the ranks of `start` (at most TIMEOUT_S) and return each
    rank's torch.save'd result (out_dir/rank<r>.pt)."""
    ctx, out, world, name = handle
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{name}: ranks did not finish in {TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _join(rank, world, init):
    from gaustar_tpu_torch.parallel import launch

    torch.set_num_threads(1)
    assert launch.initialize(rank, world, init, device="cpu")


def _save(out, rank, result):
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))


def port_scene(params_np, config_np, data_np, device="cpu"):
    """The port's (params, config, data) from the JAX package's fields."""
    from gaustar_tpu_torch import bridge

    return (bridge.sugar_params_from_numpy(params_np, device), bridge.sugar_config_from_numpy(config_np, device),
            bridge.frame_data_from_numpy(data_np, device))


def gauss2d_grads(mesh, params_np, config_np, data_np, cfg_fields, sh_deg):
    """This rank's gradients of one gauss2d SGD(lr 1) step, as the step
    applies them."""
    from gaustar_tpu_torch import bridge
    from gaustar_tpu_torch.parallel import gauss2d
    from gaustar_tpu_torch.train.optimizer import sgd
    from gaustar_tpu_torch.train.refine import RefineConfig

    _, config, data = port_scene(params_np, config_np, data_np)
    p = bridge.sugar_shard_from_numpy(params_np, mesh.gauss, mesh.gauss_rank, "cpu")
    grads = {}

    def update(params, g, state):
        grads.update({k: v.clone().numpy() for k, v in g.items()})
        sgd(1.0)(params, g, state)

    step = gauss2d.make_gauss2d_train_step(config, data, RefineConfig(**cfg_fields), update, mesh)(sh_deg)
    loss, aux = step(p, None, 0, 1)
    return {"loss": float(loss), "num_pairs": aux["num_pairs"], "grads": grads}


def gauss2d_ranks(rank, world, init, out, gauss, params_np, config_np, data_np, cfg_fields, sh_deg):
    from gaustar_tpu_torch.parallel import launch

    _join(rank, world, init)
    mesh = launch.make_mesh(gauss=gauss, device="cpu")
    _save(out, rank, {"cam_rank": mesh.cam_rank, "gauss_rank": mesh.gauss_rank,
                      **gauss2d_grads(mesh, params_np, config_np, data_np, cfg_fields, sh_deg)})


def camera_dp_params(mesh, steps: int, lr: float):
    """Each step's loss and the gradients it applied, and the parameters
    after `steps` camera-DP SGD steps on the 4-camera synthetic frame, B = 4 /
    ranks cameras a rank."""
    from gaustar_tpu_torch.parallel import sharding
    from gaustar_tpu_torch.train.optimizer import sgd
    from gaustar_tpu_torch.train.refine import RefineConfig
    from gaustar_tpu_torch.utils.synthetic import synthetic_frame

    params, config, data, _, rcfg = synthetic_frame(n_cams=4, w=32, h=32, device="cpu")
    cfg = RefineConfig(num_iterations=4, loose_bind_from=10**9, do_sh_warmup=False)
    grads = []

    def update(params, g, state):
        grads.append({k: v.clone().numpy() for k, v in g.items()})
        sgd(lr)(params, g, state)

    step = sharding.make_sharded_train_step(config, data, cfg, rcfg, update, mesh)(sh_deg=0)
    b = 4 // mesh.cam
    losses = []
    for it in range(1, steps + 1):
        loss, aux = step(params, None, list(range(b)), it)
        losses.append(float(loss))
    return {"losses": losses, "grads": grads, "num_pairs": aux["num_pairs"],
            "params": {k: v.detach().numpy() for k, v in params.named()}}


def sharded_render(mesh, cloud, bg):
    from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
    from gaustar_tpu_torch.parallel.gauss_shard import render_gauss_sharded
    from gaustar_tpu_torch.utils.synthetic import ring_cameras

    m, s, q, o, c = (torch.as_tensor(a) for a in cloud)
    cam = ring_cameras(1, w=64, h=48, focal=60.0, device="cpu")[0]
    img, num_pairs = render_gauss_sharded(m, quat_scale_to_cov3d(s, q), o, c, cam, mesh, bg=bg)
    return {"img": img.numpy(), "num_pairs": num_pairs}


def collectives_check(mesh):
    """all_gather and all_reduce_sum forward and backward, gather_varlen and
    all_reduce_flat on rank-dependent inputs, with the bytes and seconds
    that the collectives counted."""
    from gaustar_tpu_torch.parallel import collectives

    collectives.reset_counters(timed=True)
    r = mesh.rank
    x = torch.full((2, 3), float(r + 1), requires_grad=True)
    full = collectives.all_gather(x, mesh.gauss_group)
    w = torch.arange(full.numel(), dtype=torch.float32).reshape(full.shape) * (r + 1)
    (full * w).sum().backward()
    rows, counts = collectives.gather_varlen(torch.arange(r + 2, dtype=torch.int64) + 10 * r, mesh.gauss_group)
    flat = collectives.all_reduce_flat([torch.tensor([r + 1.0]), torch.full((2, 2), 2.0 * r)], mesh.gauss_group)
    z = torch.full((3,), float(r + 1), requires_grad=True)
    total = collectives.all_reduce_sum(z * (r + 1), mesh.gauss_group)
    (total * torch.arange(3.0)).sum().backward()
    counted = {"bytes": dict(collectives.BYTES), "seconds": dict(collectives.SECONDS)}
    collectives.reset_counters()
    return {"counted": counted, "full": full.detach().numpy(), "grad": x.grad.numpy(), "rows": rows.numpy(), "counts": counts,
            "flat": [f.numpy() for f in flat], "sum": total.detach().numpy(), "sum_grad": z.grad.numpy()}


def two_ranks(rank, world, init, out, params_np, config_np, data_np, cfg_fields, cloud, bg):
    """Everything the tests run on two ranks, in one group: the collectives
    and a sharded render on a gauss mesh, gauss2d on cam=1 x gauss=2, three
    camera-DP SGD steps on a camera mesh."""
    from gaustar_tpu_torch.parallel import launch, sharding
    from gaustar_tpu_torch.parallel.gauss_shard import make_gauss_mesh

    _join(rank, world, init)
    gmesh = make_gauss_mesh(device="cpu")
    cmesh = sharding.make_camera_mesh(device="cpu")
    _save(out, rank, {
        "collectives": collectives_check(gmesh),
        "render": sharded_render(gmesh, cloud, bg),
        "gauss2d": gauss2d_grads(gmesh, params_np, config_np, data_np, cfg_fields, 1),
        "camera_dp": camera_dp_params(cmesh, steps=3, lr=1e-2),
        "info": launch.runtime_info(),
    })


def cloud(n: int = 150, seed: int = 7):
    """A seeded cloud (means, scales, quats, opacities, colours) in front of
    ring_cameras' first camera; n need not divide the ranks."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(scale=0.5, size=(n, 2)), 4.0 + rng.uniform(-0.5, 0.5, size=(n, 1))],
                           axis=1).astype(np.float32)
    scales = np.exp(rng.normal(loc=-2.2, scale=0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))).astype(np.float32)
    return means, scales, quats, opac, rng.uniform(size=(n, 3)).astype(np.float32)
