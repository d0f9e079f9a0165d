"""Multi-process runtime on torch.distributed (counterpart of
gaustar_tpu/parallel/launch.py).

Typical use, one process per rank (torchrun, or processes the caller spawns):

    from gaustar_tpu_torch.parallel import launch
    launch.initialize()                  # torchrun's RANK / WORLD_SIZE / MASTER_*
    mesh = launch.make_mesh(gauss=2)     # ("cam", "gauss") process groups
    # cameras shard over "cam" (parallel/sharding.py), gaussians and tiles
    # over "gauss" (parallel/gauss2d.py)

`initialize` in a single process with no rank configured is a no-op, so the
same script runs from one card to many. Every rank's tensors live on its
device: cuda:<local_rank % device_count> unless the caller asks for the CPU.

Backend: NCCL when each rank of the host has a card of its own; gloo when
ranks share a card (NCCL refuses two ranks on one device) or run on the CPU.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist


def _local_rank(rank: int) -> int:
    return int(os.environ.get("LOCAL_RANK", rank))


def _local_world_size(world_size: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world_size))


def rank_device(device=None, rank: int | None = None) -> torch.device:
    """The device of this rank: `device` if given ("cpu", "cuda:1", ...),
    else cuda:<local rank % device count>. Raises when CUDA is absent and
    the caller did not ask for the CPU."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run the ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
    return torch.device("cuda", _local_rank(rank) % torch.cuda.device_count())


def default_backend(device: torch.device, world_size: int) -> str:
    """"nccl" when every rank of the host has a card of its own, else "gloo"."""
    if device.type == "cuda" and _local_world_size(world_size) <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(rank: int | None = None, world_size: int | None = None, init_method: str | None = None,
               device=None) -> bool:
    """Join the process group (idempotent). Explicit `rank`, `world_size` and
    `init_method` ("tcp://host:port", "file:///path") win over torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT). Returns True
    when a multi-process group is (or already was) initialized, False in a
    single process with nothing configured."""
    if dist.is_initialized():
        return True
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if world_size is None or world_size <= 1:
        return False
    if rank is None:
        raise ValueError("initialize: world_size > 1 needs a rank")
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(default_backend(dev, world_size), init_method=init_method or "env://", rank=rank,
                            world_size=world_size)
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ("cam", "gauss") layout of the ranks: rank r sits at
    (cam_rank, gauss_rank) = divmod(r, gauss), "cam" outermost as in the JAX
    package, so that a gauss row is ranks that are neighbours (one host).
    `cam_group` joins the ranks of this rank's gauss column (same gauss_rank),
    `gauss_group` those of its cam row. Groups are None in a single process."""

    cam: int
    gauss: int
    rank: int
    device: torch.device
    cam_group: object = None
    gauss_group: object = None

    @property
    def cam_rank(self) -> int:
        return self.rank // self.gauss

    @property
    def gauss_rank(self) -> int:
        return self.rank % self.gauss


def make_mesh(gauss: int = 1, cam: int | None = None, device=None) -> Mesh:
    """The ("cam", "gauss") mesh over every rank; `cam` defaults to the ranks
    left after `gauss`. Every rank must call it, in the same order as any
    other group it makes (torch.distributed.new_group is collective)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % gauss != 0:
        raise ValueError(f"{n} ranks not divisible by gauss={gauss}")
    if cam is None:
        cam = n // gauss
    if cam * gauss != n:
        raise ValueError(f"cam*gauss = {cam * gauss} != {n} ranks")
    rank = dist.get_rank() if dist.is_initialized() else 0
    dev = rank_device(device, rank)
    if n == 1:
        return Mesh(1, 1, 0, dev)
    cam_group = gauss_group = None
    for c in range(cam):
        grp = dist.new_group(list(range(c * gauss, (c + 1) * gauss)))
        if rank // gauss == c:
            gauss_group = grp
    for g in range(gauss):
        grp = dist.new_group(list(range(g, n, gauss)))
        if rank % gauss == g:
            cam_group = grp
    return Mesh(cam, gauss, rank, dev, cam_group, gauss_group)


def runtime_info() -> dict:
    """Process and device summary for logs and failure triage."""
    init = dist.is_initialized()
    cuda = torch.cuda.is_available()
    return {
        "rank": dist.get_rank() if init else 0,
        "world_size": dist.get_world_size() if init else 1,
        "backend": dist.get_backend() if init else None,
        "local_devices": torch.cuda.device_count() if cuda else 0,
        "device": str(torch.cuda.current_device()) if cuda else "cpu",
        "initialized_distributed": init,
    }
