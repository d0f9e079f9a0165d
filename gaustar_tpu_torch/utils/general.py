"""General numeric utilities (counterpart of gaustar_tpu/utils/general.py)."""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. Defaults to the GPU and raises when
    CUDA is absent: the CPU runs only when the caller asks for it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def device_ms(dev: torch.device, fn):
    """(fn(), its ms): between CUDA events recorded before and after the work
    fn queues on a card (gaps where the card waits for the host included),
    the host clock on the CPU."""
    if dev.type == "cuda":
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


@contextlib.contextmanager
def full_float32():
    """cuDNN convolutions and cuBLAS matmuls in full float32 (no TF32)
    inside the block, whatever the global switches say; they are restored
    after. Only the per-backend switches are touched: PyTorch refuses to
    read its generic matmul precision once a program has set both kinds."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32 = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = tf32


class StepClock:
    """Interval times: CUDA events on a card, the host clock on the CPU.
    Marks pair up: (start, end), (start, end), ..."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"
        self.marks = []

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> list[float]:
        if self.cuda:
            if self.marks:
                self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(self.marks[::2], self.marks[1::2])]
        return [1e3 * (b - a) for a, b in zip(self.marks[::2], self.marks[1::2])]


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0, max_steps=1000000):
    """Log-linear lr decay with optional sin-eased delay (general_utils.py:30-63).

    Returns a host function of the integer step, evaluated in float32 like the
    JAX schedule."""
    f32 = np.float32

    def helper(step: int) -> float:
        if lr_init == 0.0 and lr_final == 0.0:
            return 0.0
        s = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1.0 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(s / f32(lr_delay_steps), f32(0.0), f32(1.0))
            )
        else:
            delay_rate = f32(1.0)
        t = np.clip(s / f32(max_steps), f32(0.0), f32(1.0))
        log_lerp = np.exp(f32(np.log(lr_init)) * (f32(1.0) - t) + f32(np.log(lr_final)) * t)
        return float(delay_rate * log_lerp * (f32(0.0) if step < 0 else f32(1.0)))

    return helper


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """w-first (r, x, y, z) quaternion -> rotation matrix [..., 3, 3], input
    used as-is (forward.cu:127-146 convention)."""
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack(
        [1.0 - 2.0 * (y * y + z * z), 2.0 * (x * y - r * z), 2.0 * (x * z + r * y)], dim=-1
    )
    row1 = torch.stack(
        [2.0 * (x * y + r * z), 1.0 - 2.0 * (x * x + z * z), 2.0 * (y * z - r * x)], dim=-1
    )
    row2 = torch.stack(
        [2.0 * (x * z - r * y), 2.0 * (y * z + r * x), 1.0 - 2.0 * (x * x + y * y)], dim=-1
    )
    return torch.stack([row0, row1, row2], dim=-2)


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> w-first quaternion [..., 4], branch-free
    largest-pivot construction (pytorch3d)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    q_abs2 = torch.stack(
        [
            1.0 + m00 + m11 + m22,
            1.0 + m00 - m11 - m22,
            1.0 - m00 + m11 - m22,
            1.0 - m00 - m11 + m22,
        ],
        dim=-1,
    )
    q_abs = torch.sqrt(torch.maximum(q_abs2, q_abs2.new_zeros(())))
    quat_by_rijk = torch.stack(
        [
            torch.stack([q_abs2[..., 0], m21 - m12, m02 - m20, m10 - m01], dim=-1),
            torch.stack([m21 - m12, q_abs2[..., 1], m10 + m01, m02 + m20], dim=-1),
            torch.stack([m02 - m20, m10 + m01, q_abs2[..., 2], m12 + m21], dim=-1),
            torch.stack([m10 - m01, m20 + m02, m21 + m12, q_abs2[..., 3]], dim=-1),
        ],
        dim=-2,
    )
    quat_candidates = quat_by_rijk / (
        2.0 * torch.maximum(q_abs[..., None], q_abs.new_full((), 0.1))
    )
    best = torch.argmax(q_abs2, dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    out = torch.gather(quat_candidates, -2, idx)[..., 0, :]
    return out / l2norm(out)


def l2norm(v: torch.Tensor, dim: int = -1, keepdim: bool = True, eps: float = 0.0) -> torch.Tensor:
    """sqrt(sum(v^2)). `eps` > 0 clamps the squared sum BEFORE the sqrt, the
    only grad-safe placement: a zero vector then has gradient 0, not 0*inf."""
    sq = torch.sum(v * v, dim=dim, keepdim=keepdim)
    if eps:
        sq = torch.maximum(sq, sq.new_full((), eps * eps))
    return torch.sqrt(sq)


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    """v / max(|v|, eps), with NaN-safe gradients at v == 0 (see l2norm)."""
    return v / l2norm(v, dim=dim, eps=eps)
