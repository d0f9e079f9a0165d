"""The refine step's pixel losses of one channels-major render: the CUDA
kernels for Hopper and their plain PyTorch versions (train/refine.py:
pixel_losses; the JAX package's masked_rgb_loss_cm and depth and mask
terms, gaustar_tpu/train/refine.py).

Inputs, shared by every function here:
  img_cm      [3, H, W] the rendered RGB (a view of the render's [4, H, W]);
  pred_depth  [H, W] the rendered depth;
  gt_hwc      [H, W, 3] the camera's ground truth, in its own layout;
  gt_depth    [H, W] its depth, background >= max_depth;
  margin      [4] int64 (left, right, top, bottom) on the device, or None
              for no margin (the same as all four 0).

Output: the four means [4] (L1, SSIM, depth L1, mask term), each over its
clamped count, sum(x * mask) / max(sum(mask), 1): L1 and SSIM over the margin mask m
in every channel, SSIM that of pred * m and gt * m (ops/losses.py:
ssim_map_cm: 11x11 Gaussian window, sigma 1.5, zero padding), depth over
gt_depth < max_depth, the mask term |pred_depth - max_depth| over
gt_depth > max_depth.

`pixel_loss_means` is the autograd.Function boundary, differentiable in
img_cm and pred_depth. On CUDA tensors it launches the kernels
(csrc/pixel_loss.cu) and never falls back; on CPU tensors it runs the plain
versions, which is how the CPU tests run. Both backwards are the same
analytic one, not autograd's replay of the forward: the forward keeps, per
channel, m dS/dmu1, m dS/dE[x^2] and m dS/dE[xy] at each pixel, and the
backward filters them with the mirrored window (the window's adjoint), so
d x = K'Q1 + 2 x K'Q2 + y K'Q3. |x| has the subgradient 0 at 0, as
torch.abs gives it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from gaustar_tpu_torch.ops import _build
from gaustar_tpu_torch.ops import losses
from gaustar_tpu_torch.utils import profiling

WINDOW = 11


def margin_mask(margin, height: int, width: int) -> torch.Tensor:
    """[H, W] 0/1 mask excluding the crop margins (left, right, top, bottom)."""
    xs = torch.arange(width, device=margin.device)
    ys = torch.arange(height, device=margin.device)
    mx = (xs >= margin[0]) & (xs < width - margin[1])
    my = (ys >= margin[2]) & (ys < height - margin[3])
    return (my[:, None] & mx[None, :]).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _masks(img_cm, gt_depth, margin, max_depth):
    """(m [H, W], fg, bg) in the images' dtype."""
    H, W = img_cm.shape[1], img_cm.shape[2]
    if margin is None:
        m = img_cm.new_ones((H, W))
    else:
        m = margin_mask(margin, H, W).to(img_cm.dtype)
    return m, (gt_depth < max_depth).to(img_cm.dtype), (gt_depth > max_depth).to(img_cm.dtype)


def ssim_partials(mu1, mu2, e11, e22, e12):
    """The SSIM map's derivatives in its window moments at each pixel:
    (dS/dmu1 with E[x^2] and E[xy] held, dS/dE[x^2], dS/dE[xy])."""
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    a1 = 2.0 * mu1_mu2 + losses.SSIM_C1
    a2 = 2.0 * (e12 - mu1_mu2) + losses.SSIM_C2
    b1 = mu1_sq + mu2_sq + losses.SSIM_C1
    b2 = (e11 - mu1_sq) + (e22 - mu2_sq) + losses.SSIM_C2
    den = b1 * b2
    s = (a1 * a2) / den
    d_e11 = -s / b2
    d_e12 = 2.0 * a1 / den
    d_mu1 = 2.0 * mu2 * a2 / den - 2.0 * mu1 * s / b1 - 2.0 * mu1 * d_e11 - mu2 * d_e12
    return d_mu1, d_e11, d_e12


def pixel_loss_fwd_plain(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth: float, keep: bool = True):
    """-> (means [4], saved): the shift-and-add SSIM of ops/losses.py.
    saved, for the backward: the four denominators, then (with `keep`) q
    [3, 3, H, W], m dS/dmu1, m dS/dE[x^2] and m dS/dE[xy], each [C, H, W]."""
    gt = gt_hwc.permute(2, 0, 1)
    m, fg, bg = _masks(img_cm, gt_depth, margin, max_depth)
    m3 = m[None].expand(img_cm.shape)
    moments = losses.ssim_moments_cm(img_cm * m[None], gt * m[None], WINDOW)
    smap = losses.ssim_from_moments(*moments)
    denom = torch.stack([torch.clamp_min(x.sum(), 1.0) for x in (m3, m3, fg, bg)])
    sums = torch.stack([
        (torch.abs(img_cm - gt) * m3).sum(),
        (smap * m3).sum(),
        (torch.abs(pred_depth - gt_depth) * fg).sum(),
        (torch.abs(pred_depth - max_depth) * bg).sum(),
    ])
    if not keep:
        return sums / denom, denom
    return sums / denom, torch.cat([denom, (torch.stack(ssim_partials(*moments)) * m).reshape(-1)])


def pixel_loss_bwd_plain(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth: float, saved, g):
    """(d img_cm [3, H, W], d pred_depth [H, W]) from the means' cotangent
    g [4] and the forward's saved denominators and q."""
    gt = gt_hwc.permute(2, 0, 1)
    m, fg, bg = _masks(img_cm, gt_depth, margin, max_depth)
    coef = g / saved[:4]
    kcol, krow = losses._ssim_factors(WINDOW)
    H, W = img_cm.shape[1], img_cm.shape[2]
    kq = losses._sep_filter_bhw(saved[4:].reshape(-1, H, W), kcol[::-1], krow[::-1]).reshape(3, 3, H, W)
    x, y = img_cm * m, gt * m
    d_img = m * (coef[1] * (kq[0] + 2.0 * x * kq[1] + y * kq[2]) + coef[0] * torch.sign(img_cm - gt))
    d_depth = coef[2] * fg * torch.sign(pred_depth - gt_depth) + coef[3] * bg * torch.sign(pred_depth - max_depth)
    return d_img, d_depth


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/pixel_loss.cu)
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# img, img channel stride, depth, gt, gt_depth, margin, max_depth, height, width, host taps
_COMMON_ARGS = [_P, _L, _P, _P, _P, _P, _F, _I, _I, _P]
_ARGS = {
    "pixel_loss_fwd": _COMMON_ARGS + [_P, _P, _P, _P, _P],  # q, partials, means, denom, stream
    "pixel_loss_bwd": _COMMON_ARGS + [_P, _P, _P, _P, _P, _P],  # q, g, denom, d_img, d_depth, stream
}
# csrc/pixel_loss.cu's output tile (TW = TH) and partial sums a block (NPART)
_TILE = 32
_NPART = 8


@functools.lru_cache(maxsize=2)
def _taps(mirrored: bool):
    """The window's factors as 22 host floats (vertical, then horizontal),
    each mirrored for the backward."""
    kcol, krow = losses._ssim_factors(WINDOW)
    if mirrored:
        kcol, krow = kcol[::-1], krow[::-1]
    return (ctypes.c_float * (2 * WINDOW))(*kcol, *krow)


def _frame(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth):
    """(device, the kernels' common arguments), after checking what they
    read."""
    dev = img_cm.device
    C, H, W = img_cm.shape
    if not (img_cm.is_cuda and img_cm.dtype == torch.float32 and C == 3 and img_cm.stride(2) == 1
            and img_cm.stride(1) == W):
        raise ValueError(f"img_cm must be CUDA float32 [3, H, W] with contiguous rows, got {img_cm.dtype} "
                         f"{tuple(img_cm.shape)} {img_cm.stride()} on {dev}")
    for name, t, shape in (("pred_depth", pred_depth, (H, W)), ("gt_hwc", gt_hwc, (H, W, 3)),
                           ("gt_depth", gt_depth, (H, W))):
        if t.device != dev or t.dtype != torch.float32 or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 {list(shape)} on {dev}")
    if margin is not None and (margin.device != dev or margin.dtype != torch.int64 or margin.shape != (4,)):
        raise ValueError(f"margin must be int64 [4] on {dev}")
    return dev, (img_cm.data_ptr(), img_cm.stride(0), pred_depth.data_ptr(), gt_hwc.data_ptr(),
                 gt_depth.data_ptr(), 0 if margin is None else margin.data_ptr(), float(max_depth), H, W)


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _fwd(dev, frame, keep: bool):
    H, W = frame[-2], frame[-1]
    n_q = 9 * H * W if keep else 0
    n_part = -(-H // _TILE) * -(-W // _TILE) * _NPART
    means = torch.empty(4, dtype=torch.float32, device=dev)
    saved = torch.empty(4 + n_q + n_part, dtype=torch.float32, device=dev)  # denom, q, the blocks' partials
    base = saved.data_ptr()
    err = _build.load("pixel_loss", _ARGS).pixel_loss_fwd(
        *frame, _taps(False), base + 16 if keep else 0, base + 4 * (4 + n_q), means.data_ptr(), base,
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "pixel_loss_fwd")
    profiling.count("pixel_loss_fwd")
    return means, saved


def _bwd(dev, frame, saved, g):
    H, W = frame[-2], frame[-1]
    if saved.numel() < 4 + 9 * H * W:
        raise ValueError("the forward kept no partials (keep=False)")
    g = g.contiguous()
    d_img = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    d_depth = torch.empty((H, W), dtype=torch.float32, device=dev)
    base = saved.data_ptr()
    err = _build.load("pixel_loss", _ARGS).pixel_loss_bwd(
        *frame, _taps(True), base + 16, g.data_ptr(), base, d_img.data_ptr(), d_depth.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "pixel_loss_bwd")
    profiling.count("pixel_loss_bwd")
    return d_img, d_depth


def pixel_loss_fwd_cuda(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth: float, keep: bool = True):
    """Launch csrc/pixel_loss.cu's forward -> (means [4], saved), as
    pixel_loss_fwd_plain; saved also holds the blocks' partial sums."""
    return _fwd(*_frame(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth), keep)


def pixel_loss_bwd_cuda(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth: float, saved, g):
    """Launch csrc/pixel_loss.cu's backward -> (d img_cm, d pred_depth), as
    pixel_loss_bwd_plain."""
    return _bwd(*_frame(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth), saved, g)


class PixelLosses(torch.autograd.Function):
    """The four means [4], differentiable in img_cm and pred_depth. On CUDA
    the backward reuses the forward's checked arguments."""

    @staticmethod
    def forward(ctx, img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth):
        args = (img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth)
        keep = any(ctx.needs_input_grad[:2])
        if img_cm.is_cuda:
            ctx.frame = _frame(*args)
            means, saved = _fwd(*ctx.frame, keep)
        else:
            means, saved = pixel_loss_fwd_plain(*args, keep=keep)
        ctx.save_for_backward(img_cm, pred_depth, gt_hwc, gt_depth, margin, saved)
        ctx.max_depth = max_depth
        return means

    @staticmethod
    def backward(ctx, g):
        img_cm, pred_depth, gt_hwc, gt_depth, margin, saved = ctx.saved_tensors
        with profiling.span("loss.pixel_bwd"):
            if img_cm.is_cuda:
                d_img, d_depth = _bwd(*ctx.frame, saved, g)
            else:
                d_img, d_depth = pixel_loss_bwd_plain(img_cm, pred_depth, gt_hwc, gt_depth, margin, ctx.max_depth,
                                                      saved, g)
        return d_img, d_depth, None, None, None, None


def pixel_loss_means(img_cm, pred_depth, gt_hwc, gt_depth, margin, max_depth: float):
    """(L1, SSIM, depth L1, mask term) means [4] of one render."""
    return PixelLosses.apply(img_cm, pred_depth, gt_hwc, gt_depth, margin, float(max_depth))
