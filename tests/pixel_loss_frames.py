"""Inputs and the former formula of the refine step's pixel losses, shared by
tests/test_torch_pixel_loss.py, tests/test_torch_pixel_loss_gpu.py and
chip_smoke.py's phase 17. No JAX."""

import torch

from gaustar_tpu_torch.ops import losses, pixel_loss
from gaustar_tpu_torch.utils.general import resolve_device


def frame(device, h: int, w: int, seed: int = 0):
    """(render [4, H, W], gt [H, W, 3], gt_depth [H, W]) for the pixel
    losses: a textured image, its ground truth a shifted noisy copy with 5%
    of the pixels equal to it, depth a disc of foreground before background
    at 10.5 with a ring exactly at max_depth 10."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ys, xs = torch.meshgrid(torch.linspace(0, 1, h, device=dev), torch.linspace(0, 1, w, device=dev),
                            indexing="ij")
    base = torch.stack([0.5 + 0.4 * torch.sin(9 * xs + 3 * k) * torch.cos(7 * ys - k) for k in range(3)])
    img = (base + 0.05 * torch.rand((3, h, w), generator=gen, device=dev)).clamp(0, 1)
    gt = (torch.roll(base, 2, dims=2) + 0.05 * torch.rand((3, h, w), generator=gen, device=dev)).clamp(0, 1)
    gt = torch.where(torch.rand((h, w), generator=gen, device=dev) < 0.05, img, gt)
    r = (xs - 0.5) ** 2 + (ys - 0.5) ** 2
    gt_depth = torch.where(r < 0.16, 3.5 + r, torch.full_like(r, 10.5))
    gt_depth = torch.where((r > 0.2) & (r < 0.21), torch.full_like(r, 10.0), gt_depth)
    depth = gt_depth + 0.1 * torch.randn((h, w), generator=gen, device=dev)
    return torch.cat([img, depth[None]]).contiguous(), gt.permute(1, 2, 0).contiguous(), gt_depth.contiguous()


def _masked_mean(x, mask):
    return (x * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def former_means(img, depth, gt_hwc, gt_depth, margin, max_depth: float = 10.0):
    """The four means (L1, SSIM, depth L1, mask term) as refine.pixel_losses
    computed them by autograd before ops/pixel_loss: masked_rgb_loss_cm's L1
    and shift-and-add SSIM terms (l1_loss and the SSIM map's mean without a
    margin), then the depth and mask terms."""
    gt = gt_hwc.permute(2, 0, 1)
    if margin is None:
        l1, ssim = losses.l1_loss(img, gt), losses.ssim_map_cm(img, gt).mean()
    else:
        m3 = pixel_loss.margin_mask(margin, img.shape[1], img.shape[2]).to(img.dtype)[None]
        l1 = _masked_mean(torch.abs(img - gt), m3.expand(img.shape))
        smap = losses.ssim_map_cm(img * m3, gt * m3)
        ssim = _masked_mean(smap, m3.expand(smap.shape))
    fg = (gt_depth < max_depth).to(img.dtype)
    bg = (gt_depth > max_depth).to(img.dtype)
    return torch.stack([l1, ssim, _masked_mean(torch.abs(depth - gt_depth), fg),
                        _masked_mean(torch.abs(depth - max_depth), bg)])
