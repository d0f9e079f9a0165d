"""Offline quality metrics (counterpart of gaustar_tpu/eval/metrics.py;
gaussian_splatting/metrics.py:36-95).

PSNR and SSIM are ops/losses.py's, on `device` (the card unless the caller
passes "cpu"), wherever their inputs lie. LPIPS
follows the reference's lpips(vgg): VGG16 features at relu1_2 ... relu5_3,
unit-normalized per channel, squared differences weighted by learned linear
layers, averaged over space and summed over layers. The repository holds
neither VGG16 nor LPIPS weights, so `LPIPSVgg` takes the one file that
eval/lpips_convert.py packs from them and raises without it.

`evaluate_dirs` walks the matching file names of a renders and a GT
directory, reads PNGs with io/image_codec.read_png, and returns the
per-scene {"PSNR", "SSIM", "LPIPS"} of metrics.py.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch
from torch import nn

from gaustar_tpu_torch.io.image_codec import read_png
from gaustar_tpu_torch.ops.losses import psnr as _psnr, ssim as _ssim
from gaustar_tpu_torch.utils.general import full_float32, resolve_device

# VGG16's "features" trunk (configuration D) and where LPIPS taps it.
VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]
TAP_CUTS = [4, 9, 16, 23, 30]


def _tensor(x, device: torch.device) -> torch.Tensor:
    if torch.is_tensor(x):
        return x.to(device, torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def psnr(pred, gt, device="cuda") -> float:
    """PSNR of two [H, W, C] images in [0, 1] (arrays or tensors)."""
    dev = resolve_device(device)
    return float(_psnr(_tensor(pred, dev), _tensor(gt, dev)))


def ssim(pred, gt, device="cuda") -> float:
    dev = resolve_device(device)
    return float(_ssim(_tensor(pred, dev), _tensor(gt, dev)))


def margin_psnr(pred, gt, margin: int = 50, device="cuda") -> float:
    """Train-time PSNR with a 50 px margin crop (gaussian_splatting/train.py:198-199)."""
    dev = resolve_device(device)
    p = _tensor(pred, dev)[margin:-margin, margin:-margin]
    g = _tensor(gt, dev)[margin:-margin, margin:-margin]
    return float(_psnr(p, g))


class LPIPSVgg(nn.Module):
    """LPIPS(vgg) scorer in float32 on `device`, from a weights file that
    holds the VGG16 "features" state dict and "lins" [w0..w4]
    (lpips_convert.py). Convolutions run in full float32 whatever the global
    TF32 switches say."""

    def __init__(self, weights_path: str | None = None, device="cuda"):
        super().__init__()
        if weights_path is None or not os.path.exists(weights_path):
            raise FileNotFoundError(
                "LPIPS needs pretrained VGG16 weights; pass weights_path to a file "
                "containing {'features.N.weight'/... : vgg16-features state dict, "
                "'lins': [w0..w4]}, as eval/lpips_convert.py writes it."
            )
        dev = resolve_device(device)
        layers, in_ch = [], 3
        for v in VGG_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU(inplace=True)]
                in_ch = v
        features = nn.Sequential(*layers)
        blob = torch.load(weights_path, map_location="cpu")
        state = {k.removeprefix("features."): v for k, v in blob.items() if k.startswith("features.")}
        if not state and "vgg16" in blob:
            state = {k.removeprefix("features."): v for k, v in blob["vgg16"].items() if k.startswith("features.")}
        if state:
            features.load_state_dict(state)
        children, prev = list(features.children()), 0
        self.slices = nn.ModuleList()
        for cut in TAP_CUTS:
            self.slices.append(nn.Sequential(*children[prev:cut]))
            prev = cut
        self.register_buffer("lins", torch.cat([torch.as_tensor(w, dtype=torch.float32).reshape(-1)
                                                for w in blob["lins"]]))
        self.register_buffer("shift", torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1))
        self.to(device=dev, dtype=torch.float32).eval()

    @torch.no_grad()
    def forward(self, pred, gt) -> torch.Tensor:
        """LPIPS distance of two [H, W, 3] images in [0, 1], a 0-d tensor."""
        dev = self.shift.device

        def prep(x):
            t = _tensor(x, dev).permute(2, 0, 1)[None]
            return (t * 2.0 - 1.0 - self.shift) / self.scale

        xa, xb = prep(pred), prep(gt)
        total = xa.new_zeros(())
        offset = 0
        with full_float32():
            for sl in self.slices:
                xa, xb = sl(xa), sl(xb)
                na = xa / (xa.square().sum(1, keepdim=True).sqrt() + 1e-10)
                nb = xb / (xb.square().sum(1, keepdim=True).sqrt() + 1e-10)
                w = self.lins[offset:offset + xa.shape[1]]
                offset += xa.shape[1]
                total = total + ((na - nb).square() * w.view(1, -1, 1, 1)).sum(1).mean()
        return total


def evaluate_pairs(renders, gts, lpips_fn=None, device="cuda") -> dict:
    """Mean metrics over lists of [H, W, 3] images (metrics.py:36-62), PSNR
    and SSIM on `device`, LPIPS on `lpips_fn`'s."""
    out = {
        "PSNR": float(np.mean([psnr(r, g, device=device) for r, g in zip(renders, gts)])),
        "SSIM": float(np.mean([ssim(r, g, device=device) for r, g in zip(renders, gts)])),
    }
    if lpips_fn is not None:
        out["LPIPS"] = float(np.mean([float(lpips_fn(r, g)) for r, g in zip(renders, gts)]))
    return out


def evaluate_dirs(renders_dir: str, gt_dir: str, lpips_weights: str | None = None, out_json: str | None = None,
                  device="cuda") -> dict:
    """Metrics over the PNG files of `renders_dir` that `gt_dir` also holds,
    by sorted name (metrics.py:36-95), on `device`; written to `out_json`
    when given."""
    dev = resolve_device(device)
    renders, gts = [], []
    for name in sorted(os.listdir(renders_dir)):
        gp = os.path.join(gt_dir, name)
        if not os.path.exists(gp):
            continue
        for out, path in ((renders, os.path.join(renders_dir, name)), (gts, gp)):
            out.append(torch.as_tensor(read_png(path), device=dev).to(torch.float32) / 255.0)
    lpips_fn = LPIPSVgg(lpips_weights, dev) if lpips_weights else None
    result = evaluate_pairs(renders, gts, lpips_fn, device=dev)
    if out_json:
        with open(out_json, "w") as f:
            json.dump(result, f, indent=2)
    return result
