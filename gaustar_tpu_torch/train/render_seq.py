"""Re-render saved frame checkpoints (counterpart of
gaustar_tpu/train/render_seq.py; render_seq.py:89-124).

Loads each frame's SuGaR checkpoint and renders RGB and depth per camera into
the reference's render output layout (render_b/ render_d/ dirs,
refined_mesh.py:1063-1153): RGB over green as JPEG (nvJPEG, io/image_codec),
depth as npz. Each render is one forward-only launch of the blend kernel.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gaustar_tpu_torch.io import checkpoint as ck
from gaustar_tpu_torch.io import dataset as ds
from gaustar_tpu_torch.io import image_codec
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.utils.general import resolve_device


@torch.no_grad()
def render_sequence(
    data_root: str,
    work_root: str,
    frame_0: int,
    frame_end: int,
    interval: int = 1,
    iterations: int = 2000,
    render_modes: str = "bd",  # 'b' rgb, 'd' depth (render_seq.py render_results)
    raster_cfg: RasterConfig | None = None,
    max_depth: float = 10.0,
    downscale: float = 1.0,
    device="cuda",
):
    dev = resolve_device(device)
    raster_cfg = raster_cfg or RasterConfig()
    cmr = ds.load_rgb_cameras(os.path.join(data_root, "rgb_cameras.npz"))
    cams = ds.cameras_from_npz(cmr, downscale, dev)

    for f_idx in range(frame_0, frame_end, interval):
        fdir = os.path.join(work_root, f"{f_idx:04d}")
        ckpt = os.path.join(fdir, f"{iterations}.npz")
        if not os.path.exists(ckpt):
            raise FileNotFoundError(ckpt)
        params, config, _ = ck.load_sugar(ckpt, dev)

        if "b" in render_modes:
            os.makedirs(os.path.join(fdir, "render_b"), exist_ok=True)
        if "d" in render_modes:
            os.makedirs(os.path.join(fdir, "render_d"), exist_ok=True)

        for ci, cam in enumerate(cams):
            if "b" in render_modes:
                img, _ = sugar.render(params, config, cam, bg=(0.0, 1.0, 0.0), raster_config=raster_cfg)
                arr = (torch.clamp(img, 0, 1) * 255).to(torch.uint8)
                image_codec.write_jpeg(os.path.join(fdir, "render_b", f"render_{ci:06d}.jpg"), arr)
            if "d" in render_modes:
                depth, _ = sugar.render_depth(params, config, cam, max_depth=max_depth, raster_config=raster_cfg)
                np.savez_compressed(os.path.join(fdir, "render_d", f"depth_{ci:06d}.npz"),
                                    depth=depth.cpu().numpy())
