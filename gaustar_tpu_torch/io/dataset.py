"""GauSTAR dataset loading, the reference's on-disk contracts (counterpart of
gaustar_tpu/io/dataset.py; SURVEY section 1).

Dataset layout (README.md:187-221):
  <root>/rgb_cameras.npz            {intrinsics [C,3,3], extrinsics [C,(3|4),4], shape [C,2]}
  <root>/<NNNN>/images/img_XXXX.jpg
  <root>/<NNNN>/depth_humanrf/img_XXXX_depth.npz   {'depth': [H,W]} (invalid = 999)
  <root>/<NNNN>/masks_humanrf/img_XXXX_alpha.png
  <root>/<NNNN>/flow_bi/XXXX_{f,b}.npz             {'flow': [h,w,2]} at 0.5x (+pad.txt)
  <root>/init_mesh_100k.obj

Frames are decoded by nvJPEG onto the card (io/image_codec.py); masks are
read on the host and composited on the device as gaustar_scene/cameras.py:
192-196 does: rgb * alpha with the GREEN channel blended to 1 where
alpha = 0 (green-screen background). Depth and flows are host numpy.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.io import image_codec
from gaustar_tpu_torch.tools.geometry import pad_and_resize_flow
from gaustar_tpu_torch.utils.general import device_ms, resolve_device

#: What the most recent load_frame_images call did: {"decode_ms": JPEG
#: decodes summed over cameras (between CUDA events on a card), "cameras"}.
last_load: dict | None = None


def load_rgb_cameras(path: str) -> dict:
    """Load rgb_cameras.npz -> dict with [C,3,3] intrinsics, [C,4,4] extrinsics,
    [C,2] shape (rows, cols)."""
    data = dict(np.load(path))
    extr = data["extrinsics"]
    if extr.shape[1] == 3:
        pad = np.zeros((extr.shape[0], 1, 4))
        pad[:, 0, 3] = 1.0
        extr = np.concatenate([extr, pad], axis=1)
    data["extrinsics"] = extr
    return data


def cameras_from_npz(cmr: dict, downscale: float = 1.0, device="cuda") -> list[Camera]:
    """Cameras on `device` from the rgb_cameras.npz arrays. The dataset images
    are pre-shifted so the principal point is the image center
    (data_process/ahq2gaustar.py:50-81, cmr_convert.py:26)."""
    dev = resolve_device(device)
    cams = []
    for i in range(cmr["shape"].shape[0]):
        rows, cols = (int(x) for x in cmr["shape"][i])
        intr = cmr["intrinsics"][i]
        cam = Camera.from_w2c(cmr["extrinsics"][i], fx=intr[0, 0], fy=intr[1, 1], cx=cols / 2.0, cy=rows / 2.0,
                              width=cols, height=rows, device=dev)
        if downscale != 1.0:
            cam = cam.downscale(downscale)
        cams.append(cam)
    return cams


def split_eval_cameras(items: list, eval_split: bool = True, eval_split_interval: int = 8):
    """Train/test camera split: every `eval_split_interval`-th item (i % k == 0)
    goes to the test set (gs_model.py:119-131). Works on any per-camera list
    (Camera objects, image arrays, indices). Returns (train_items, test_items);
    with eval_split=False the test list is empty."""
    if not eval_split:
        return list(items), []
    train, test = [], []
    for i, it in enumerate(items):
        (test if i % eval_split_interval == 0 else train).append(it)
    return train, test


def frame_dir(root: str, frame: int) -> str:
    return os.path.join(root, f"{frame:04d}")


def load_frame_images(root: str, frame: int, n_cams: int, from_humanrf=True, max_depth=10.0, device="cuda"):
    """(gt_images [C,H,W,3] green-composited, gt_depths [C,H,W]) float32 on
    `device`.

    Depth invalid values (999 from render_depth_from_mesh.py, README FAQ :346)
    become a background sentinel > max_depth (the mask/bg losses key off it)."""
    global last_load
    dev = resolve_device(device)
    label = "_humanrf" if from_humanrf else ""
    fdir = frame_dir(root, frame)
    imgs, decode_ms = [], 0.0
    for ci in range(n_cams):
        rgb, ms = device_ms(dev, lambda: image_codec.read_jpeg(os.path.join(fdir, "images", f"img_{ci:04d}.jpg"),
                                                               dev))
        decode_ms += ms
        img = rgb.to(torch.float32) / 255.0
        mask_path = os.path.join(fdir, f"masks{label}", f"img_{ci:04d}_alpha.png")
        if os.path.exists(mask_path):
            alpha = image_codec.read_png(mask_path)
            if alpha.ndim == 3:
                alpha = alpha[..., 0]
            alpha = torch.as_tensor(alpha, device=dev).to(torch.float32) / 255.0
            # Green-screen composite (cameras.py:192-196).
            img = img * alpha[..., None]
            img[..., 1] += 1.0 - alpha
        imgs.append(img)
    depths = load_frame_depths(root, frame, n_cams, from_humanrf, max_depth)
    last_load = {"decode_ms": decode_ms, "cameras": n_cams}
    return torch.stack(imgs), torch.as_tensor(depths, device=dev)


def load_frame_depths(root: str, frame: int, n_cams: int, from_humanrf=True, max_depth=10.0) -> np.ndarray:
    """The frame's depths [C, H, W] float32 on the host, invalid values
    (> max_depth) set to the background sentinel max_depth + 0.5, as
    load_frame_images loads them."""
    label = "_humanrf" if from_humanrf else ""
    fdir = frame_dir(root, frame)
    depths = []
    for ci in range(n_cams):
        depth = np.load(os.path.join(fdir, f"depth{label}", f"img_{ci:04d}_depth.npz"))["depth"]
        depths.append(np.where(depth > max_depth, max_depth + 0.5, depth).astype(np.float32))
    return np.stack(depths)


def load_frame_flows(root: str, frame: int, n_cams: int, interval: int = 1, shape=None):
    """Load bidirectional flows for frame -> frame+interval, padded+resized to
    full resolution ((row, col) displacement, warp_mesh.py:264-275). Host
    numpy: the stored (x, y) flips to (row, col)."""
    sub = {1: "flow_bi", 2: "flow_bi_2f", 4: "flow_bi_4f", 6: "flow_bi_6f"}[interval]
    fdir = os.path.join(frame_dir(root, frame), sub)
    pad_path = os.path.join(fdir, "pad.txt")
    pad = np.loadtxt(pad_path) if os.path.exists(pad_path) else None
    flows_f, flows_b = [], []
    for ci in range(n_cams):
        f = np.load(os.path.join(fdir, f"{ci:04d}_f.npz"))["flow"][..., ::-1]
        b = np.load(os.path.join(fdir, f"{ci:04d}_b.npz"))["flow"][..., ::-1]
        flows_f.append(pad_and_resize_flow(f, pad, shape))
        flows_b.append(pad_and_resize_flow(b, pad, shape))
    return flows_f, flows_b


def load_cameras_json(path: str, device="cuda") -> list[Camera]:
    """Load a 3DGS `cameras.json` (the gs_out/ contract consumed by
    gaustar_scene/cameras.py:19-129 load_gs_cameras): per-camera position +
    rotation are the INVERSE-view components (W2C built from them, then
    inverted/transposed as in the reference)."""
    dev = resolve_device(device)
    with open(path) as f:
        entries = sorted(json.load(f), key=lambda x: x["img_name"])
    cams = []
    for e in entries:
        w2c_inv = np.eye(4)
        w2c_inv[:3, :3] = np.asarray(e["rotation"])
        w2c_inv[:3, 3] = np.asarray(e["position"])
        w2c = np.linalg.inv(w2c_inv)
        cams.append(Camera.from_w2c(w2c, fx=e["fx"], fy=e["fy"], cx=e["width"] / 2.0, cy=e["height"] / 2.0,
                                    width=e["width"], height=e["height"], device=dev))
    return cams


def save_cameras_json(path: str, cams: list[Camera], names=None):
    """Write the 3DGS cameras.json contract (scene/__init__.py:51-63)."""
    out = []
    for i, c in enumerate(cams):
        w2c = c.view.cpu().numpy().astype(np.float64)
        w2c_inv = np.linalg.inv(w2c)
        out.append(
            {
                "id": i,
                "img_name": names[i] if names else f"img_{i:04d}",
                "width": int(c.width),
                "height": int(c.height),
                "position": w2c_inv[:3, 3].tolist(),
                "rotation": w2c_inv[:3, :3].tolist(),
                "fx": float(c.fx),
                "fy": float(c.fy),
            }
        )
    with open(path, "w") as f:
        json.dump(out, f)
