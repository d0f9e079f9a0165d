"""The end-to-end demo: the whole GauSTAR pipeline on a synthetic capture
whose topology changes between frames (counterpart of examples/demo_tpu.py).

    python -m gaustar_tpu_torch.demo [--iters 600] [--out PATH] [--device cuda]

`build_dataset` writes a two-frame multiview dataset in the reference's
layout: frame 0 is a sphere, frame 1 adds a second blob beside it. Its GT
comes from the port's renders of the meshes (opacity 0.99). `run` then drives
the port's run_sequence with the mesh update on:

  frame 0: bind to the initial mesh -> refine -> detection -> exports ->
           the flow warp;
  frame 1: bind to the warped mesh -> refine -> the mid-refine detection
           loose-binds -> TSDF fusion -> the local re-mesh that grafts the
           blob -> re-refine -> exports.

The script expects frame 0's detection to flag nothing. At 600 iterations
it flags most of the sphere (by iteration 300 the gaussians' in-plane
scales have grown enough for their depth renders to drift by centimetres
from the GT's; the JAX package's detection flags the same faces of that
model),
so frame 0 loose-binds and is re-meshed too; after a few iterations it
flags nothing.

It reports, per frame, the PSNR of camera 0 rendered from the frame's
reloaded checkpoint against the green-composited GT, the face count and
whether the mesh was updated; each detection's telemetry (with its pair
demand) and unbind decision; the stage walls; peak memory; and the card.
The record goes to build/demo.json (`--out`).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.eval.metrics import psnr
from gaustar_tpu_torch.io import checkpoint as ckpt_io
from gaustar_tpu_torch.io import dataset as ds
from gaustar_tpu_torch.io import image_codec
from gaustar_tpu_torch.io.meshio import write_obj
from gaustar_tpu_torch.mesh.primitives import icosphere
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.refscale import common
from gaustar_tpu_torch.refscale.seq import timed_stages
from gaustar_tpu_torch.tools import warp_mesh
from gaustar_tpu_torch.train import sequence, topo_detect
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.synthetic import ring_cameras

N_CAMS, W, H, FOCAL = 12, 256, 256, 320.0
GT_OPACITY = 0.99
MAX_DEPTH = 10.0
SPHERE = (0.5, (0.0, 0.0, 4.0))  # radius, centre
BLOB = (0.2, (0.62, 0.1, 4.0))
JPEG_QUALITY = 97


def default_out() -> str:
    """build/demo.json in the repository's checkout."""
    return os.path.join(common.REPO_ROOT, "build", "demo.json")


def scene_meshes() -> list[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """(verts, faces, colours) of each frame: the sphere, then the sphere and
    the blob, coloured from default_rng(0) as the script draws them."""
    rng = np.random.default_rng(0)
    v1, f1 = icosphere(3, radius=SPHERE[0], center=SPHERE[1])
    c1 = rng.uniform(0.2, 0.9, size=(len(v1), 3)).astype(np.float32)
    v2, f2 = icosphere(3, radius=BLOB[0], center=BLOB[1])
    c2 = rng.uniform(0.2, 0.9, size=(len(v2), 3)).astype(np.float32)
    return [(v1, f1, c1), (np.concatenate([v1, v2]), np.concatenate([f1, f2 + len(v1)]), np.concatenate([c1, c2]))]


@torch.no_grad()
def gt_arrays(cams: list[Camera], device="cuda") -> list[dict]:
    """Per frame the GT before encoding, each [C, ...] numpy: "image" uint8
    [H, W, 3] (the render over black, clipped and truncated), "alpha" float32
    (1 - final T), "mask" uint8 (255 where alpha > 0.5), "depth" float32
    (the solid-surface depth render, 999 where it exceeds 9)."""
    dev = resolve_device(device)
    logit = float(torch.log(torch.tensor(GT_OPACITY / (1.0 - GT_OPACITY), dtype=torch.float32)))
    frames = []
    for verts, faces, colors in scene_meshes():
        params, config = sugar.init_sugar(verts, faces, vertex_colors=colors, device=dev)
        params.densities.fill_(logit)
        out = {"image": [], "alpha": [], "depth": []}
        for cam in cams:
            img, aux = sugar.render(params, config, cam, bg=(0, 0, 0))
            d, _ = sugar.render_depth(params, config, cam, max_depth=MAX_DEPTH, use_solid_surface=True)
            out["image"].append((torch.clamp(img, 0, 1) * 255).to(torch.uint8).cpu().numpy())
            out["alpha"].append((1.0 - aux.final_T).cpu().numpy())
            d = d.cpu().numpy()
            out["depth"].append(np.where(d > 9.0, 999.0, d))
        frame = {k: np.stack(v) for k, v in out.items()}
        frame["mask"] = ((frame["alpha"] > 0.5) * 255).astype(np.uint8)
        frames.append(frame)
    return frames


def build_dataset(root: str, n_cams: int = N_CAMS, w: int = W, h: int = H, focal: float = FOCAL,
                  device="cuda") -> list[Camera]:
    """Write the two-frame dataset under `root` (demo_tpu.py:27-120): the rig
    (rgb_cameras.npz), per frame and camera the image as JPEG (quality 97,
    the port's codec), the mask as PNG and the depth as npz, zero
    bidirectional flow at half size for frame 0, and init_mesh_100k.obj (the
    sphere). Returns the cameras."""
    dev = resolve_device(device)
    cams = ring_cameras(n_cams, w=w, h=h, focal=focal, device=dev)
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "rgb_cameras.npz"), intrinsics=np.stack([np.diag([focal, focal, 1.0])] * n_cams),
             extrinsics=np.stack([c.view.cpu().numpy() for c in cams]), shape=np.stack([[h, w]] * n_cams))
    for fi, frame in enumerate(gt_arrays(cams, dev)):
        fdir = os.path.join(root, f"{fi:04d}")
        for sub in ("images", "masks_humanrf", "depth_humanrf", "flow_bi"):
            os.makedirs(os.path.join(fdir, sub), exist_ok=True)
        for ci in range(n_cams):
            image_codec.write_jpeg(os.path.join(fdir, "images", f"img_{ci:04d}.jpg"),
                                   torch.as_tensor(frame["image"][ci], device=dev), quality=JPEG_QUALITY)
            image_codec.write_png(os.path.join(fdir, "masks_humanrf", f"img_{ci:04d}_alpha.png"), frame["mask"][ci])
            np.savez(os.path.join(fdir, "depth_humanrf", f"img_{ci:04d}_depth.npz"), depth=frame["depth"][ci])
        if fi == 0:  # the scene change is a new object, not motion
            zero = np.zeros((h // 2, w // 2, 2), np.float32)
            for ci in range(n_cams):
                np.savez(os.path.join(fdir, "flow_bi", f"{ci:04d}_f.npz"), flow=zero)
                np.savez(os.path.join(fdir, "flow_bi", f"{ci:04d}_b.npz"), flow=zero)
    v1, f1, c1 = scene_meshes()[0]
    write_obj(os.path.join(root, "init_mesh_100k.obj"), v1, f1, c1)
    return cams


def configs(data_root: str, work_root: str, iters: int):
    """The demo's SequenceConfig, TopoDetectConfig and WarpConfig
    (demo_tpu.py:131-160)."""
    seq = sequence.SequenceConfig(
        data_root=data_root, work_root=work_root, frame_0=0, frame_end=2, refinement_iterations=iters, sh_reg=True,
        force_watertight=False, boundary_pad=0.1, update_cc_face_threshold=20,
        # The reference's 8 mm voxels assume meter-scale captures; on this
        # 0.5 m scene they would graft a patch of about 1M faces.
        fusion_voxel_size=0.015, fusion_simplify_face_num=20_000, fusion_solid_opacity=0.995)
    detect = topo_detect.TopoDetectConfig(depth_scalar=3.0, depth_agreement=0.005, min_observe=3, mesh_prop=10,
                                          detect_floor=False, edge_threshold=0.6, edge_scalar=200.0, voxel_size=0.05)
    # A short max_move: zero flow lacks the occlusion rejection of real
    # bidirectional flow, so lifted motion stays short of the blob.
    warp = warp_mesh.WarpConfig(min_observe=2, depth_agreement=0.02, edge_threshold=0.5, depth_edge_ker_size=3,
                                edge_scalar=1000.0, max_move_dist=0.05)
    return seq, detect, warp


def frame_psnr(data_root: str, work_root: str, fi: int, iters: int, dev: torch.device) -> dict:
    """Camera 0 rendered from frame `fi`'s reloaded checkpoint over green,
    against the green-composited GT (demo_tpu.py:164-176)."""
    params, config, _ = ckpt_io.load_sugar(os.path.join(work_root, f"{fi:04d}", f"{iters}.npz"), dev)
    cams = ds.cameras_from_npz(ds.load_rgb_cameras(os.path.join(data_root, "rgb_cameras.npz")), device=dev)
    gt_images, _ = ds.load_frame_images(data_root, fi, len(cams), device=dev)
    with torch.no_grad():
        img, _ = sugar.render(params, config, cams[0], bg=(0, 1, 0))
    return {"psnr_cam0": psnr(torch.clamp(img, 0, 1), gt_images[0], device=dev),
            "faces": int(config.faces.shape[0]),
            "updated": os.path.exists(os.path.join(work_root, f"{fi:04d}", "updated_mesh.obj"))}


def run(root: str, iters: int = 600, device="cuda", log=print) -> dict:
    """The dataset (the rig of N_CAMS, W, H, FOCAL) and the two frames
    under `root` (data/ and work/). Returns the record."""
    dev = resolve_device(device)
    data_root, work_root = os.path.join(root, "data"), os.path.join(root, "work")
    n_cams, w, h = N_CAMS, W, H
    _, build_s = common.clocked(dev, lambda: build_dataset(data_root, n_cams, w, h, FOCAL, dev))
    log(f"dataset: 2 frames x {n_cams} cameras at {w}x{h}, written in {build_s:.1f} s")
    seq, dcfg, wcfg = configs(data_root, work_root, iters)
    decisions, losses = [], []

    def on_log(entry):
        if "unbind_changed" in entry or "detect/flagged_faces" in entry:
            decisions.append(entry)
        elif "loss" in entry:
            losses.append(entry["loss"])

    stages = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with timed_stages(dev, stages):
        (_, _, frames), wall = common.clocked(dev, lambda: sequence.run_sequence(
            seq, detect_cfg=dcfg, warp_cfg=wcfg, device=dev, log_fn=on_log))
    report = {"iters_per_frame": iters, "n_cams": n_cams, "resolution": [w, h], "dataset_build_s": build_s,
              "seq_seconds": wall, "stages": stages, "frame_seconds": [f["seconds"] for f in frames],
              "detection_and_unbind": decisions, "pair_demand": common.pair_demand(decisions),
              "losses_finite": bool(np.isfinite(losses).all()), "n_losses": len(losses)}
    if dev.type == "cuda":
        report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    report["frames"] = [{"frame": f["frame"], "cc_update_num": f["cc_update_num"],
                         **frame_psnr(data_root, work_root, f["frame"], iters, dev)} for f in frames]
    for f in report["frames"]:
        log(f"frame {f['frame']}: PSNR cam 0 {f['psnr_cam0']:.2f} dB, {f['faces']} faces, updated {f['updated']}, "
            f"cc_update_num {f['cc_update_num']}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=600, help="refine iterations a frame")
    ap.add_argument("--out", default=default_out())
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="gaustar_demo_") as root:
        report = run(root, args.iters, device=dev)
    common.write_report(args.out, {**report, **common.device_record(dev)})


if __name__ == "__main__":
    main()
