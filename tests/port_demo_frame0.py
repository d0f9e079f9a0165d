"""Frame 0 of the end-to-end demo at its full size, the port against the JAX
package on one model (CPU, about 20 minutes):

    JAX_PLATFORMS=cpu python tests/port_demo_frame0.py [--iters 600] [--root DIR]

The port writes the demo's dataset (12 cameras at 256x256, icosphere(3)
meshes; PIL's JPEG) and refines frame 0 with the demo's settings up to its
mid-refine detection, where it stops. On that model it prints: the port's
and the JAX package's detection (flagged faces, the largest face-weight
difference); the detection renders' depth error against the GT with the
trained scales and with the initial ones; and the event's chain (fusion,
detection, surgery) through both packages, with the port's surgery also on
the JAX fused mesh and face weights. Not a test: a CPU render of these
meshes takes seconds."""

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch
from PIL import Image

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gaustar_tpu.cameras import stack_cameras as jax_stack  # noqa: E402
from gaustar_tpu.io import checkpoint as jck  # noqa: E402
from gaustar_tpu.io import dataset as jds  # noqa: E402
from gaustar_tpu.mesh.topology import build_topology as jax_topology  # noqa: E402
from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig  # noqa: E402
from gaustar_tpu.train import mesh_update as jmu  # noqa: E402
from gaustar_tpu.train import topo_detect as jtd  # noqa: E402
from gaustar_tpu_torch import bridge, demo  # noqa: E402
from gaustar_tpu_torch.cameras import stack_cameras  # noqa: E402
from gaustar_tpu_torch.io import checkpoint as ck  # noqa: E402
from gaustar_tpu_torch.io import dataset as ds  # noqa: E402
from gaustar_tpu_torch.io import image_codec  # noqa: E402
from gaustar_tpu_torch.io.meshio import read_obj  # noqa: E402
from gaustar_tpu_torch.mesh.surgery import Mesh  # noqa: E402
from gaustar_tpu_torch.models import sugar  # noqa: E402
from gaustar_tpu_torch.ops.rasterizer import RasterConfig  # noqa: E402
from gaustar_tpu_torch.train import mesh_update as tmu  # noqa: E402
from gaustar_tpu_torch.train import sequence as tseq  # noqa: E402
from gaustar_tpu_torch.train import topo_detect as ttd  # noqa: E402

# The longest tile list of these renders stays under 4096 at 256x256.
JAX_RCFG = JaxRasterConfig(max_pairs=1 << 17, chunk=32, max_per_tile=4096, impl="jax")


class _Detected(Exception):
    pass


def port_model_at_detection(seq, dcfg, data, path):
    """Refine frame 0 through the port until its mid-refine detection; save
    the model there to `path` and return its face weights."""
    cams = ds.cameras_from_npz(ds.load_rgb_cameras(os.path.join(data, "rgb_cameras.npz")), 1.0, "cpu")
    gt_images, gt_depths = ds.load_frame_images(data, 0, len(cams), device="cpu")
    verts, faces, colors = read_obj(os.path.join(data, seq.init_mesh_name))
    detect, out = ttd.detect_topo_err, {}

    def stop_at_detection(params, config, *args, **kwargs):
        out["face_w"] = detect(params, config, *args, **kwargs)
        ck.save_sugar(path, params, config)
        raise _Detected

    ttd.detect_topo_err = stop_at_detection
    try:
        tseq.refine_one_frame(seq, 0, verts, faces, colors, cams, gt_images, gt_depths, RasterConfig(), True,
                              detect_cfg=dcfg, device="cpu")
    except _Detected:
        pass
    finally:
        ttd.detect_topo_err = detect
    return out["face_w"]


def depth_error(params, config, cam, gt_depth):
    """Median and 90th percentile of |solid-surface depth - GT| where both hit."""
    with torch.no_grad():
        d, _ = sugar.render_depth(ttd.detection_params(params, 0.995), config, cam, max_depth=10.0,
                                  use_solid_surface=True)
    err = (d - gt_depth)[(gt_depth < 9) & (d < 9)].abs()
    return float(err.median()), float(err.quantile(0.9))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=600, help="the frame's refine budget (detection at half)")
    ap.add_argument("--root", default=None, help="work directory (default: a temporary one)")
    args = ap.parse_args(argv)
    image_codec.read_jpeg = lambda p, device="cpu": torch.as_tensor(np.array(Image.open(p).convert("RGB")),
                                                                    device=device)
    image_codec.write_jpeg = lambda p, img, quality=95: Image.fromarray(img.cpu().numpy()).save(p, quality=quality)
    root = args.root or tempfile.mkdtemp(prefix="gaustar_demo_frame0_")
    data, model_path = os.path.join(root, "data"), os.path.join(root, "model.npz")
    demo.build_dataset(data, device="cpu")
    seq, dcfg, _ = demo.configs(data, os.path.join(root, "work"), args.iters)

    face_w = port_model_at_detection(seq, dcfg, data, model_path)
    params, config, _ = ck.load_sugar(model_path, "cpu")
    cam_list = ds.cameras_from_npz(ds.load_rgb_cameras(os.path.join(data, "rgb_cameras.npz")), 1.0, "cpu")
    cams = stack_cameras(cam_list)
    _, gt_depths = ds.load_frame_images(data, 0, len(cam_list), device="cpu")
    jp, jc, _ = jck.load_sugar(model_path)
    jcams = jax_stack(jds.cameras_from_npz(jds.load_rgb_cameras(os.path.join(data, "rgb_cameras.npz"))))
    _, jgd = jds.load_frame_images(data, 0, len(cam_list))
    jdcfg = bridge.config_from_fields(jtd.TopoDetectConfig, dataclasses.asdict(dcfg))
    jtopo = jax_topology(np.asarray(jc.faces), int(np.asarray(jp.points).shape[0]))
    jface_w = np.asarray(jtd.detect_topo_err(jp, jc, jcams, np.asarray(jgd), jtopo, JAX_RCFG, jdcfg))
    print(f"detection at iteration {args.iters // 2}: port flags {int((face_w >= 0.6).sum())} of {len(face_w)} "
          f"faces, JAX {int((jface_w >= 0.6).sum())}; max |face weight difference| "
          f"{np.abs(face_w - jface_w).max():.3e}", flush=True)

    initial, _ = sugar.init_sugar(*demo.scene_meshes()[0][:2], device="cpu")
    reset = sugar.fresh_params(params, scales=initial.scales.detach())
    print(f"detection depth error, camera 3 (median, p90 m): trained "
          f"{depth_error(params, config, cam_list[3], gt_depths[3])}, with the initial scales "
          f"{depth_error(reset, config, cam_list[3], gt_depths[3])}", flush=True)

    fusion_kw = dict(voxel_size=seq.fusion_voxel_size, sdf_trunc=seq.fusion_sdf_trunc,
                     depth_trunc=seq.fusion_depth_trunc, max_dim=seq.fusion_max_dim,
                     simplify_face_num=seq.fusion_simplify_face_num, use_orbit_cameras=seq.fusion_use_orbit,
                     solid_opacity=seq.fusion_solid_opacity)
    surgery_kw = dict(force_watertight=seq.force_watertight, boundary_pad=seq.boundary_pad,
                      cc_face_threshold=seq.update_cc_face_threshold)
    events = {}
    fused = tmu.extract_mesh_fusion(params, config, cams, RasterConfig(), **fusion_kw)
    events["port"] = tmu.update_mesh_with_fusion(params, config, fused, face_w, **surgery_kw)
    jfused = jmu.extract_mesh_fusion(jp, jc, jcams, JAX_RCFG, **fusion_kw)
    events["JAX"] = jmu.update_mesh_with_fusion(jp, jc, jfused, jface_w, **surgery_kw)
    events["port on the JAX fusion"] = tmu.update_mesh_with_fusion(
        params, config, Mesh(np.asarray(jfused.verts, np.float64), np.asarray(jfused.faces, np.int64)), jface_w,
        **surgery_kw)
    print(f"fused faces: port {len(fused.faces)}, JAX {len(jfused.faces)}")
    for name, ev in events.items():
        faces = len(ev["updated_mesh"].faces) if ev.get("cc_update_num", 0) > 0 else None
        print(f"event, {name}: cc_update_num {ev['cc_update_num']}, updated faces {faces}, pad {ev.get('aabb_pad')}")


if __name__ == "__main__":
    main()
