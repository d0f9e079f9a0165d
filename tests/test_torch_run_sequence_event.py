"""The sequence driver's event branch (port only): run_sequence on a
one-frame dataset of the small topology_scene, with the topology event on,
writes updated_mesh.obj and face_corr.npz with the JAX package's keys. JPEG
goes through PIL on the CPU (the port's codec is nvJPEG, card only)."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaustar_tpu_torch.io import image_codec
from gaustar_tpu_torch.io.meshio import read_obj, write_obj
from gaustar_tpu_torch.train import sequence as tseq
from gaustar_tpu_torch.train import topo_detect
from gaustar_tpu_torch.utils.synthetic import topology_scene
from port_helpers import one_thread  # noqa: F401  (autouse)


def _pil_read(path, device="cpu"):
    return torch.as_tensor(np.array(Image.open(path).convert("RGB")), device=device)


def _pil_write(path, img, quality=95):
    Image.fromarray(img.cpu().numpy()).save(path, quality=quality)


@pytest.fixture
def pil_jpeg(monkeypatch):
    monkeypatch.setattr(image_codec, "read_jpeg", _pil_read)
    monkeypatch.setattr(image_codec, "write_jpeg", _pil_write)


def test_event_branch_writes_face_corr(tmp_path, pil_jpeg):
    """run_sequence with the topology event on the small topology_scene (one
    frame, port only): updated_mesh.obj and face_corr.npz with the JAX
    package's keys, and a checkpoint on the updated mesh."""
    sc = topology_scene("cpu", "small")
    data = str(tmp_path / "data")
    fdir = os.path.join(data, "0000")
    for sub in ("images", "depth_humanrf"):
        os.makedirs(os.path.join(fdir, sub))
    cams = sc["cams"]
    focal = float(cams[0].fx)
    np.savez(os.path.join(data, "rgb_cameras.npz"),
             intrinsics=np.stack([np.diag([focal, focal, 1.0])] * len(cams)),
             extrinsics=np.stack([c.view.numpy() for c in cams]),
             shape=np.stack([[c.height, c.width] for c in cams]))
    for ci in range(len(cams)):
        img = (torch.clamp(sc["gt_images"][ci], 0, 1) * 255).to(torch.uint8)
        _pil_write(os.path.join(fdir, "images", f"img_{ci:04d}.jpg"), img, quality=100)
        d = sc["gt_depths"][ci].numpy()
        np.savez(os.path.join(fdir, "depth_humanrf", f"img_{ci:04d}_depth.npz"), depth=np.where(d > 9, 999.0, d))
    write_obj(os.path.join(data, "init_mesh_100k.obj"), sc["verts"], sc["faces"], sc["colors"])

    # tests/test_torch_sequence.py's settings for this scene
    seq = tseq.SequenceConfig(
        data_root=data, work_root=str(tmp_path / "work"), frame_0=0, frame_end=1, refinement_iterations=8,
        force_watertight=False, boundary_pad=0.12, update_cc_face_threshold=10, unbind_threshold=30,
        fusion_voxel_size=0.1, fusion_sdf_trunc=0.2, fusion_use_orbit=False, fusion_solid_opacity=0.995,
        spatial_lr_scale=20.0)
    dcfg = topo_detect.TopoDetectConfig(depth_scalar=3.0, min_observe=2, mesh_prop=10, detect_floor=False,
                                        depth_agreement=0.05, edge_threshold=0.6, edge_scalar=10.0, voxel_size=0.05)
    params, config, (rec,) = tseq.run_sequence(seq, detect_cfg=dcfg, device="cpu")
    assert rec["cc_update_num"] >= 1
    work = os.path.join(seq.work_root, "0000")
    uv, uf, _ = read_obj(os.path.join(work, "updated_mesh.obj"))
    with np.load(os.path.join(work, "face_corr.npz")) as fc:
        assert sorted(fc.files) == ["ref_area", "track_face_mask"]
        track = fc["track_face_mask"]
        assert track.shape == (len(sc["faces"]),) and 0 < track.sum() < len(uf)
        assert fc["ref_area"].shape == (len(uf),)
    # the returned model lives on the updated mesh, as its checkpoint does
    np.testing.assert_array_equal(config.faces.numpy(), uf)
    assert params.scales.shape[0] == 6 * len(uf)
    with np.load(os.path.join(work, "8.npz")) as ck:
        assert ck["faces"].shape == uf.shape and ck["scales"].shape[0] == 6 * len(uf)
