"""The sequence driver, the port against the JAX package: run_sequence over
the two-frame 96x96 dataset of tests/test_sequence.py (written by the port's
utils/synthetic.sequence_dataset) and mid-frame resume (the event branch's
files: tests/test_torch_run_sequence_event.py). JPEG goes through PIL on the CPU (the port's codec is nvJPEG, card
only): the same decoder for both packages."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from gaustar_tpu.io import dataset as jds
from gaustar_tpu.io.ply import read_ply as jax_read_ply
from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu.tools import warp_mesh as jwarp
from gaustar_tpu.train import sequence as jseq
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.io import image_codec
from gaustar_tpu_torch.io.checkpoint import load_sugar
from gaustar_tpu_torch.io.meshio import read_obj
from gaustar_tpu_torch.train import refine
from gaustar_tpu_torch.train import sequence as tseq
from gaustar_tpu_torch.tools.warp_mesh import WarpConfig
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_lr_fn
from gaustar_tpu_torch.utils.synthetic import sequence_dataset, synthetic_frame
from port_helpers import one_thread  # noqa: F401  (autouse)

JAX_RCFG = JaxRasterConfig(max_pairs=1 << 16, chunk=32, max_per_tile=4096, impl="jax")
ITERS = 12
# tests/test_sequence.py's toy-scale warp settings (96-pixel rig).
WARP = dict(min_observe=2, depth_agreement=0.1, edge_threshold=0.7, depth_edge_ker_size=3, edge_scalar=100.0)


def _pil_read(path, device="cpu"):
    return torch.as_tensor(np.array(Image.open(path).convert("RGB")), device=device)


def _pil_write(path, img, quality=95):
    Image.fromarray(img.cpu().numpy()).save(path, quality=quality)


@pytest.fixture
def pil_jpeg(monkeypatch):
    monkeypatch.setattr(image_codec, "read_jpeg", _pil_read)
    monkeypatch.setattr(image_codec, "write_jpeg", _pil_write)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_run_sequence_matches_jax(tmp_path, pil_jpeg):
    data = str(tmp_path / "data")
    info = sequence_dataset(data, "small", "cpu")
    kw = dict(data_root=data, frame_0=0, frame_end=2, refinement_iterations=ITERS, disable_mesh_update=True,
              face_bucket=None, prewarm_programs=False)
    jcfg = jseq.SequenceConfig(work_root=str(tmp_path / "jax"), **kw)
    jseq.run_sequence(jcfg, raster_cfg=JAX_RCFG, warp_cfg=jwarp.WarpConfig(**WARP))
    tcfg = bridge.config_from_fields(tseq.SequenceConfig, {**dataclasses.asdict(jcfg), "work_root": str(tmp_path / "port")})
    entries = []
    params, config, frames = tseq.run_sequence(tcfg, warp_cfg=WarpConfig(**WARP), device="cpu",
                                               log_fn=entries.append, log_every=1)
    assert [r["frame"] for r in frames] == [0, 1]
    # the returned model is the last frame's checkpoint, exactly
    loaded, lconf, _ = load_sugar(str(tmp_path / "port" / "0001" / f"{ITERS}.npz"), "cpu")
    for name, t in params.named():
        assert torch.equal(getattr(loaded, name), t.detach()), name
    assert torch.equal(lconf.faces, config.faces)

    jw, tw = str(tmp_path / "jax"), str(tmp_path / "port")
    assert _files(tw) == _files(jw)
    for f in ("0000", "0001"):
        with np.load(os.path.join(tw, f, f"{ITERS}.npz")) as a, np.load(os.path.join(jw, f, f"{ITERS}.npz")) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        with open(os.path.join(tw, f, f"{ITERS}.json")) as a, open(os.path.join(jw, f, f"{ITERS}.json")) as b:
            ta, jb = json.load(a), json.load(b)
        # the scale clamps follow each package's mesh (frame 1: its own warp)
        assert ta.keys() == jb.keys()
        for k in ("n_gaussians_per_face", "sh_levels", "loose_bind"):
            assert ta[k] == jb[k], k
        tp, jp = jax_read_ply(os.path.join(tw, f, f"{f}.ply")), jax_read_ply(os.path.join(jw, f, f"{f}.ply"))
        assert list(tp["vertex"]) == list(jp["vertex"])
        with open(os.path.join(tw, f, "metrics.jsonl")) as a:
            assert json.loads(a.readline())["event"] == "run_meta"

    # The warped mesh = frame 0's refined vertices + the flow warp's move.
    # (1) The refined vertices agree within 2 x the summed points learning
    # rate (tests/test_torch_refine.py's parameter bound).
    with open(os.path.join(tw, "0000", "config.json")) as f:
        lr_scale = json.load(f)["spatial_lr_scale"]
    lr_fn = make_lr_fn(OptimizationParams(iterations=ITERS), lr_scale)
    tol = 2 * sum(lr_fn(c)["points"] for c in range(ITERS))
    t0, tf, _ = read_obj(os.path.join(tw, "0000", "color_mesh.obj"))
    j0, jf, _ = read_obj(os.path.join(jw, "0000", "color_mesh.obj"))
    np.testing.assert_array_equal(tf, jf)
    assert np.abs(t0 - j0).max() <= tol
    # (2) On the port's refined mesh the JAX package's warp gives the port's
    # warped mesh (to the OBJ's 6 decimals).
    tv, _, _ = read_obj(os.path.join(tw, "0001", "coarse_mesh", "warp_smooth.obj"))
    with np.load(os.path.join(tw, "0000", f"{ITERS}.npz")) as ck:
        pts = ck["points"].astype(np.float64)
    cmr = jds.load_rgb_cameras(os.path.join(data, "rgb_cameras.npz"))
    flows = jds.load_frame_flows(data, 0, len(info["cams"]), 1, shape=tuple(cmr["shape"][0]))
    depths = [list(jds.load_frame_images(data, f, len(info["cams"]))[1]) for f in (0, 1)]
    jwarped, _, _ = jwarp.warp_mesh_using_flow(pts, tf.astype(np.int64), cmr, *flows, *depths, jwarp.WarpConfig(**WARP))
    assert np.abs(jwarped - tv).max() <= 2e-6
    # (3) Between the two runs the warp's nearest-pixel decisions flip for
    # vertices that moved by up to `tol`, which can move single vertices by
    # more than `tol`: the median and the mean move agree within `tol`.
    jv, _, _ = read_obj(os.path.join(jw, "0001", "coarse_mesh", "warp_smooth.obj"))
    err = np.abs(tv - jv).max(axis=1)
    move = (tv - t0).mean(axis=0)
    print(f"warped |port - jax| median {np.median(err):.3e} max {err.max():.3e} (tol {tol:.3e}); mean move {move}; "
          f"observed {frames[0]['warp']['observed_fraction']:.3f}")
    assert np.median(err) <= tol
    assert np.abs(move - (jv - j0).mean(axis=0)).max() <= tol
    assert 0.5 * info["dx"] < move[0] < 1.5 * info["dx"]
    losses = [e["loss"] for e in entries if "loss" in e]
    assert len(losses) == 2 * ITERS and np.isfinite(losses).all()


def test_resume_equals_uninterrupted_run(tmp_path):
    """A refine interrupted after its iteration-6 checkpoint (loose-bound at
    4) and resumed equals one run straight through, exactly, on the CPU."""
    p0, c0, data, _, rcfg = synthetic_frame(n_cams=3, w=32, h=32, device="cpu")
    cfg = refine.RefineConfig(num_iterations=10, loose_bind_from=4, unbind_threshold=1)

    def detect(p, c):
        return np.ones(c.faces.shape[0])

    kw = dict(detect_topo_fn=detect, log_every=1, seed=3)
    full_p, full_c, full_h = refine.refine_frame(p0, c0, data, cfg, rcfg, **kw)

    ck = str(tmp_path / "state.npz")

    def crash(entry):
        if entry.get("iteration") == 7 and "loss" in entry:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        refine.refine_frame(p0, c0, data, cfg, rcfg, checkpoint_every=3, checkpoint_path=ck,
                            **{**kw, "log_fn": crash})
    res_p, res_c, res_h = refine.refine_frame(p0, c0, data, cfg, rcfg, checkpoint_every=3, checkpoint_path=ck,
                                              resume=True, **kw)
    assert full_c.loose_bind and res_c.loose_bind
    assert [h["iteration"] for h in res_h] == list(range(7, 11))
    assert [h["loss"] for h in res_h] == [h["loss"] for h in full_h[6:]]
    for (name, a), (_, b) in zip(res_p.named(), full_p.named()):
        assert torch.equal(a, b), name
