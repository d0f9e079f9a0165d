"""The port's last tools against the JAX package (and OpenCV, which only the
tests may import): registration and scene editing, the viewer bridge,
camera conversion with its numpy warpAffine and Rodrigues, fov2focal /
focal2fov, and the profiling utilities."""

import csv
import dataclasses
import json
import os
import socket
import threading
import time

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu import cameras as jcameras
from gaustar_tpu.tools import cmr_convert as jcmr
from gaustar_tpu.tools import network_gui as jgui
from gaustar_tpu.tools import registration as jreg
from gaustar_tpu.utils import synthetic as jsynth
from gaustar_tpu_torch import cameras as tcameras
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.sh import sh_to_rgb_dc
from gaustar_tpu_torch.tools import cmr_convert, registration
from gaustar_tpu_torch.tools.network_gui import NetworkGUI, camera_from_viewer_message
from gaustar_tpu_torch.utils import profiling
from port_helpers import one_thread, port_sugar  # noqa: F401


@pytest.fixture(scope="module")
def model():
    """The JAX package's synthetic target model and the port's copy."""
    _, jc, _, jt, _ = jsynth.synthetic_frame(n_cams=1)
    return (jt, jc), port_sugar(jt, jc)


# --- registration -----------------------------------------------------------


def test_best_fit_transform_exact():
    rng = np.random.default_rng(0)
    A = rng.normal(size=(50, 3))
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    t = np.array([0.3, -0.2, 0.7])
    T, R, tt = registration.best_fit_transform(A, A @ q.T + t)
    np.testing.assert_allclose(R, q, atol=1e-8)
    np.testing.assert_allclose(tt, t, atol=1e-8)
    np.testing.assert_array_equal(T, jreg.best_fit_transform(A, A @ q.T + t)[0])


def test_icp_recovers_small_transform():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(500, 3))
    a = 0.1
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1.0]])
    dst = pts @ R.T + np.array([0.05, 0.02, -0.03])
    T, hist = registration.icp(pts, dst)
    assert np.abs(pts @ T[:3, :3].T + T[:3, 3] - dst).max() < 1e-3
    assert hist[-1] < 1e-4
    Tj, hist_j = jreg.icp(pts, dst)
    np.testing.assert_array_equal(T, Tj)
    assert hist == hist_j


def test_cut_and_transform_match_jax(model):
    (jt, jc), (tp, tc) = model
    bb = np.array([[-10, -10, -10], [10, 0.0, 10]])
    jp2, jc2 = jreg.cut_model_by_box(jt, jc, bb, keep_inside=True)
    tp2, tc2 = registration.cut_model_by_box(tp, tc, bb, keep_inside=True)
    assert 0 < tc2.faces.shape[0] < tc.faces.shape[0]
    np.testing.assert_array_equal(tc2.faces.numpy(), np.asarray(jc2.faces))
    for f in dataclasses.fields(jp2):
        np.testing.assert_array_equal(getattr(tp2, f.name).detach().numpy(), np.asarray(getattr(jp2, f.name)))
    assert all(leaf.is_leaf and leaf.requires_grad for _, leaf in tp2.named())
    # the rebuilt gather tables serve the cut model's geometry
    np.testing.assert_allclose(sugar.gaussian_centers(tp2, tc2).detach().numpy(),
                               np.asarray(jreg.sugar.gaussian_centers(jp2, jc2)), atol=1e-6)

    T = np.eye(4)
    T[:3, :3] = cv2.Rodrigues(np.array([0.1, -0.2, 0.05]))[0]
    T[:3, 3] = [1.0, 0.0, -0.5]
    jp3 = jreg.transform_model(jp2, jc2, T)
    tp3 = registration.transform_model(tp2, tc2, T)
    np.testing.assert_allclose(tp3.points.detach().numpy(), np.asarray(jp3.points), atol=1e-6)
    np.testing.assert_allclose(tp3.delta_t.detach().numpy(), np.asarray(jp3.delta_t), atol=1e-6)
    moved = (sugar.gaussian_centers(tp3, tc2) - sugar.gaussian_centers(tp2, tc2) @ torch.as_tensor(
        T[:3, :3].T, dtype=torch.float32)).detach().numpy()
    np.testing.assert_allclose(moved, np.broadcast_to(T[:3, 3], moved.shape), atol=1e-5)


def test_cut_outside_and_mask_in_box(model):
    (jt, jc), (tp, tc) = model
    bb = np.array([[-0.3, -10, -10], [10, 10, 10]])
    np.testing.assert_array_equal(registration.gaussian_mask_in_box(tp, tc, bb).numpy(),
                                  np.asarray(jreg.gaussian_mask_in_box(jt, jc, bb)))
    _, jc2 = jreg.cut_model_by_box(jt, jc, bb, keep_inside=False)
    _, tc2 = registration.cut_model_by_box(tp, tc, bb, keep_inside=False)
    np.testing.assert_array_equal(tc2.faces.numpy(), np.asarray(jc2.faces))


def test_recolor_matches_jax(model):
    (jt, _), (tp, _) = model
    tp2 = registration.recolor_model(tp, factor=(0.0, 0.5, 1.0), offset=(1.0, 0.1, 0.0))
    jp2 = jreg.recolor_model(jt, factor=(0.0, 0.5, 1.0), offset=(1.0, 0.1, 0.0))
    np.testing.assert_allclose(tp2.sh_dc.detach().numpy(), np.asarray(jp2.sh_dc), atol=1e-6)
    rgb = sh_to_rgb_dc(tp2.sh_dc.detach()).numpy()
    np.testing.assert_allclose(rgb[..., 0], 1.0, atol=1e-5)
    assert tp.sh_dc is not tp2.sh_dc and tp2.sh_dc.is_leaf


# --- the viewer bridge ------------------------------------------------------


def _viewer_message(w=32, h=24, train=True, keep_alive=False):
    view = np.eye(4)
    view[:3, 3] = [0.1, -0.2, 0.3]
    return {
        "resolution_x": w, "resolution_y": h, "train": train,
        "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
        "shs_python": False, "rot_scale_python": False,
        "keep_alive": keep_alive, "scaling_modifier": 1.0,
        "view_matrix": view.T.flatten().tolist(),
        "view_projection_matrix": view.flatten().tolist(),
    }


def test_camera_from_message_matches_jax():
    msg = _viewer_message()
    cam = camera_from_viewer_message(msg, device="cpu")
    jcam = jgui.camera_from_viewer_message(msg)
    assert (cam.width, cam.height) == (32, 24)
    assert abs(float(cam.tanfovx) - np.tan(0.5)) < 1e-6
    for name in ("view", "full_proj", "camera_center"):
        np.testing.assert_allclose(getattr(cam, name).numpy(), np.asarray(getattr(jcam, name)), atol=1e-6)
    assert camera_from_viewer_message({**msg, "resolution_x": 0}, device="cpu") is None


def test_protocol_roundtrip():
    gui = NetworkGUI(port=0, device="cpu")
    port = gui.listener.getsockname()[1]
    results = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port))
        msg = json.dumps(_viewer_message()).encode()
        s.sendall(len(msg).to_bytes(4, "little") + msg)
        img = b""
        want = 32 * 24 * 3
        while len(img) < want:
            img += s.recv(want - len(img))
        vlen = int.from_bytes(s.recv(4), "little")
        results["verify"] = s.recv(vlen).decode()
        results["img"] = img
        s.close()

    t = threading.Thread(target=client)
    t.start()

    def render_fn(cam, scaling):
        return torch.full((cam.height, cam.width, 3), 0.5)

    try:
        deadline = time.monotonic() + 20.0
        while "verify" not in results and time.monotonic() < deadline:
            gui.poll(render_fn, keep_alive_default=False, source_path="/data/x")
            if "verify" not in results:
                time.sleep(0.01)
        t.join(timeout=5)
        assert not t.is_alive()
    finally:
        gui.close()
    assert results["verify"] == "/data/x"
    assert len(results["img"]) == 32 * 24 * 3
    assert results["img"][0] == 127  # 0.5 * 255


def test_fov_focal_match_jax():
    for fov, px in ((0.8, 64), (1.3, 1600), (np.array([0.2, 1.0]), np.array([48, 1024]))):
        np.testing.assert_array_equal(tcameras.fov2focal(fov, px), jcameras.fov2focal(fov, px))
        f = tcameras.fov2focal(fov, px)
        np.testing.assert_array_equal(tcameras.focal2fov(f, px), jcameras.focal2fov(f, px))
        np.testing.assert_allclose(tcameras.focal2fov(f, px), fov, rtol=1e-12)


# --- camera conversion ------------------------------------------------------


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("channels", [1, 3])
def test_recenter_image_equals_cv2_warp_affine(dtype, channels):
    """The numpy translation warp against cv2.warpAffine (INTER_LINEAR,
    constant border): uint8 exactly; float32 within 1e-6 of the values'
    range, as OpenCV's vector code rounds its tap positions and lerps in
    another order (measured: at most 1 ulp of the range)."""
    rng = np.random.default_rng(channels)
    h, w = 37, 53
    shape = (h, w) if channels == 1 else (h, w, channels)
    img = (rng.integers(0, 256, shape).astype(np.uint8) if dtype == "uint8"
           else rng.uniform(0, 1, shape).astype(np.float32))
    for cx, cy in ((w / 2 + 0.3, h / 2 - 2.71), (w / 2 - 5.5, h / 2 + 3.0), (w / 2 + 1 / 64, h / 2 + 0.5),
                   (w / 2 + 60.0, h / 2)):
        K = np.array([[50.0, 0, cx], [0, 50.0, cy], [0, 0, 1.0]])
        for bv in (None, 17):
            trans = np.float32([[1, 0, -(cx - 0.5 * w)], [0, 1, -(cy - 0.5 * h)]])
            ref = cv2.warpAffine(img, trans, (w, h), **({} if bv is None else {"borderValue": bv}))
            out = cmr_convert.recenter_image(img, K, bv)
            assert out.dtype == img.dtype and out.shape == img.shape
            if dtype == "uint8":
                np.testing.assert_array_equal(out, ref)
            else:
                np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6 * max(1.0, float(bv or 0)))


def test_rodrigues_equals_cv2():
    rng = np.random.default_rng(3)
    for scale in (0.0, 1e-12, 1e-3, 1.0, 3.0):
        r = rng.normal(size=3) * scale
        np.testing.assert_allclose(cmr_convert.rodrigues(r), cv2.Rodrigues(r)[0], rtol=0, atol=1e-14)


def test_actorshq_calibration_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    path = tmp_path / "calibration.csv"
    fields = ["name", "w", "h", "rx", "ry", "rz", "tx", "ty", "tz", "fx", "fy", "px", "py"]
    with open(path, "w", newline="") as f:
        wr = csv.DictWriter(f, fieldnames=fields)
        wr.writeheader()
        for i in range(4):
            r, t = rng.normal(size=3), rng.normal(size=3)
            wr.writerow(dict(name=f"Cam{i:03d}", w=1600, h=1024, rx=r[0], ry=r[1], rz=r[2], tx=t[0], ty=t[1],
                             tz=t[2], fx=rng.uniform(0.8, 1.2), fy=rng.uniform(1.2, 1.8), px=rng.uniform(0.4, 0.6),
                             py=rng.uniform(0.4, 0.6)))
    got = cmr_convert.read_actorshq_calibration(str(path))
    ref = jcmr.read_actorshq_calibration(str(path))
    for k in ("intrinsics", "extrinsics", "shape"):
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-13, err_msg=k)


def test_colmap_export_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    n = 3
    intr = np.stack([np.array([[100.0, 0, 32], [0, 100.0, 24], [0, 0, 1]])] * n)
    extr = []
    for _ in range(n):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(q) < 0:
            q[:, 0] *= -1
        e = np.eye(4)
        e[:3, :3] = q
        e[:3, 3] = rng.normal(size=3)
        extr.append(e)
    extr = np.stack(extr)
    shape = np.stack([[48, 64]] * n)
    cmr_convert.export_colmap(str(tmp_path / "port"), intr, extr, shape)
    jcmr.export_colmap(str(tmp_path / "jax"), intr, extr, shape)
    for name in ("cameras.txt", "images.txt"):
        a = (tmp_path / "port" / "sparse" / "0" / name).read_text()
        assert a == (tmp_path / "jax" / "sparse" / "0" / name).read_text()
    row = (tmp_path / "port" / "sparse" / "0" / "images.txt").read_text().strip().splitlines()[4].split()
    q = np.array([float(x) for x in row[1:5]])
    from gaustar_tpu_torch.utils.general import quaternion_to_matrix

    R = quaternion_to_matrix(torch.as_tensor(q)).numpy()
    np.testing.assert_allclose(R, extr[0][:3, :3], atol=1e-5)


def test_color_mesh_from_views_matches_jax():
    from gaustar_tpu.mesh.primitives import icosphere
    from gaustar_tpu.tools.mesh_render import render_mesh_depth

    verts, faces = icosphere(2, radius=0.5, center=(0, 0, 4.0))
    cams = jsynth.ring_cameras(4, w=64, h=64, focal=80.0)
    intr = np.stack([np.diag([80.0, 80.0, 1.0])] * 4)
    extr = np.stack([np.asarray(c.view) for c in cams])
    cmr = {"intrinsics": intr, "extrinsics": extr}
    depths, images = [], []
    rng = np.random.default_rng(5)
    for c in cams:
        d, m, _ = render_mesh_depth(verts, faces, c, max_pairs=1 << 14, max_per_tile=512)
        depths.append(np.where(np.asarray(m), np.asarray(d), 999.0))
        img = np.zeros((64, 64, 3), np.float32)
        img[np.asarray(m)] = rng.uniform(size=(int(np.asarray(m).sum()), 3))
        images.append(img)
    got = cmr_convert.color_mesh_from_views(verts, faces, np.stack(images), np.stack(depths), cmr)
    ref = jcmr.color_mesh_from_views(verts, faces, np.stack(images), np.stack(depths), cmr)
    np.testing.assert_array_equal(got, ref)
    assert (np.abs(got - 0.5).max(-1) > 1e-6).mean() > 0.5


# --- profiling --------------------------------------------------------------


def test_loop_bench_times_the_calls():
    calls = []
    dt = profiling.loop_bench(lambda i, x: calls.append(float((x * i).sum())), torch.ones(8, 8), iters=3,
                              device="cpu")
    assert dt >= 0 and calls == [0.0, 0.0, 64.0, 128.0]  # one warm-up call, then i = 0, 1, 2


def test_loop_bench_defaults_to_the_card():
    if torch.cuda.is_available():
        assert profiling.loop_bench(lambda i: None, iters=2) >= 0
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.loop_bench(lambda i: None)


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d) as tr:
        float(torch.arange(8.0).sum())
    assert any(e.name == "aten::sum" for e in tr.prof.events())
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


def test_debug_validate(model):
    _, (tp, _) = model
    profiling.debug_validate(tp, name="ok")
    profiling.debug_validate({"a": torch.ones(3)}, grads=[torch.zeros(2)], name="ok")
    with pytest.raises(FloatingPointError, match="parameter at a"):
        profiling.debug_validate({"a": torch.tensor([1.0, float("nan")])}, name="bad")
    with pytest.raises(FloatingPointError, match="gradient at scales"):
        g = {k: torch.zeros_like(v) for k, v in tp.named()}
        g["scales"][0, 0] = float("inf")
        profiling.debug_validate(tp, grads=g, name="bad")

    class Aux:
        num_pairs = 100

    profiling.debug_validate(tp, aux=Aux(), max_pairs=100, name="at the cap")
    with pytest.raises(OverflowError):
        profiling.debug_validate(tp, aux=Aux(), max_pairs=50, name="ovf")
