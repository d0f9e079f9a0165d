"""The port's file formats against the JAX package's: OBJ and PLY round
trips read by both packages, SuGaR checkpoints written by either and loaded
by the other (arrays exactly equal), the 3DGS .ply export, the refine
state, the PNG codec against PIL, the JPEG codec's CPU refusal, the dataset
loaders on a written 96x96 dataset (PIL stands in for nvJPEG on the CPU),
cameras.json, Camera.downscale and the metric logger."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gaustar_tpu import cameras as jcameras
from gaustar_tpu.io import checkpoint as jck
from gaustar_tpu.io import dataset as jds
from gaustar_tpu.io import meshio as jmeshio
from gaustar_tpu.io import ply as jply
from gaustar_tpu.mesh.primitives import icosphere
from gaustar_tpu.models import sugar as jsugar
from gaustar_tpu.utils import logging as jlogging
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.io import checkpoint as tck
from gaustar_tpu_torch.io import dataset as tds
from gaustar_tpu_torch.io import image_codec, meshio, ply
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.train.optimizer import adam_init
from gaustar_tpu_torch.utils import logging as tlogging
from gaustar_tpu_torch.utils.synthetic import sequence_dataset
from port_helpers import one_thread  # noqa: F401  (autouse)


def _pil_read(path, device="cpu"):
    return torch.as_tensor(np.array(Image.open(path).convert("RGB")), device=device)


def _pil_write(path, img, quality=95):
    Image.fromarray(img.cpu().numpy()).save(path, quality=quality)


def _model(seed=0, loose=False):
    """A JAX SuGaR model on a small sphere with seeded, trained-looking
    parameters, and the same model in the port."""
    rng = np.random.default_rng(seed)
    verts, faces = icosphere(1, radius=0.5, center=(0, 0, 4.0))
    jp, jc = jsugar.init_sugar(verts, faces, vertex_colors=rng.uniform(0.2, 0.9, (len(verts), 3)),
                               min_scale=0.01, max_scale=0.5)
    fields = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    fields = {k: (v + rng.normal(scale=0.05, size=v.shape)).astype(np.float32) for k, v in fields.items()}
    jp = jsugar.SuGaRParams(**{k: jnp.asarray(v) for k, v in fields.items()})
    jc = dataclasses.replace(jc, loose_bind=loose)
    tp = bridge.sugar_params_from_numpy(fields, device="cpu")
    tc = bridge.sugar_config_from_numpy(
        {"faces": np.asarray(jc.faces), "bary": np.asarray(jc.bary), "thickness": np.asarray(jc.thickness),
         "n_gaussians_per_face": jc.n_gaussians_per_face, "sh_levels": jc.sh_levels, "min_scale": jc.min_scale,
         "max_scale": jc.max_scale, "loose_bind": loose, "n_verts": len(verts)}, device="cpu")
    return jp, jc, tp, tc


@pytest.mark.parametrize("colors", [False, True])
def test_obj_round_trips_between_packages(tmp_path, colors):
    rng = np.random.default_rng(1)
    verts, faces = icosphere(1)
    vc = rng.uniform(size=verts.shape) if colors else None
    for write, read in ((meshio.write_obj, jmeshio.read_obj), (jmeshio.write_obj, meshio.read_obj)):
        path = str(tmp_path / "m.obj")
        write(path, verts, faces, vc)
        a, b = read(path), (jmeshio.read_obj if read is meshio.read_obj else meshio.read_obj)(path)
        for x, y in zip(a, b):
            if x is None:
                assert y is None and not colors
            else:
                np.testing.assert_array_equal(x, y)
        np.testing.assert_allclose(a[0], verts, atol=5e-7)
        np.testing.assert_array_equal(a[1], faces)


def test_ply_round_trips_between_packages(tmp_path):
    rng = np.random.default_rng(2)
    props = {n: rng.normal(size=50).astype(np.float32) for n in ("x", "y", "z", "opacity", "f_dc_0")}
    faces = rng.integers(0, 50, (30, 3))
    for write, read in ((ply.write_ply, jply.read_ply), (jply.write_ply, ply.read_ply)):
        path = str(tmp_path / "a.ply")
        write(path, props, faces)
        out = read(path)
        assert list(out["vertex"]) == list(props)
        for k, v in props.items():
            np.testing.assert_array_equal(out["vertex"][k], v)
        np.testing.assert_array_equal(out["face"]["vertex_indices"], faces)


@pytest.mark.parametrize("loose", [False, True])
def test_checkpoints_load_in_the_other_package(tmp_path, loose):
    """save_sugar of either package loads in the other: the same npz keys
    and json sidecar, every array exactly equal."""
    jp, jc, tp, tc = _model(loose=loose)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jck.save_sugar(jpath, jp, jc, iteration=7)
    tck.save_sugar(tpath, tp, tc, iteration=7)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(str(tmp_path / "jax.json")) as a, open(str(tmp_path / "port.json")) as b:
        assert json.load(a) == json.load(b)

    p2, c2, it = tck.load_sugar(jpath, device="cpu")
    assert it == 7 and c2.loose_bind == loose and c2.n_gaussians_per_face == jc.n_gaussians_per_face
    for name, v in p2.named():
        np.testing.assert_array_equal(v.detach().numpy(), np.asarray(getattr(jp, name)), err_msg=name)
        assert v.requires_grad
    np.testing.assert_array_equal(c2.faces.numpy(), np.asarray(jc.faces))
    jp2, jc2, it2 = jck.load_sugar(tpath)
    assert it2 == 7 and jc2.loose_bind == loose and (jc2.min_scale, jc2.max_scale) == (tc.min_scale, tc.max_scale)
    for name, v in tp.named():
        np.testing.assert_array_equal(np.asarray(getattr(jp2, name)), v.detach().numpy(), err_msg=name)
    # the loaded model renders in the port: its gather tables follow the faces
    pos, _ = sugar.geom_primitives(p2, c2)
    assert torch.isfinite(pos).all()


@pytest.mark.parametrize("loose", [False, True])
def test_export_refined_ply_matches_jax(tmp_path, loose):
    """The NNNN.ply export: the JAX file's properties in its order; values
    within 1e-5 (positions, log-scales) and 1e-4 (quaternions: the port's
    frames clamp the norms inside the sqrt), SH and opacity exact."""
    jp, jc, tp, tc = _model(seed=3, loose=loose)
    jck.export_refined_ply(str(tmp_path / "j.ply"), jp, jc)
    tck.export_refined_ply(str(tmp_path / "t.ply"), tp, tc)
    a = jply.read_ply(str(tmp_path / "j.ply"))["vertex"]
    b = jply.read_ply(str(tmp_path / "t.ply"))["vertex"]
    assert list(a) == list(b)
    for k in a:
        if k.startswith(("f_", "opacity", "n")):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            np.testing.assert_allclose(b[k], a[k], atol=1e-4 if k.startswith("rot") else 1e-5, err_msg=k)


def test_load_ply_reads_the_export_and_defaults_to_the_card(tmp_path):
    """models/gaussians.load_ply of the JAX package's 3DGS .ply: every field
    equal to the JAX loader's on device="cpu"; without a card the default
    device raises."""
    from gaustar_tpu.models import gaussians as jgaussians
    from gaustar_tpu_torch.models import gaussians as tgaussians

    jp, jc, _, _ = _model(seed=4, loose=False)
    path = str(tmp_path / "j.ply")
    jck.export_refined_ply(path, jp, jc)
    want = jgaussians.load_ply(path)
    got = tgaussians.load_ply(path, device="cpu")
    for f in dataclasses.fields(got):
        np.testing.assert_array_equal(getattr(got, f.name).numpy(), np.asarray(getattr(want, f.name)), err_msg=f.name)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tgaussians.load_ply(path)


def test_refine_state_round_trip(tmp_path):
    _, _, tp, _ = _model(seed=4)
    st = adam_init(tp)
    st.count = 5
    for name, v in tp.named():
        st.mu[name].normal_(generator=torch.Generator().manual_seed(1))
        st.nu[name].uniform_(generator=torch.Generator().manual_seed(2))
    uw = torch.rand(tp.scales.shape[0])
    path = str(tmp_path / "state.npz")
    tck.save_refine_state(path, tp, st, 11, uw, loose_bind=True)
    p2, st2, it, uw2, loose = tck.load_refine_state(path, device="cpu")
    assert (it, loose, st2.count) == (11, True, 5) and torch.equal(uw2, uw)
    with np.load(path) as f:
        names = [n for n, _ in tp.named()]
        assert f.files[: len(names) + 1] == names + ["adam_count"]
    for name, v in tp.named():
        assert torch.equal(getattr(p2, name), v.detach()) and getattr(p2, name).requires_grad
        assert torch.equal(st2.mu[name], st.mu[name]) and torch.equal(st2.nu[name], st.nu[name])


def _filter_rows(img: np.ndarray) -> bytes:
    """Raw PNG scanlines of uint8 [H, W, C], row r filtered with type r % 5
    (PNG spec, section 9), so that every filter occurs."""
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int32)
    out = []
    for r in range(h):
        line, up = x[r], (x[r - 1] if r else np.zeros_like(x[r]))
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int32), up[:-c]])
        ft = r % 5
        if ft == 0:
            pred = np.zeros_like(line)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
        out.append(bytes([ft]) + ((line - pred) & 255).astype(np.uint8).tobytes())
    return b"".join(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _write_filtered_png(path, img, interlace=False):
    """An 8-bit PNG of uint8 [H, W, C] whose rows use every filter; with
    `interlace`, Adam7: each non-empty pass filtered as an image of its own."""
    import struct
    import zlib

    h, w, c = img.shape
    ct = {1: 0, 3: 2, 4: 6}[c]

    def chunk(t, body):
        return struct.pack(">I", len(body)) + t + body + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF)

    if interlace:
        passes = [img[y0::dy, x0::dx] for x0, y0, dx, dy in ADAM7]
        rows = b"".join(_filter_rows(p) for p in passes if p.size)
    else:
        rows = _filter_rows(img)
    with open(path, "wb") as f:
        f.write(image_codec.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ct, 0, 0, int(interlace)))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_codec_equals_pil(tmp_path, channels):
    """Exact: a PNG whose rows use all five filters reads as PIL reads it;
    the port's PNGs read in PIL and PIL's in the port."""
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (23, 17, channels), dtype=np.uint8)
    img[:, :8] //= 3  # smooth runs, so predictions are not all noise
    ref = img[..., 0] if channels == 1 else img
    path = str(tmp_path / "f.png")
    _write_filtered_png(path, img)
    pil = np.asarray(Image.open(path))
    np.testing.assert_array_equal(pil, ref)
    np.testing.assert_array_equal(image_codec.read_png(path), pil)
    image_codec.write_png(path, ref)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), ref)
    Image.fromarray(ref).save(path)
    np.testing.assert_array_equal(image_codec.read_png(path), ref)


@pytest.mark.parametrize("shape", [(23, 17), (3, 2), (1, 1), (9, 33)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("channels", [1, 3, 4], ids=["gray", "rgb", "rgba"])
def test_png_adam7_equals_pil(tmp_path, channels, shape):
    """Exact: an Adam7-interlaced PNG (every filter, empty passes at the
    small sizes) reads as PIL reads it."""
    rng = np.random.default_rng(10 * channels + shape[0])
    img = rng.integers(0, 256, (*shape, channels), dtype=np.uint8)
    img[:, : shape[1] // 2] //= 3
    path = str(tmp_path / "i.png")
    _write_filtered_png(path, img, interlace=True)
    pil = Image.open(path)
    assert pil.info.get("interlace") == 1
    pil = np.asarray(pil)
    np.testing.assert_array_equal(pil, img[..., 0] if channels == 1 else img)
    np.testing.assert_array_equal(image_codec.read_png(path), pil)


def test_jpeg_refuses_the_cpu(tmp_path):
    path = str(tmp_path / "a.jpg")
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(path)
    with pytest.raises(RuntimeError, match="nvJPEG"):
        image_codec.read_jpeg(path, "cpu")
    with pytest.raises(RuntimeError, match="nvJPEG"):
        image_codec.write_jpeg(path, torch.zeros((8, 8, 3), dtype=torch.uint8))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq") / "data")
    mp = pytest.MonkeyPatch()
    mp.setattr(image_codec, "write_jpeg", _pil_write)
    sequence_dataset(root, "small", "cpu")
    mp.undo()
    return root


def test_load_frame_images_and_flows_match_jax(dataset, monkeypatch):
    """Exact, with PIL reading the JPEGs for both packages."""
    monkeypatch.setattr(image_codec, "read_jpeg", _pil_read)
    for frame in (0, 1):
        ji, jd = jds.load_frame_images(dataset, frame, 8)
        ti, td = tds.load_frame_images(dataset, frame, 8, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_array_equal(td.numpy(), jd)
        assert tds.last_load["cameras"] == 8
    cmr_j, cmr_t = jds.load_rgb_cameras(os.path.join(dataset, "rgb_cameras.npz")), \
        tds.load_rgb_cameras(os.path.join(dataset, "rgb_cameras.npz"))
    for k in cmr_j:
        np.testing.assert_array_equal(cmr_t[k], cmr_j[k])
    shape = tuple(cmr_j["shape"][0])
    for a, b in zip(jds.load_frame_flows(dataset, 0, 8, 1, shape), tds.load_frame_flows(dataset, 0, 8, 1, shape)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(y, x)
    jc, tc = jds.cameras_from_npz(cmr_j, 2.0), tds.cameras_from_npz(cmr_t, 2.0, device="cpu")
    for a, b in zip(jc, tc):
        assert (a.width, a.height) == (b.width, b.height)
        np.testing.assert_array_equal(b.view.numpy(), np.asarray(a.view))
        for k in ("fx", "fy", "cx", "cy"):
            assert float(getattr(b, k)) == float(np.asarray(getattr(a, k))), k


def test_cameras_json_and_downscale_match_jax(tmp_path):
    rng = np.random.default_rng(5)
    w2c = np.eye(4)
    w2c[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    w2c[:3, 3] = rng.normal(size=3)
    jc = jcameras.Camera.from_w2c(w2c, 500.0, 510.0, 320.0, 240.0, 640, 480)
    tc = Camera.from_w2c(w2c, 500.0, 510.0, 320.0, 240.0, 640, 480, device="cpu")
    for f in (1.5, 3.0):
        a, b = jc.downscale(f), tc.downscale(f)
        assert (a.width, a.height) == (b.width, b.height)
        for k in ("fx", "fy", "cx", "cy"):
            assert float(np.asarray(getattr(a, k))) == float(getattr(b, k)), k
    jds.save_cameras_json(str(tmp_path / "j.json"), [jc])
    tds.save_cameras_json(str(tmp_path / "t.json"), [tc])
    with open(tmp_path / "j.json") as a, open(tmp_path / "t.json") as b:
        assert json.load(a) == json.load(b)
    (back,) = tds.load_cameras_json(str(tmp_path / "j.json"), device="cpu")
    (jback,) = jds.load_cameras_json(str(tmp_path / "j.json"))
    np.testing.assert_array_equal(back.view.numpy(), np.asarray(jback.view))


def test_metric_logger_matches_jax(tmp_path):
    events = [{"iteration": i, "loss": 1.0 / (i + 1), "rgb_loss": float("nan") if i == 2 else 0.5} for i in range(5)]
    outs = []
    for mod, name in ((jlogging, "j"), (tlogging, "t")):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.MetricLogger(path, run_meta={"frame": 3}) as lg:
            fn = lg.as_log_fn()
            for e in events:
                fn(dict(e))
        cols = mod.to_csv(path, str(tmp_path / f"{name}.csv"))
        with open(tmp_path / f"{name}.csv") as f:
            csv = f.read()
        evs = [{k: v for k, v in e.items() if k != "t"} for e in mod.read_events(path, latest_run_only=True)]
        outs.append((cols, csv, evs, mod.summarize(path)))
    assert outs[0] == outs[1]
