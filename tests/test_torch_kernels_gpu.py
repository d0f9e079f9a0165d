"""The port's CUDA blend kernels on the card: against their plain PyTorch
versions, through the golden fixtures, in the refine step and in the
topology event's forward-only renders (detection, fusion); then the
sequence's I/O on the card's machine: the nvJPEG codec, the PNG codec and
the native mesh library. Every test needs a CUDA card and skips without one.
JAX is not imported, so the file runs on a machine without it:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py -q
"""

import glob
import os

import numpy as np
import pytest
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops import binning
from gaustar_tpu_torch.ops import blend_cuda as bc
from gaustar_tpu_torch.ops.projection import TILE, preprocess, quat_scale_to_cov3d
from gaustar_tpu_torch.ops.rasterizer import rasterize
from gaustar_tpu_torch.train import refine
from gaustar_tpu_torch.utils.synthetic import synthetic_frame

pytestmark = pytest.mark.gpu

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz")))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blend kernels and nvJPEG have no CPU mode")
    return torch.device("cuda")


def _blend_inputs(device, channels, n=3000, size=64, seed=3):
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(scale=0.4, size=(n, 2)), 4.0 + rng.uniform(0, 2, (n, 1))], 1)
    scales = np.exp(rng.normal(-3.0, 0.4, (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = 1 / (1 + np.exp(-rng.normal(size=n)))
    opac[: n // 4] = 0.995  # opaque front: sticky stops and the 0.99 clamp
    feats = rng.uniform(size=(n, channels))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    cam = Camera.from_w2c(np.eye(4), 1.2 * size, 1.2 * size, size / 2, size / 2, size, size - 8, device=device)
    g = preprocess(t(means), quat_scale_to_cov3d(t(scales), t(quats)), t(opac), t(feats), cam)
    grid_x = (cam.width + TILE - 1) // TILE
    grid_y = (cam.height + TILE - 1) // TILE
    b = binning.bin_gaussians(g, grid_x, grid_y)
    pd = binning.gather_pair_data(g, b).contiguous()
    return pd, b.tile_start, b.tile_count, grid_x, cam.width, cam.height


@pytest.mark.parametrize("channels", [3, 4])
def test_kernels_match_plain_versions(cuda, channels):
    args = (*_blend_inputs(cuda, channels), channels)
    raw_k, split = bc.blend_fwd_split(*args)
    raw_p = bc.blend_fwd_plain(*args)
    assert (raw_p[:, 4] > 0).any() and (raw_p[:, 5] > 0).any()
    # -fmad=false: the kernel rounds each step as the plain version does, so
    # the discrete decisions agree exactly; 1e-4 leaves room for expf's last bit.
    torch.testing.assert_close(raw_k[:, [0, 1, 2, 3, 6]], raw_p[:, [0, 1, 2, 3, 6]], rtol=0, atol=1e-4)
    assert torch.equal(raw_k[:, 4], raw_p[:, 4]) and torch.equal(raw_k[:, 5], raw_p[:, 5])

    gen = torch.Generator(device=cuda).manual_seed(7)
    ct = torch.zeros_like(raw_p)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = torch.randn(ct[:, row].shape, generator=gen, device=cuda)
    g_k = bc.blend_bwd_cuda(*args, raw_p, ct, split)
    g_p = bc.blend_bwd_plain(*args, raw_p, ct)
    # per-slot sums over 256 pixels, taken in another order (warp shuffles)
    for row in range(6 + channels):
        atol = 1e-3 * float(g_p[row].abs().max())
        torch.testing.assert_close(g_k[row], g_p[row], rtol=1e-3, atol=atol)


S = bc.SEG
# Tile lists of the split cases, a 4 x 2 tile grid whose bottom row is cut
# by the image's lower edge (pixels outside): one list of many segments,
# lengths S - 1, S and S + 1, two empty tiles, and two lists with an opaque
# stopper at the last pair of segment 0 and at the first pair of segment 1.
SPLIT_COUNTS = [4000, S - 1, S, S + 1, 0, 2 * S + 10, 2 * S + 10, 0]
STOP_AT = {5: S - 1, 6: S}  # tile -> list index of the stopper
OPACITY = {0: (0.002, 0.012), 5: (0.01, 0.05), 6: (0.01, 0.05)}  # faint: long walks, T high at the stoppers
SPLIT_W, SPLIT_H = 64, 27


def _split_case(device, channels, seed=0):
    """(pair_data, tile_start, tile_count, grid_x, W, H) of hand-made tile
    lists: random gaussians around each tile; before each stopper two
    broad primers of opacity 0.9 bring T to about 1% so that a broad pair of
    opacity 0.995 stops most pixels at its list index."""
    rng = np.random.default_rng(seed)
    grid_x = SPLIT_W // 16
    fields = []
    for t, n in enumerate(SPLIT_COUNTS):
        ox, oy = 16 * (t % grid_x), 16 * (t // grid_x)
        sx, sy = rng.uniform(1.5, 8, n), rng.uniform(1.5, 8, n)
        a, c = 1 / sx**2, 1 / sy**2
        f = np.stack([ox + rng.uniform(-4, 20, n), oy + rng.uniform(-4, 20, n), a,
                      rng.uniform(-0.5, 0.5, n) * np.sqrt(a * c), c,
                      rng.uniform(*OPACITY.get(t, (0.01, 0.3)), n)]
                     + [rng.uniform(size=n) for _ in range(channels)])
        if t in STOP_AT:
            k = STOP_AT[t]
            f[:, k - 2:k + 1] = np.array([[ox + 7.5, oy + 7.5, 1e-4, 0.0, 1e-4, op] + [0.5] * channels
                                          for op in (0.9, 0.9, 0.995)]).T
        fields.append(f)
    pd = torch.as_tensor(np.concatenate(fields, 1).astype(np.float32), device=device).contiguous()
    count = torch.tensor(SPLIT_COUNTS, dtype=torch.int32, device=device)
    start = (torch.cumsum(count, 0) - count).to(torch.int32)
    return pd, start, count, grid_x, SPLIT_W, SPLIT_H


@pytest.mark.parametrize("channels", [3, 4])
def test_split_kernels_on_segment_edges(cuda, channels):
    args = (*_split_case(cuda, channels), channels)
    raw_p = bc.blend_fwd_plain(*args)
    for t, k in STOP_AT.items():  # the case stops pixels where it means to
        assert int(((raw_p[t, 5] == 1) & (raw_p[t, 4] == k)).sum()) > 0
    assert int(raw_p[0, 4].max()) > 8 * S and (raw_p[4:, 5] == 1).any()
    raw_k, split = bc.blend_fwd_split(*args)
    # The chain repeats the plain walk's operations on each composited pair.
    assert torch.equal(raw_k[:, :7], raw_p[:, :7])

    gen = torch.Generator(device=cuda).manual_seed(5)
    ct = torch.zeros_like(raw_p)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = torch.randn(ct[:, row].shape, generator=gen, device=cuda)
    g_p = bc.blend_bwd_plain(*args, raw_p, ct)
    g_k = bc.blend_bwd_cuda(*args, raw_p, ct, split)
    for row in range(6 + channels):
        atol = 1e-3 * float(g_p[row].abs().max())
        torch.testing.assert_close(g_k[row], g_p[row], rtol=1e-3, atol=atol)


def test_blend_raw_launches_each_kernel_once(cuda):
    pd, start, count, gx, w, h = _blend_inputs(cuda, 4)
    pd = pd.clone().requires_grad_()
    bc.reset_launch_counts()
    bc.blend_raw(pd, start, count, gx, w, h, 4)[:, 0].sum().backward()
    assert bc.LAUNCHES == {"blend_fwd": 1, "blend_bwd": 1}
    assert torch.isfinite(pd.grad).all()


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)[:-4] for p in GOLDEN])
def test_golden_fixture_through_kernels(cuda, path):
    z = np.load(path)
    cam = Camera.from_w2c(z["w2c"], float(z["fx"]), float(z["fy"]), float(z["cx"]), float(z["cy"]),
                          int(z["width"]), int(z["height"]), device=cuda)
    leaves = [torch.tensor(z[k], device=cuda, requires_grad=True)
              for k in ("means3d", "scales", "quats", "opacities", "colors")]
    m, s, q, o, c = leaves
    img, aux = rasterize(m, quat_scale_to_cov3d(s, q), o, c, cam, bg=tuple(z["bg"]))
    probe, probe_t = (torch.as_tensor(z[k], device=cuda) for k in ("probe", "probe_t"))
    ((img * probe).sum() + (aux.final_T * probe_t).sum()).backward()
    # tolerances of tests/test_golden.py
    np.testing.assert_allclose(img.detach().cpu().numpy(), z["image"], atol=3e-5)
    np.testing.assert_allclose(aux.final_T.detach().cpu().numpy(), z["final_T"], atol=3e-5)
    np.testing.assert_array_equal(aux.n_contrib.cpu().numpy(), z["n_contrib"])
    for key, leaf in zip(("g_means3d", "g_scales", "g_quats", "g_opacities", "g_colors"), leaves):
        ref = z[key]
        np.testing.assert_allclose(leaf.grad.cpu().numpy(), ref, rtol=2e-3,
                                   atol=max(2e-4, 1e-2 * float(np.abs(ref).max())), err_msg=key)


def test_refine_step_on_card_matches_cpu(cuda):
    cfg = refine.RefineConfig(num_iterations=4, loose_bind_from=10**9)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p, c, d, _, rc = synthetic_frame(device=dev)
        loss, _ = refine.compute_losses(p, c, d, 1, 1, cfg, rc, 2)
        grads = torch.autograd.grad(loss, [p.points, p.scales, p.sh_dc])
        out[dev.type] = (float(loss.detach()), [g.cpu() for g in grads])
    (l_g, g_g), (l_c, g_c) = out["cuda"], out["cpu"]
    assert abs(l_g - l_c) <= 1e-4 * abs(l_c)
    for a, b in zip(g_g, g_c):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-3 * float(b.abs().max()))


def _topo_inputs(dev):
    """A small scene for the topology event's forward-only renders: the
    target of synthetic_frame (6 cameras, 48x48, 1,920 gaussians) at
    opacity 0.999, its GT depth shifted in one half so that faces flag."""
    from gaustar_tpu_torch.mesh.topology import build_topology

    _, config, data, target, rc = synthetic_frame(n_cams=6, subdiv=2, target_opacity=0.999, device=dev)
    gt = data.gt_depths.clone()
    gt[:, :, :24] = torch.where(gt[:, :, :24] < 10, gt[:, :, :24] - 0.3, gt[:, :, :24])
    topo = build_topology(config.faces.cpu().numpy(), target.points.shape[0])
    return target, config, data, gt, topo, rc


def test_detect_topo_err_on_card_matches_cpu(cuda):
    from gaustar_tpu_torch.ops import blend_cuda
    from gaustar_tpu_torch.train import topo_detect

    cfg = topo_detect.TopoDetectConfig(min_observe=2, mesh_prop=5, detect_floor=False, depth_agreement=0.1,
                                       edge_threshold=0.6)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        target, config, data, gt, topo, rc = _topo_inputs(dev)
        blend_cuda.reset_launch_counts()
        out[dev.type] = topo_detect.detect_topo_err(target, config, data.cameras, gt, topo, rc, cfg)
        if dev.type == "cuda":
            assert blend_cuda.LAUNCHES == {"blend_fwd": 2 * 6, "blend_bwd": 0}  # two renders per camera
    w_g, w_c = out["cuda"], out["cpu"]
    # the CPU test's tolerances (tests/test_torch_topo_detect.py)
    assert (np.abs(w_g - w_c) <= 1e-4).mean() >= 0.995
    assert ((w_g >= 0.6) != (w_c >= 0.6)).mean() <= 0.005
    assert (w_c >= 0.6).mean() > 0.05  # the shifted half flags


def test_render_rgbd_for_fusion_on_card_matches_cpu(cuda):
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.train import mesh_update

    out = {}
    for dev in (cuda, torch.device("cpu")):
        target, config, data, _, _, rc = _topo_inputs(dev)
        with torch.no_grad():
            out[dev.type] = [t.cpu() for t in mesh_update.render_rgbd_for_fusion(
                target, config, index_camera(data.cameras, 1), rc)]
    (rgb_g, d_g), (rgb_c, d_c) = out["cuda"], out["cpu"]
    torch.testing.assert_close(rgb_g, rgb_c, rtol=0, atol=1e-4)
    kept = (d_g > 0) & (d_c > 0)
    assert ((d_g > 0) == (d_c > 0)).float().mean() >= 0.995 and kept.float().mean() > 0.03
    torch.testing.assert_close(d_g[kept], d_c[kept], rtol=0, atol=1e-4)


def _smooth_image(seed, h=1024, w=1600):
    """A seeded uint8 RGB image [h, w, 3] of low-frequency sinusoids, each
    channel about its own level (0.25, 0.5, 0.75), so a channel swap shows."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.empty((h, w, 3))
    for c in range(3):
        img[..., c] = 0.25 * (c + 1)
        for _ in range(4):
            fy, fx = rng.uniform(0.5, 6.0, 2) * 2 * np.pi / np.array([h, w])
            img[..., c] += rng.uniform(0.02, 0.06) * np.sin(fy * yy + fx * xx + rng.uniform(0, 2 * np.pi))
    return np.clip(np.rint(255 * img), 0, 255).astype(np.uint8)


def test_nvjpeg_round_trip(cuda, tmp_path):
    """Encode at quality 95 and decode through nvJPEG: PSNR >= 40 dB, the
    source's size, and the source's channel order: each decoded channel's
    mean is nearest its own source channel's (they sit 64 levels apart) and
    within 4 levels of it (the encoder's colour conversion shifts the means
    by up to about 2 levels on this image)."""
    from gaustar_tpu_torch.io import image_codec

    src = torch.as_tensor(_smooth_image(0), device=cuda)
    path = str(tmp_path / "img.jpg")
    image_codec.write_jpeg(path, src, quality=95)
    out = image_codec.read_jpeg(path, cuda)
    assert out.device.type == "cuda" and out.dtype == torch.uint8 and out.shape == src.shape
    mse = float(((out.double() - src.double()) ** 2).mean())
    psnr = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    m_out, m_src = out.double().mean(dim=(0, 1)).cpu().numpy(), src.double().mean(dim=(0, 1)).cpu().numpy()
    print(f"nvJPEG q95 1600x1024: {os.path.getsize(path)} bytes, PSNR {psnr:.2f} dB, channel mean shifts "
          f"{(m_out - m_src).tolist()}")
    assert psnr >= 40.0
    assert np.abs(m_out[:, None] - m_src[None, :]).argmin(axis=1).tolist() == [0, 1, 2]
    assert np.abs(m_out - m_src).max() < 4.0


def test_nvjpeg_decode_against_pil(cuda, tmp_path):
    """Where PIL is installed: nvJPEG and libjpeg decode the same bitstream
    within a few levels per pixel (their IDCTs and chroma paths differ)."""
    image = pytest.importorskip("PIL.Image")
    from gaustar_tpu_torch.io import image_codec

    src = _smooth_image(1)
    for label, write in (("nvJPEG-encoded", lambda p: image_codec.write_jpeg(p, torch.as_tensor(src, device=cuda))),
                         ("PIL-encoded", lambda p: image.fromarray(src).save(p, quality=95))):
        path = str(tmp_path / f"{label}.jpg")
        write(path)
        ours = image_codec.read_jpeg(path, cuda).cpu().numpy().astype(np.int64)
        pil = np.asarray(image.open(path).convert("RGB"), np.int64)
        d = np.abs(ours - pil)
        print(f"{label}: nvJPEG vs PIL decode max {d.max()} mean {d.mean():.4f} levels, "
              f"differing {(d > 0).mean():.4f} of values")
        assert ours.shape == pil.shape and d.max() <= 8 and d.mean() <= 1.5


def test_png_round_trip_exact(cuda, tmp_path):
    from gaustar_tpu_torch.io import image_codec

    rng = np.random.default_rng(2)
    for shape in ((1024, 1600), (1024, 1600, 3), (64, 80, 4)):
        src = torch.as_tensor(rng.integers(0, 256, size=shape, dtype=np.uint8), device=cuda)
        path = str(tmp_path / f"img{len(shape)}.png")
        image_codec.write_png(path, src)
        np.testing.assert_array_equal(image_codec.read_png(path), src.cpu().numpy())


def test_native_decimates_a_sphere(cuda):
    """The native library builds with g++ on this machine and decimates a
    seeded bumpy sphere (81,920 faces) to 5,000 faces that stay on it."""
    from gaustar_tpu_torch import native
    from gaustar_tpu_torch.mesh.primitives import icosphere

    verts, faces = icosphere(6, radius=0.5)
    rng = np.random.default_rng(3)
    verts = verts * (1 + rng.normal(scale=1e-3, size=(len(verts), 1)))
    dv, df = native.decimate(verts, faces, 5000)
    sv = native.laplacian_smooth(dv, df, iterations=10)
    r = np.linalg.norm(dv, axis=1)
    assert 0.9 * 5000 <= len(df) <= 5000 and np.isfinite(dv).all() and np.isfinite(sv).all()
    assert np.abs(np.median(r) - 0.5) < 2e-3 and df.min() >= 0 and df.max() < len(dv)


def test_knn_on_card_matches_cpu_with_tf32_on(cuda):
    """The KNN sums its product without a matmul, so TF32 switched on
    globally changes nothing: card and CPU within 1e-6 (a few ulps of the
    centred |q|^2)."""
    from gaustar_tpu_torch.ops import knn

    rng = np.random.default_rng(0)
    pts = (rng.normal(scale=0.3, size=(3000, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = knn.knn_sq_dists(torch.as_tensor(pts, device=cuda)).cpu().numpy()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag
    np.testing.assert_allclose(got, knn.knn_sq_dists(torch.as_tensor(pts)).numpy(), rtol=0, atol=1e-6)


def test_lpips_on_card_matches_cpu_with_tf32_on(cuda, tmp_path):
    """LPIPSVgg pins its convolutions to float32: with cuDNN's TF32 switch
    on, the card's score of seeded synthetic weights equals the CPU's within
    1e-5 relative (TF32 would move it by about 1e-3)."""
    from gaustar_tpu_torch.eval import lpips_convert
    from gaustar_tpu_torch.eval.metrics import LPIPSVgg
    from gaustar_tpu_torch.utils.synthetic import lpips_checkpoints

    packed = str(tmp_path / "packed.pt")
    lpips_convert.convert(*lpips_checkpoints(str(tmp_path)), packed)
    rng = np.random.default_rng(1)
    a = rng.uniform(size=(128, 160, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(scale=0.2, size=a.shape), 0, 1).astype(np.float32)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        card = float(LPIPSVgg(packed, device=cuda)(a, b))
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    cpu = float(LPIPSVgg(packed, device="cpu")(a, b))
    assert card == pytest.approx(cpu, rel=1e-5)


def test_train_gaussians_on_card_matches_cpu(cuda):
    """Ten vanilla 3DGS iterations with one densify event on the card and
    on the CPU (plain blend): the event's counts equal, two blend launches
    per iteration, the parameters within 2 x sum(lr) (Adam with eps 1e-15
    turns float noise in a near-zero gradient into a step of about lr) and
    each group's mean difference within 1e-2 x sum(lr)."""
    from gaustar_tpu_torch.models import gaussians
    from gaustar_tpu_torch.train import train_gaussians as tg
    from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_gs_lr_fn

    cfg = tg.GSTrainConfig(iterations=10, densify_from_iter=5, densify_until_iter=10, densification_interval=10,
                           bg_color=(0.0, 1.0, 0.0), sh_warmup_every=5)
    pts, cols = _gs_cloud()
    out = {}
    for dev in ("cpu", "cuda"):
        _, _, data, _, _ = synthetic_frame(device=dev)
        p = gaussians.create_from_pcd(pts, cols, device=dev)
        events = []
        bc.reset_launch_counts()
        params, _ = tg.train_gaussians(p, data.cameras, data.gt_images, cfg, log_fn=events.append)
        out[dev] = (params, events, dict(bc.LAUNCHES))
    (pc, ec, _), (pg, eg, launches) = out["cpu"], out["cuda"]
    assert eg == ec and [e["iteration"] for e in eg] == [9]
    assert launches == {"blend_fwd": 10, "blend_bwd": 10}
    lr_fn = make_gs_lr_fn(OptimizationParams(iterations=10), 1.0)
    for name, t in pg.named():
        lr_sum = sum(lr_fn(c)[name] for c in range(10))
        diff = (t.detach().cpu() - getattr(pc, name).detach()).abs()
        assert float(diff.max()) <= 2 * lr_sum * (1 + 1e-5), name
        assert float(diff.mean()) <= 1e-2 * lr_sum, name


def _gs_cloud():
    rng = np.random.default_rng(2)
    pts = rng.normal(scale=0.4, size=(300, 3)).astype(np.float32) + np.array([0, 0, 4], np.float32)
    return pts, rng.uniform(size=(300, 3)).astype(np.float32)


@pytest.mark.parametrize("sh_deg", [0, 1, 2], ids=["deg0", "deg1", "deg2"])
def test_grad_step_on_card_matches_cpu(cuda, sh_deg):
    """One vanilla 3DGS step from seeded SH bands, opacities, scales and
    unnormalised rotations, through the blend kernels and through their
    plain versions, on every camera: the loss within 2e-6 relative, the
    radii exact, every gradient element (six groups and means2d) within
    1e-4 of its group's largest |gradient|, as the CPU test against the JAX
    package holds them."""
    from gaustar_tpu_torch import bridge
    from gaustar_tpu_torch.cameras import index_camera
    from gaustar_tpu_torch.models import gaussians
    from gaustar_tpu_torch.train import train_gaussians as tg
    from port_helpers import perturbed_gaussians

    cfg = tg.GSTrainConfig(bg_color=(0.0, 1.0, 0.0))
    fields = perturbed_gaussians({k: v.numpy() for k, v in gaussians.create_from_pcd(*_gs_cloud(), device="cpu")
                                  .named()}, seed=8)
    runs = {}
    for dev in ("cpu", "cuda"):
        _, _, data, _, _ = synthetic_frame(device=dev)
        p = tg._leaves(bridge.gaussian_params_from_numpy(fields, dev))
        bc.reset_launch_counts()
        runs[dev] = [tg._grad_step(p, index_camera(data.cameras, c), data.gt_images[c], sh_deg, cfg,
                                   tg.RasterConfig()) for c in range(data.gt_images.shape[0])]
        launches = dict(bc.LAUNCHES)
    assert launches == {"blend_fwd": len(runs["cuda"]), "blend_bwd": len(runs["cuda"])}
    for c, ((lc, gc, dc, rc), (lg, gg, dg, rg)) in enumerate(zip(runs["cpu"], runs["cuda"])):
        np.testing.assert_allclose(float(lg), float(lc), rtol=2e-6)
        np.testing.assert_array_equal(rg.cpu().numpy(), rc.numpy())
        for name, got, ref in [(k, gg[k].cpu().numpy(), gc[k].numpy()) for k in gc] + [
                ("means2d", dg.cpu().numpy(), dc.numpy())]:
            scale = np.abs(ref).max()
            if name == "features_rest" and sh_deg == 0:
                assert scale == 0 and not got.any()
                continue
            assert scale > 0, name
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale, err_msg=f"camera {c} {name}")