"""The port's evaluation against the JAX package: ops/losses.py's image
losses and metrics, eval/metrics.py's PSNR / SSIM / margin PSNR,
lpips_convert and LPIPSVgg on synthetic checkpoints
(utils/synthetic.lpips_checkpoints, the draws of tests/test_lpips.py:22-46;
scores equal at 1e-6), files packed
by either package loaded by the other, evaluate_pairs, and evaluate_dirs
over PNGs the port wrote. No real LPIPS weights exist here, so every LPIPS
number is of seeded synthetic weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.eval import lpips_convert as jconvert
from gaustar_tpu.eval import metrics as jmetrics
from gaustar_tpu.ops import losses as jlosses
from gaustar_tpu_torch.eval import lpips_convert as tconvert
from gaustar_tpu_torch.eval import metrics as tmetrics
from gaustar_tpu_torch.io.image_codec import write_png
from gaustar_tpu_torch.ops import losses as tlosses
from gaustar_tpu_torch.utils.synthetic import lpips_checkpoints
from port_helpers import one_thread  # noqa: F401  (autouse)

def _pair(seed, shape=(40, 56, 3), noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=noise, size=shape), 0, 1).astype(np.float32)
    return a, b


def test_image_losses_match_jax():
    """l2, SSIM (map and mean), rgb_loss and PSNR on [H, W, C] images:
    rtol 1e-5 (float32 sums in another order)."""
    a, b = _pair(0)
    ta, tb, ja, jb = torch.as_tensor(a), torch.as_tensor(b), jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(tlosses.ssim_map(ta, tb).numpy(), np.asarray(jlosses.ssim_map(ja, jb)),
                               rtol=1e-5, atol=1e-6)
    for name in ("l2_loss", "ssim", "rgb_loss", "psnr"):
        np.testing.assert_allclose(float(getattr(tlosses, name)(ta, tb)), float(getattr(jlosses, name)(ja, jb)),
                                   rtol=1e-5, err_msg=name)


def test_metrics_match_jax():
    for seed, noise in ((1, 0.02), (2, 0.3)):
        a, b = _pair(seed, shape=(120, 130, 3), noise=noise)
        for name in ("psnr", "ssim", "margin_psnr"):
            np.testing.assert_allclose(getattr(tmetrics, name)(a, b, device="cpu"), getattr(jmetrics, name)(a, b),
                                       rtol=1e-5, err_msg=name)
        assert tmetrics.psnr(torch.as_tensor(a), torch.as_tensor(b), device="cpu") == tmetrics.psnr(a, b, device="cpu")


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lpips")
    vgg_path, lpips_path = lpips_checkpoints(str(tmp))
    tout, jout = str(tmp / "port.pt"), str(tmp / "jax.pt")
    tblob = tconvert.convert(vgg_path, lpips_path, tout)
    jblob = jconvert.convert(vgg_path, lpips_path, jout)
    return dict(tmp=tmp, vgg=vgg_path, lpips=lpips_path, port=tout, jax=jout, tblob=tblob, jblob=jblob)


def test_convert_matches_jax(packed):
    tblob, jblob = packed["tblob"], packed["jblob"]
    assert set(tblob) == set(jblob) and "classifier.0.weight" not in tblob
    assert [w.numel() for w in tblob["lins"]] == tconvert.LIN_CHANNELS
    for k in tblob:
        if k == "lins":
            for a, b in zip(tblob[k], jblob[k]):
                assert torch.equal(a, b)
        else:
            assert torch.equal(tblob[k], jblob[k])


def test_convert_bare_features_trunk(packed):
    full = torch.load(packed["vgg"])
    bare = {k.removeprefix("features."): v for k, v in full.items() if k.startswith("features.")}
    bare_path = str(packed["tmp"] / "bare.pth")
    torch.save(bare, bare_path)
    out = str(packed["tmp"] / "bare_packed.pt")
    tconvert.convert(bare_path, packed["lpips"], out)
    tmetrics.LPIPSVgg(out, device="cpu")


def test_convert_rejects_a_wrong_linear_layer(packed):
    bad = {f"lin{i}.model.1.weight": torch.ones(1, 7, 1, 1) for i in range(5)}
    path = str(packed["tmp"] / "bad.pth")
    torch.save(bad, path)
    with pytest.raises(ValueError, match="lin0"):
        tconvert.convert(packed["vgg"], path, str(packed["tmp"] / "bad_out.pt"))


@pytest.mark.parametrize("weights", ["port", "jax"], ids=["packed_by_port", "packed_by_jax"])
def test_lpips_matches_jax(packed, weights):
    """Scores equal to the JAX package's LPIPSVgg within 1e-6, with either
    package's packed file; a distance: 0 on equal images, symmetric."""
    scorer = tmetrics.LPIPSVgg(packed[weights], device="cpu")
    jscorer = jmetrics.LPIPSVgg(packed["jax" if weights == "port" else "port"])
    assert isinstance(scorer, torch.nn.Module) and scorer.lins.dtype == torch.float32
    a, b = _pair(3, shape=(64, 64, 3), noise=0.3)
    d = float(scorer(a, b))
    np.testing.assert_allclose(d, jscorer(a, b), rtol=0, atol=1e-6)
    assert d > 1e-4
    assert float(scorer(a, a)) == pytest.approx(0.0, abs=1e-6)
    assert float(scorer(b, a)) == pytest.approx(d, rel=1e-5)
    assert float(scorer(torch.as_tensor(a), torch.as_tensor(b))) == d


def test_evaluate_pairs_matches_jax(packed):
    scorer = tmetrics.LPIPSVgg(packed["port"], device="cpu")
    jscorer = jmetrics.LPIPSVgg(packed["port"])
    pairs = [_pair(s, shape=(48, 48, 3), noise=0.05) for s in (4, 5)]
    renders, gts = [p[0] for p in pairs], [p[1] for p in pairs]
    got = tmetrics.evaluate_pairs(renders, gts, lpips_fn=scorer, device="cpu")
    ref = jmetrics.evaluate_pairs(renders, gts, lpips_fn=jscorer)
    assert set(got) == set(ref) == {"PSNR", "SSIM", "LPIPS"}
    for k in ("PSNR", "SSIM"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["LPIPS"], ref["LPIPS"], rtol=0, atol=1e-6)


def test_evaluate_dirs_matches_jax(packed, tmp_path):
    """PNGs written by the port (8-bit, names sorted, one render without a
    GT, which both skip): the JAX package's PIL reader and the port's codec
    give the same metrics, and the json file holds them."""
    rdir, gdir = tmp_path / "renders", tmp_path / "gt"
    rdir.mkdir()
    gdir.mkdir()
    for i, seed in enumerate((6, 7, 8)):
        a, b = _pair(seed, shape=(40, 52, 3), noise=0.08)
        write_png(str(rdir / f"{i:05d}.png"), (a * 255).round().astype(np.uint8))
        if i < 2:
            write_png(str(gdir / f"{i:05d}.png"), (b * 255).round().astype(np.uint8))
    out = str(tmp_path / "res.json")
    got = tmetrics.evaluate_dirs(str(rdir), str(gdir), lpips_weights=packed["port"], out_json=out, device="cpu")
    ref = jmetrics.evaluate_dirs(str(rdir), str(gdir), lpips_weights=packed["port"])
    for k in ("PSNR", "SSIM"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["LPIPS"], ref["LPIPS"], rtol=0, atol=1e-6)
    import json

    with open(out) as f:
        assert json.load(f) == got


def test_missing_weights_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        tmetrics.LPIPSVgg(None, device="cpu")
    with pytest.raises(FileNotFoundError):
        tmetrics.LPIPSVgg(str(tmp_path / "absent.pt"), device="cpu")


def test_lpips_defaults_to_the_card(packed):
    """With no device given the scorer goes to the card, and without one it
    raises rather than run on the CPU."""
    if torch.cuda.is_available():
        assert tmetrics.LPIPSVgg(packed["port"]).lins.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmetrics.LPIPSVgg(packed["port"])


@pytest.mark.parametrize("name", ["psnr", "ssim", "margin_psnr", "evaluate_pairs"])
def test_metrics_default_to_the_card(name):
    """Given arrays and no device, the metrics score on the card, and
    without one they raise rather than run on the CPU."""
    a, b = _pair(9, shape=(120, 120, 3))
    fn = getattr(tmetrics, name)
    args = ([a], [b]) if name == "evaluate_pairs" else (a, b)
    if torch.cuda.is_available():
        assert np.isfinite(fn(*args) if name != "evaluate_pairs" else fn(*args)["PSNR"])
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(*args)
