"""The port's RAFT (tools/raft.py) against the JAX package's: the same
parameter names and draws, the flow of raft_forward at 48x64 and 64x96,
reference-layout checkpoints, the zero-weight closed form of
tests/test_raft.py:126, OpenCV's bilinear resize on uint8, and
compute_flow_pair. Flows are held within 1e-4 px + 1e-4 relative: both
packages convolve in float32 in their own summation orders."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.tools import raft as jraft
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.tools import raft as traft
from gaustar_tpu_torch.tools.geometry import resize_linear
from port_helpers import one_thread  # noqa: F401  (autouse)

FLOW_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def params():
    jp = jraft.random_params(seed=0)
    return jp, traft.make_raft(bridge.raft_state_dict_from_numpy(jp, "cpu"), "cpu")


def test_state_dict_keys_and_draws_equal_jax(params):
    """The module's state-dict keys are random_params' keys, shapes equal;
    the port's random_params draws the same values."""
    jp, model = params
    sd = model.state_dict()
    assert set(sd) == set(jp)
    ours = traft.random_params(seed=0)
    for k, v in jp.items():
        assert tuple(sd[k].shape) == v.shape, k
        np.testing.assert_array_equal(ours[k], np.asarray(v), err_msg=k)


@pytest.mark.parametrize("shape,iters", [((48, 64), 2), ((64, 96), 1)])
def test_raft_forward_matches_jax(params, shape, iters):
    """raft_forward on seeded frames, the second a shifted copy of the first."""
    jp, model = params
    rng = np.random.default_rng(1)
    h, w = shape
    img1 = rng.uniform(0, 255, (1, 3, h, w)).astype(np.float32)
    img2 = np.roll(img1, 3, axis=3)
    fj = np.asarray(jraft.raft_forward(jp, jnp.asarray(img1), jnp.asarray(img2), iters=iters))
    ft = traft.raft_forward(model, torch.as_tensor(img1), torch.as_tensor(img2), iters).numpy()
    assert ft.shape == (1, 2, h, w) and np.isfinite(ft).all()
    np.testing.assert_allclose(ft, fj, **FLOW_TOL)
    assert np.abs(fj).max() > 1e-3  # random weights still predict motion


def test_corr_lookup_and_upsampling_match_jax():
    """The correlation pyramid's lookup (with one- and zero-pixel levels)
    and the convex upsampling, on random inputs: within 1e-5."""
    rng = np.random.default_rng(2)
    f1 = rng.normal(size=(1, 16, 6, 8)).astype(np.float32)
    f2 = rng.normal(size=(1, 16, 6, 8)).astype(np.float32)
    coords = (np.stack(np.meshgrid(np.arange(8), np.arange(6)))[None] + rng.normal(0, 2, (1, 2, 6, 8))).astype(np.float32)
    cj = np.asarray(jraft.corr_lookup(jraft.build_corr_pyramid(jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(coords)))
    ct = traft.corr_lookup(traft.build_corr_pyramid(torch.as_tensor(f1), torch.as_tensor(f2)), torch.as_tensor(coords))
    np.testing.assert_allclose(ct.numpy(), cj, rtol=1e-5, atol=1e-5)
    flow = rng.normal(size=(1, 2, 4, 6)).astype(np.float32)
    mask = rng.normal(size=(1, 576, 4, 6)).astype(np.float32)
    np.testing.assert_allclose(traft.upsample_flow_convex(torch.as_tensor(flow), torch.as_tensor(mask)).numpy(),
                               np.asarray(jraft.upsample_flow_convex(jnp.asarray(flow), jnp.asarray(mask))),
                               rtol=1e-5, atol=1e-5)


def _reference_checkpoint(tmp_path, spec):
    """A raft-things.pth-layout file: 'module.' prefixes, BatchNorm
    num_batches_tracked counters and the downsample.1 aliases of norm3
    (tests/test_raft.py:87)."""
    sd = {"module." + k: torch.from_numpy(np.array(v)) for k, v in spec.items()}
    for k in list(sd):
        if k.endswith(".running_var"):
            sd[k.removesuffix(".running_var") + ".num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        if ".norm3." in k:
            sd[k.replace(".norm3.", ".downsample.1.")] = sd[k]
    path = str(tmp_path / "raft-things.pth")
    torch.save(sd, path)
    return path


def test_reference_checkpoint_loads_and_strays_raise(tmp_path):
    """A module.-prefixed checkpoint with num_batches_tracked and the norm3
    aliases loads equal to its spec; an unknown key, a missing key or an
    alias that differs from its norm3 raises."""
    spec = jraft.random_params(seed=3)
    model = traft.load_torch_checkpoint(_reference_checkpoint(tmp_path, spec), "cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(spec[k]), err_msg=k)
    sd = torch.load(str(tmp_path / "raft-things.pth"), weights_only=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        traft.make_raft(traft.clean_state_dict({**sd, "module.extra.weight": torch.zeros(1)}), "cpu")
    with pytest.raises(RuntimeError, match="Missing"):
        traft.make_raft(traft.clean_state_dict({k: v for k, v in sd.items() if "flow_head" not in k}), "cpu")
    alias = next(k for k in sd if ".downsample.1.weight" in k)
    with pytest.raises(ValueError, match="differs"):
        traft.clean_state_dict({**sd, alias: sd[alias] + 1})


def test_zero_weights_give_the_closed_form(tmp_path):
    """tests/test_raft.py:126: all-zero conv weights predict exactly zero
    flow, so the EPE is 0 on a static pair and |t| on a t-pixel shift."""
    spec = {k: np.zeros_like(np.asarray(v)) for k, v in jraft.random_params(seed=3).items()}
    for k in spec:
        if k.endswith("running_var"):
            spec[k] = np.ones_like(spec[k])
    model = traft.load_torch_checkpoint(_reference_checkpoint(tmp_path, spec), "cpu")
    img = (np.random.default_rng(4).uniform(size=(48, 64, 3)) * 255).astype(np.uint8)
    f, b, _ = traft.compute_flow_pair(model, img, img, iters=2, scale=0.5)
    assert f.shape == b.shape == (24, 32, 2)
    assert np.linalg.norm(f, axis=-1).mean() == 0.0 and np.linalg.norm(b, axis=-1).mean() == 0.0
    tx = 6
    fs, _, _ = traft.compute_flow_pair(model, img, np.roll(img, tx, axis=1), iters=2, scale=0.5)
    assert np.linalg.norm(fs - np.array([tx * 0.5, 0.0], np.float32), axis=-1).mean() == np.float32(tx * 0.5)


@pytest.mark.parametrize("src,dst", [((1024, 1600), (512, 800)), ((40, 60), (20, 30)), ((41, 63), (20, 31)),
                                     ((37, 53), (23, 29)), ((100, 100), (77, 61))])
def test_uint8_resize_equals_cv2(src, dst):
    """resize_linear on uint8 is cv2.resize (INTER_LINEAR) exactly, for the
    0.5 ratio RAFT uses and for odd sizes; on float32 within 1e-6."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, src + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(resize_linear(img, *dst), cv2.resize(img, dst[::-1]))
    np.testing.assert_array_equal(resize_linear(img[..., 0], *dst), cv2.resize(img[..., 0], dst[::-1]))
    flt = rng.uniform(size=src + (2,)).astype(np.float32)
    np.testing.assert_allclose(resize_linear(flt, *dst), cv2.resize(flt, dst[::-1]), atol=1e-6)


@pytest.mark.parametrize("dtype", ["uint8", "float32"])
@pytest.mark.parametrize("factor", [1.5, 2.0])
@pytest.mark.parametrize("src", [(17, 23), (16, 24)], ids=["odd", "even"])
def test_resize_upscale_equals_cv2(src, factor, dtype):
    """Upscales (compute_flow_pair with scale > 1): resize_linear equals
    cv2.resize (INTER_LINEAR) exactly, the first and last rows included,
    where OpenCV's vertical pass blends the clamped edge row with itself.
    Float images are held to OpenCV's own code with Intel IPP off: with it
    on, OpenCV hands float32 images of 1, 3 or 4 channels to IPP, whose sums
    round otherwise."""
    rng = np.random.default_rng(int(10 * factor) + src[0])
    dst = (int(round(src[0] * factor)), int(round(src[1] * factor)))
    use_ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for ch in (1, 2, 3):
            if dtype == "uint8":
                img = rng.integers(0, 256, src + (ch,)).astype(np.uint8)
            else:
                img = rng.uniform(-1.0, 1.0, src + (ch,)).astype(np.float32)
            img = img[..., 0] if ch == 1 else img
            ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
            np.testing.assert_array_equal(resize_linear(img, *dst), ref, err_msg=f"{ch} channels")
    finally:
        cv2.ipp.setUseIPP(use_ipp)


def test_compute_flow_pair_matches_jax(params):
    """compute_flow_pair on a 42x66 uint8 pair (scale 0.5 -> 21x33, padded
    to 24x40 and cropped back): both directions and the padding."""
    jp, model = params
    rng = np.random.default_rng(6)
    img1 = (rng.uniform(size=(42, 66, 3)) * 255).astype(np.uint8)
    img2 = np.roll(img1, 4, axis=1)
    fj, bj, pj = jraft.compute_flow_pair(jp, img1, img2, iters=2, scale=0.5)
    ft, bt, pt = traft.compute_flow_pair(model, img1, img2, iters=2, scale=0.5)
    assert pt == pj and ft.shape == fj.shape == (21, 33, 2)
    np.testing.assert_allclose(ft, fj, **FLOW_TOL)
    np.testing.assert_allclose(bt, bj, **FLOW_TOL)


def test_make_raft_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        traft.make_raft(traft.random_params())
