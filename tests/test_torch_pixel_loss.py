"""The pixel-loss Function (ops/pixel_loss.py) on the CPU: its plain forward
and analytic backward against autograd through the formula the port used
before it (refine.py's masked_rgb_loss_cm and depth and mask terms), in
float64; and the port's refine.pixel_losses against the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import Camera as JCamera
from gaustar_tpu.cameras import stack_cameras as jstack_cameras
from gaustar_tpu.train import refine as jrefine
from gaustar_tpu_torch.ops import pixel_loss
from gaustar_tpu_torch.train import refine as trefine
from pixel_loss_frames import former_means

MAX_DEPTH = 10.0


def _inputs(h, w, seed, dtype=np.float64, ties=True):
    """(img [3, H, W], depth [H, W], gt [H, W, 3], gt_depth [H, W]) with
    foreground, background and gt exactly at max_depth; with `ties`, also
    pixels where pred equals gt and background rendered exactly at
    max_depth (|x| at 0)."""
    rng = np.random.default_rng(seed)
    img = rng.uniform(0.0, 1.0, (3, h, w))
    gt = rng.uniform(0.0, 1.0, (h, w, 3))
    same = rng.uniform(size=(h, w)) < (0.2 if ties else 0.0)
    gt[same] = img.transpose(1, 2, 0)[same]
    gt_depth = np.where(rng.uniform(size=(h, w)) < 0.6, rng.uniform(3.0, 5.0, (h, w)), 10.5)
    gt_depth[rng.uniform(size=(h, w)) < 0.1] = MAX_DEPTH
    depth = gt_depth + rng.normal(scale=0.3, size=(h, w))
    depth[rng.uniform(size=(h, w)) < (0.1 if ties else 0.0)] = MAX_DEPTH
    hit = rng.uniform(size=(h, w)) < (0.1 if ties else 0.0)
    depth[hit] = gt_depth[hit]
    return tuple(np.ascontiguousarray(a, dtype) for a in (img, depth, gt, gt_depth))


CASES = {
    "margins_all_sides": (40, 52, (3, 5, 2, 4)),
    "no_margin": (36, 44, None),
    "shorter_than_window": (7, 30, (1, 2, 1, 1)),
    "narrower_than_window": (26, 9, (2, 1, 3, 2)),
    "margins_cover_all": (20, 24, (14, 12, 0, 0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_function_matches_former_autograd(case):
    h, w, margin = CASES[case]
    img, depth, gt, gt_depth = (torch.tensor(a) for a in _inputs(h, w, seed=len(case)))
    margin_t = None if margin is None else torch.tensor(margin, dtype=torch.int64)
    img.requires_grad_()
    depth.requires_grad_()
    got = pixel_loss.pixel_loss_means(img, depth, gt, gt_depth, margin_t, MAX_DEPTH)
    want = former_means(img, depth, gt, gt_depth, margin_t, MAX_DEPTH)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)
    g = torch.tensor([0.8, -0.2, 0.1, 1.0], dtype=torch.float64)
    got_grads = torch.autograd.grad(got, (img, depth), g)
    want_grads = torch.autograd.grad(want, (img, depth), g)
    for a, b in zip(got_grads, want_grads):
        # the analytic backward sums the window's terms in another order
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12 * float(b.abs().max()) + 1e-300)
    if margin is not None and case != "margins_cover_all":
        d_img = got_grads[0]
        assert (d_img[:, :, : margin[0]] == 0).all() and (d_img[:, : margin[2]] == 0).all()
        assert (d_img.abs().sum(0) > 0).any()


def _frames(h, w, seed):
    # no ties: JAX's |x| has the gradient +1 at 0, where torch.abs has 0
    img, depth, gt, gt_depth = _inputs(h, w, seed, np.float32, ties=False)
    margins = np.array([[3, 1, 2, 4], [1, 1, 1, 1]], np.int32)
    gts, gt_depths = np.stack([gt[::-1], gt]), np.stack([gt_depth[::-1], gt_depth])
    cam = JCamera.from_w2c(np.eye(4), w, w, w / 2, h / 2, w, h)
    jd = jrefine.FrameData(
        cameras=jstack_cameras([cam, cam]), gt_images=jnp.asarray(gts), gt_depths=jnp.asarray(gt_depths),
        margins=jnp.asarray(margins), ref_edge_len=jnp.zeros(1), ref_area=jnp.zeros(1),
        edges=jnp.zeros((1, 2), jnp.int32), adj_faces=jnp.zeros((1, 2), jnp.int32))
    td = trefine.FrameData(
        cameras=None, gt_images=torch.tensor(gts.copy()), gt_depths=torch.tensor(gt_depths.copy()),
        margins=torch.tensor(margins, dtype=torch.int64), ref_edge_len=torch.zeros(1), ref_area=torch.zeros(1),
        edges=torch.zeros((1, 2), dtype=torch.int64), adj_faces=torch.zeros((1, 2), dtype=torch.int64))
    return img, depth, jd, td


@pytest.mark.parametrize("use_margin", [True, False], ids=["margin", "no_margin"])
def test_refine_pixel_losses_match_jax(use_margin):
    img, depth, jd, td = _frames(48, 64, seed=5)
    kw = dict(use_margin=use_margin, depth_loss_from=0, mask_loss_from=0)
    jcfg, tcfg = jrefine.RefineConfig(**kw), trefine.RefineConfig(**kw)

    def jloss(i, d):
        loss, ld = jrefine.pixel_losses(jd, 1, 1, jcfg, i, d, layout="cm")
        return loss, ld

    (jl, jdict), (ji, jdep) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(img), jnp.asarray(depth))
    ti = torch.tensor(img, requires_grad=True)
    tdep = torch.tensor(depth, requires_grad=True)
    tl, tdict = trefine.pixel_losses(td, 1, 1, tcfg, ti, tdep)
    gi, gd = torch.autograd.grad(tl, (ti, tdep))
    # float32 sums over 9k values taken in other orders
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for k in ("rgb_loss", "depth_loss", "mask_loss"):
        np.testing.assert_allclose(float(tdict[k].detach()), float(jdict[k]), rtol=1e-5, err_msg=k)
    for a, b in ((gi, ji), (gd, jdep)):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5 * float(np.abs(b).max()))
