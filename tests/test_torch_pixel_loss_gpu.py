"""The pixel-loss kernels (csrc/pixel_loss.cu) on the card against their plain
PyTorch versions at the benchmark's 1600x1024 with its margins (principal
points at the image centres: 1 pixel a side), at an uneven margin and with
none, at sizes smaller than the window, and through refine.pixel_losses.
Every test needs a CUDA card and skips without one. JAX is not imported:

    python -m pytest --noconftest -m gpu tests/test_torch_pixel_loss_gpu.py -q
"""

import pytest
import torch

from gaustar_tpu_torch.ops import pixel_loss
from gaustar_tpu_torch.train import refine
from gaustar_tpu_torch.utils import profiling
from pixel_loss_frames import frame

pytestmark = pytest.mark.gpu

MAX_DEPTH = 10.0
# Tolerances of the kernels (float32) against the plain versions run in
# float64 on the same inputs. The means: sums of up to 4.9M terms, per
# block and then over the blocks. The gradients: the SSIM term divides by
# sigma1^2 + sigma2^2 + C2, where sigma^2 = E[x^2] - mu^2 cancels in float32;
# the plain versions in float32 read about 7e-5 of the field's largest
# value there.
MEANS_RTOL = 2e-6
GRAD_ATOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pixel-loss kernels have no CPU mode")
    return torch.device("cuda")


def _both(render, gt, gt_depth, margin, g):
    """(means, d img, d depth) of the kernels and of the plain versions in
    float64."""
    out = []
    for fwd, bwd, dtype in ((pixel_loss.pixel_loss_fwd_cuda, pixel_loss.pixel_loss_bwd_cuda, torch.float32),
                            (pixel_loss.pixel_loss_fwd_plain, pixel_loss.pixel_loss_bwd_plain, torch.float64)):
        r, gi, gd = (t.to(dtype) for t in (render, gt, gt_depth))
        means, saved = fwd(r[:3], r[3], gi, gd, margin, MAX_DEPTH)
        out.append((means, *bwd(r[:3], r[3], gi, gd, margin, MAX_DEPTH, saved, g.to(dtype))))
    return out


CASES = {
    "benchmark_margins": (1024, 1600, (1, 1, 1, 1)),
    "uneven_margins": (1024, 1600, (37, 1, 1, 21)),
    "no_margin": (1024, 1600, None),
    "shorter_than_window": (7, 45, (1, 2, 1, 1)),
    "ragged_tiles": (77, 50, (3, 0, 0, 5)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernels_match_plain_versions(cuda, case):
    h, w, margin = CASES[case]
    render, gt, gt_depth = frame(cuda, h, w)
    margin = None if margin is None else torch.tensor(margin, dtype=torch.int64, device=cuda)
    g = torch.tensor([0.8, -0.2, 0.1, 1.0], device=cuda)
    (mk, ik, dk), (mp, ip, dp) = _both(render, gt, gt_depth, margin, g)
    torch.testing.assert_close(mk.double(), mp, rtol=MEANS_RTOL, atol=0)
    for a, b in ((ik, ip), (dk, dp)):
        torch.testing.assert_close(a.double(), b, rtol=0, atol=GRAD_ATOL * float(b.abs().max()))
    if margin is not None:  # nothing flows into the margins
        m = margin.tolist()
        assert not ik[:, :, : m[0]].any() and not ik[:, : m[2]].any()
        assert not ik[:, :, w - m[1]:].any() and not ik[:, h - m[3]:].any()


def test_kernels_repeat_bit_for_bit(cuda):
    render, gt, gt_depth = frame(cuda, 1024, 1600, seed=1)
    margin = torch.ones(4, dtype=torch.int64, device=cuda)
    g = torch.tensor([0.8, -0.2, 0.1, 1.0], device=cuda)
    runs = [_both(render, gt, gt_depth, margin, g)[0] for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_function_launches_once_a_render_and_never_falls_back(cuda):
    render, gt, gt_depth = frame(cuda, 256, 320, seed=2)
    render.requires_grad_()
    margin = torch.ones(4, dtype=torch.int64, device=cuda)
    before = profiling.counts("pixel_loss_fwd", "pixel_loss_bwd")
    means = pixel_loss.pixel_loss_means(render[:3], render[3], gt, gt_depth, margin, MAX_DEPTH)
    means.sum().backward()
    after = profiling.counts("pixel_loss_fwd", "pixel_loss_bwd")
    assert {k: after[k] - before[k] for k in after} == {"pixel_loss_fwd": 1, "pixel_loss_bwd": 1}
    with pytest.raises(ValueError):  # a CUDA render with CPU ground truth: no plain fallback
        pixel_loss.pixel_loss_means(render[:3], render[3], gt.cpu(), gt_depth, margin, MAX_DEPTH)


def test_backward_needs_the_kept_partials(cuda):
    render, gt, gt_depth = frame(cuda, 64, 96, seed=4)
    args = (render[:3], render[3], gt, gt_depth, None, MAX_DEPTH)
    _, saved = pixel_loss.pixel_loss_fwd_cuda(*args, keep=False)
    with pytest.raises(ValueError):
        pixel_loss.pixel_loss_bwd_cuda(*args, saved, torch.ones(4, device=cuda))


def test_refine_pixel_losses_card_against_cpu(cuda):
    """refine.pixel_losses on the card (kernels) against the same inputs on
    the CPU (plain versions): loss dict and gradients."""
    render, gt, gt_depth = frame(cuda, 192, 256, seed=3)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        data = refine.FrameData(
            cameras=None, gt_images=gt[None].to(dev), gt_depths=gt_depth[None].to(dev),
            margins=torch.tensor([[3, 1, 2, 4]], dtype=torch.int64, device=dev), ref_edge_len=None,
            ref_area=None, edges=None, adj_faces=None)
        r = render.detach().to(dev).requires_grad_()
        loss, ld = refine.pixel_losses(data, 0, 1, refine.RefineConfig(), r[:3], r[3])
        (grad,) = torch.autograd.grad(loss, r)
        out[dev.type] = (loss.detach().cpu(), {k: v.detach().cpu() for k, v in ld.items()}, grad.cpu())
    (lc, dc, gc), (lp, dp, gp) = out["cuda"], out["cpu"]
    torch.testing.assert_close(lc, lp, rtol=1e-5, atol=0)
    for k in dp:
        torch.testing.assert_close(dc[k], dp[k], rtol=1e-5, atol=0)
    torch.testing.assert_close(gc, gp, rtol=0, atol=GRAD_ATOL * float(gp.abs().max()))
