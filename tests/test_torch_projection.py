"""Port preprocess / cov3d / SH vs the JAX package: values and gradients."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import Camera as JCamera
from gaustar_tpu.ops import projection as jproj
from gaustar_tpu.ops import sh as jsh
from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops import projection as tproj
from gaustar_tpu_torch.ops import sh as tsh

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz")))
# Golden gradient tolerance (tests/test_golden.py): rtol 2e-3 and an absolute
# floor of max(2e-4, 1% of the reference's inf-norm), for f32 chains through
# the EWA covariance whose summation order differs between the two packages.
RTOL_G = 2e-3


def _grad_close(a, b, name):
    atol = max(2e-4, 1e-2 * float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=RTOL_G, atol=atol, err_msg=name)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32, requires_grad=grad)


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)[:-4] for p in GOLDEN])
def test_preprocess_matches_jax(path):
    z = np.load(path)
    args = (z["w2c"], float(z["fx"]), float(z["fy"]), float(z["cx"]), float(z["cy"]),
            int(z["width"]), int(z["height"]))
    jc, tc = JCamera.from_w2c(*args), Camera.from_w2c(*args, device="cpu")
    m, s, q, o, c = (z[k] for k in ("means3d", "scales", "quats", "opacities", "colors"))

    jg = jproj.preprocess(jnp.asarray(m), jproj.quat_scale_to_cov3d(jnp.asarray(s), jnp.asarray(q)),
                          jnp.asarray(o), jnp.asarray(c), jc)
    tg = tproj.preprocess(_t(m), tproj.quat_scale_to_cov3d(_t(s), _t(q)), _t(o), _t(c), tc)
    for name in ("mean2d", "depth", "conic", "opacity", "color"):
        np.testing.assert_allclose(getattr(tg, name).detach().numpy(), np.asarray(getattr(jg, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for name in ("radius", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)), err_msg=name)

    rng = np.random.default_rng(1)
    probes = {k: rng.normal(size=np.asarray(getattr(jg, k)).shape).astype(np.float32)
              for k in ("mean2d", "depth", "conic")}

    def jloss(m, s, q):
        g = jproj.preprocess(m, jproj.quat_scale_to_cov3d(s, q), jnp.asarray(o), jnp.asarray(c), jc)
        return sum((getattr(g, k) * probes[k]).sum() for k in probes)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(m), jnp.asarray(s), jnp.asarray(q))
    tm, ts, tq = _t(m, True), _t(s, True), _t(q, True)
    g = tproj.preprocess(tm, tproj.quat_scale_to_cov3d(ts, tq), _t(o), _t(c), tc)
    sum((getattr(g, k) * torch.as_tensor(probes[k])).sum() for k in probes).backward()
    for name, a, b in zip(("means3d", "scales", "quats"), (tm, ts, tq), jgrads):
        _grad_close(a.grad.numpy(), np.asarray(b), name)


def test_cov3d_unnormalized_quats():
    rng = np.random.default_rng(2)
    s = np.exp(rng.normal(-2, 0.5, size=(64, 3))).astype(np.float32)
    q = (rng.normal(size=(64, 4)) * rng.uniform(0.2, 3.0, size=(64, 1))).astype(np.float32)
    probe = rng.normal(size=(64, 6)).astype(np.float32)
    jv, jgrads = jax.value_and_grad(
        lambda s, q: (jproj.quat_scale_to_cov3d(s, q) * probe).sum(), argnums=(0, 1)
    )(jnp.asarray(s), jnp.asarray(q))
    ts, tq = _t(s, True), _t(q, True)
    tv = (tproj.quat_scale_to_cov3d(ts, tq) * torch.as_tensor(probe)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(
        tproj.quat_scale_to_cov3d(ts, tq).detach().numpy(),
        np.asarray(jproj.quat_scale_to_cov3d(jnp.asarray(s), jnp.asarray(q))), rtol=1e-5, atol=1e-9,
    )
    for a, b in zip((ts.grad, tq.grad), jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_sh_matches_jax(deg):
    rng = np.random.default_rng(3 + deg)
    n = 50
    sh = rng.normal(scale=0.5, size=(n, (deg + 1) ** 2, 3)).astype(np.float32)
    pos = rng.normal(size=(n, 3)).astype(np.float32)
    cam = np.array([0.1, -0.2, -3.0], np.float32)
    probe = rng.normal(size=(n, 3)).astype(np.float32)

    dirs = pos - cam
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    np.testing.assert_allclose(
        tsh.eval_sh(deg, _t(sh), _t(dirs)).numpy(),
        np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))), rtol=1e-5, atol=1e-6,
    )

    def jf(sh, pos):
        return (jsh.sh_to_rgb(deg, sh, pos, jnp.asarray(cam)) * probe).sum()

    jv, jg = jax.value_and_grad(jf, argnums=(0, 1))(jnp.asarray(sh), jnp.asarray(pos))
    tsh_, tpos = _t(sh, True), _t(pos, True)
    tv = (tsh.sh_to_rgb(deg, tsh_, tpos, _t(cam)) * torch.as_tensor(probe)).sum()
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tsh_.grad.numpy(), np.asarray(jg[0]), rtol=1e-5, atol=1e-6)
    g_pos = tpos.grad if tpos.grad is not None else torch.zeros_like(tpos)  # degree 0: no direction
    np.testing.assert_allclose(g_pos.numpy(), np.asarray(jg[1]), rtol=1e-4, atol=1e-6)
