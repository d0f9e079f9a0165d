"""Port cameras vs the JAX package: matrices on every golden fixture's camera."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import Camera as JCamera
from gaustar_tpu.cameras import index_camera as j_index, stack_cameras as j_stack
from gaustar_tpu_torch.cameras import Camera, index_camera, stack_cameras

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz")))


def _cams(path):
    z = np.load(path)
    args = (z["w2c"], float(z["fx"]), float(z["fy"]), float(z["cx"]), float(z["cy"]),
            int(z["width"]), int(z["height"]))
    return JCamera.from_w2c(*args), Camera.from_w2c(*args, device="cpu")


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)[:-4] for p in GOLDEN])
def test_camera_matrices_match(path):
    jc, tc = _cams(path)
    for name in ("view", "proj", "full_proj", "camera_center"):
        np.testing.assert_allclose(
            getattr(tc, name).numpy(), np.asarray(getattr(jc, name)), rtol=1e-6, atol=1e-7, err_msg=name
        )
    np.testing.assert_allclose(float(tc.tanfovx), float(jc.tanfovx), rtol=1e-7)
    np.testing.assert_allclose(float(tc.tanfovy), float(jc.tanfovy), rtol=1e-7)


def test_stack_and_index_cameras():
    rng = np.random.default_rng(0)
    jcs, tcs = [], []
    for i in range(3):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        w2c = np.eye(4)
        w2c[:3, :3] = q
        w2c[:3, 3] = rng.normal(size=3)
        args = (w2c, 50.0 + i, 55.0, 20.0 + i, 30.0, 48, 64)
        jcs.append(JCamera.from_w2c(*args))
        tcs.append(Camera.from_w2c(*args, device="cpu"))
    jb, tb = j_stack(jcs), stack_cameras(tcs)
    for i in range(3):
        jc, tc = j_index(jb, jnp.int32(i)), index_camera(tb, i)
        np.testing.assert_allclose(tc.full_proj.numpy(), np.asarray(jc.full_proj), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(tc.camera_center.numpy(), np.asarray(jc.camera_center), rtol=1e-6, atol=1e-6)


def test_cuda_default_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Camera.from_w2c(np.eye(4), 60.0, 60.0, 24.0, 32.0, 48, 64)
    assert jax.default_backend() == "cpu"
