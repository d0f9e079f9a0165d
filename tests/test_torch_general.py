"""Port utilities, mesh primitives and topology, normal consistency and the
dense oracle vs the JAX package."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.mesh import primitives as jprim
from gaustar_tpu.mesh import topology as jtopo
from gaustar_tpu.ops import losses as jlosses
from gaustar_tpu.utils import general as jgen
from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.mesh import primitives as tprim
from gaustar_tpu_torch.mesh import topology as ttopo
from gaustar_tpu_torch.ops import losses as tlosses
from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
from gaustar_tpu_torch.ops.rasterizer import RasterConfig, rasterize
from gaustar_tpu_torch.utils import general as tgen

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz")))


def test_quaternions_match_jax():
    rng = np.random.default_rng(0)
    q = (rng.normal(size=(64, 4)) * rng.uniform(0.3, 2.0, size=(64, 1))).astype(np.float32)
    np.testing.assert_allclose(tgen.quaternion_to_matrix(torch.as_tensor(q)).numpy(),
                               np.asarray(jgen.quaternion_to_matrix(jnp.asarray(q))), rtol=1e-6, atol=1e-6)
    unit = q / np.linalg.norm(q, axis=-1, keepdims=True)
    m = np.asarray(jgen.quaternion_to_matrix(jnp.asarray(unit)))
    np.testing.assert_allclose(tgen.matrix_to_quaternion(torch.as_tensor(m)).numpy(),
                               np.asarray(jgen.matrix_to_quaternion(jnp.asarray(m))), rtol=1e-5, atol=1e-6)


def test_norms_and_schedule_match_jax():
    v = np.array([[0.0, 0.0, 0.0], [3.0, -4.0, 12.0]], np.float32)
    jg = jax.grad(lambda x: (jgen.normalize(x) * jnp.arange(6.0).reshape(2, 3)).sum())(jnp.asarray(v))
    tv = torch.tensor(v, requires_grad=True)
    out = tgen.normalize(tv)
    (out * torch.arange(6.0).reshape(2, 3)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jgen.normalize(jnp.asarray(v))), rtol=1e-6)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)
    assert torch.isfinite(tv.grad).all()  # eps inside the sqrt: no 0 * inf at the zero vector
    np.testing.assert_allclose(tgen.l2norm(torch.as_tensor(v)).numpy(), np.asarray(jgen.l2norm(jnp.asarray(v))))
    x = np.array([0.05, 0.5, 0.9], np.float32)
    np.testing.assert_allclose(tgen.inverse_sigmoid(torch.as_tensor(x)).numpy(),
                               np.asarray(jgen.inverse_sigmoid(jnp.asarray(x))), rtol=1e-6)
    kw = dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_steps=7, lr_delay_mult=0.01, max_steps=30)
    jf, tf = jgen.get_expon_lr_func(**kw), tgen.get_expon_lr_func(**kw)
    for step in (-1, 0, 1, 3, 7, 15, 30, 45):
        np.testing.assert_allclose(tf(step), float(jf(step)), rtol=1e-6, err_msg=f"step {step}")


@pytest.mark.parametrize("mesh", ["icosphere", "uv_sphere"])
def test_mesh_primitives_and_topology_match_jax(mesh):
    if mesh == "icosphere":
        (jv, jf), (tv, tf) = (m.icosphere(2, radius=0.6, center=(0, 0, 4.0)) for m in (jprim, tprim))
    else:
        (jv, jf), (tv, tf) = (m.uv_sphere(11, 14, radius=0.6, center=(0, 0, 4.0)) for m in (jprim, tprim))
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    jt, tt = jtopo.build_topology(jf, len(jv)), ttopo.build_topology(tf, len(tv))
    assert tt._fields == jt._fields
    for name in jt._fields:
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name), err_msg=name)


def test_normal_consistency_matches_jax():
    verts, faces = jprim.icosphere(1, radius=0.6, center=(0, 0, 4.0))
    adj = jtopo.build_topology(faces, len(verts)).adj_faces
    moved = (verts + np.random.default_rng(2).normal(scale=0.02, size=verts.shape)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda v: jlosses.mesh_normal_consistency_loss(
        v, jnp.asarray(faces), jnp.asarray(adj)))(jnp.asarray(moved))
    tv = torch.tensor(moved, requires_grad=True)
    loss = tlosses.mesh_normal_consistency_loss(tv, torch.as_tensor(faces, dtype=torch.int64),
                                                torch.as_tensor(adj, dtype=torch.int64))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=1e-5)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)[:-4] for p in GOLDEN])
def test_dense_oracle_on_golden_fixtures(path):
    """The port's dense oracle (impl="dense") at the tolerances of
    tests/test_golden.py; the fixtures were recorded from the JAX package's
    dense oracle."""
    z = np.load(path)
    cam = Camera.from_w2c(z["w2c"], float(z["fx"]), float(z["fy"]), float(z["cx"]), float(z["cy"]),
                          int(z["width"]), int(z["height"]), device="cpu")
    leaves = [torch.tensor(z[k], requires_grad=True)
              for k in ("means3d", "scales", "quats", "opacities", "colors")]
    m, s, q, o, c = leaves
    img, aux = rasterize(m, quat_scale_to_cov3d(s, q), o, c, cam, bg=tuple(z["bg"]),
                         config=RasterConfig(impl="dense"))
    ((img * torch.as_tensor(z["probe"])).sum() + (aux.final_T * torch.as_tensor(z["probe_t"])).sum()).backward()
    np.testing.assert_allclose(img.detach().numpy(), z["image"], atol=3e-5, err_msg="image")
    np.testing.assert_allclose(aux.final_T.detach().numpy(), z["final_T"], atol=3e-5, err_msg="final_T")
    np.testing.assert_array_equal(aux.n_contrib.numpy(), z["n_contrib"])
    for key, leaf in zip(("g_means3d", "g_scales", "g_quats", "g_opacities", "g_colors"), leaves):
        ref = z[key]
        np.testing.assert_allclose(leaf.grad.numpy(), ref, rtol=2e-3,
                                   atol=max(2e-4, 1e-2 * float(np.abs(ref).max())), err_msg=key)
