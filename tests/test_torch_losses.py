"""Port losses, static gather and named-group Adam vs the JAX package."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaustar_tpu.mesh.primitives import icosphere
from gaustar_tpu.mesh.topology import build_topology
from gaustar_tpu.models import sugar as jsugar
from gaustar_tpu.ops import losses as jlosses
from gaustar_tpu.ops import segment as jseg
from gaustar_tpu.train.optimizer import OptimizationParams as JOpt, make_sugar_optimizer
from gaustar_tpu_torch.ops import losses as tlosses
from gaustar_tpu_torch.ops import segment as tseg
from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, adam_step, make_lr_fn
from gaustar_tpu_torch.bridge import sugar_params_from_numpy


def test_ssim_map_matches_jax():
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(3, 40, 52)).astype(np.float32)
    b = rng.uniform(size=(3, 40, 52)).astype(np.float32)
    probe = rng.normal(size=(3, 40, 52)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda x: (jlosses.ssim_map_cm(x, jnp.asarray(b)) * probe).sum())(jnp.asarray(a))
    ta = torch.tensor(a, requires_grad=True)
    smap = tlosses.ssim_map_cm(ta, torch.as_tensor(b))
    np.testing.assert_allclose(smap.detach().numpy(), np.asarray(jlosses.ssim_map_cm(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    tv = (smap * torch.as_tensor(probe)).sum()
    tv.backward()
    # the map agrees elementwise at 1e-5; its probe-weighted sum adds 6k
    # signed terms in another order than XLA does
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-4)
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("with_tables", [False, True])
def test_mesh_regularizers_match_jax(with_tables):
    verts, faces = icosphere(2, radius=0.6, center=(0, 0, 4.0))
    topo = build_topology(faces, len(verts))
    rng = np.random.default_rng(1)
    ref_area = np.asarray(jlosses.face_areas_normals(jnp.asarray(verts), jnp.asarray(faces))[0])
    ref_len = np.asarray(jlosses.edge_lengths(jnp.asarray(verts), jnp.asarray(topo.edges)))
    moved = (verts + rng.normal(scale=0.01, size=verts.shape)).astype(np.float32)
    moved[faces[0, 1]] = moved[faces[0, 0]]  # one degenerate face: gradients stay finite
    fer, few = jlosses.face_edge_tables(faces, topo.edges, ref_len)
    j_kw = dict(face_edge_ref=jnp.asarray(fer), face_edge_w=jnp.asarray(few)) if with_tables else dict(
        edges=jnp.asarray(topo.edges), ref_edge_len=jnp.asarray(ref_len))
    t_kw = dict(face_edge_ref=torch.as_tensor(fer), face_edge_w=torch.as_tensor(few)) if with_tables else dict(
        edges=torch.tensor(topo.edges, dtype=torch.int64), ref_edge_len=torch.as_tensor(ref_len))
    if with_tables:
        j_kw.update(tables=jseg.gather_tables(faces, len(verts)),
                    adj_tables=jseg.gather_tables(topo.adj_faces, len(faces)))
        t_kw.update(tables=tseg.gather_tables(faces, len(verts), "cpu"),
                    adj_tables=tseg.gather_tables(topo.adj_faces, len(faces), "cpu"))
    w = {"nc": 0.5, "edge": 1000.0, "area": 1000.0}

    def jf(v):
        r = jlosses.mesh_regularizers(v, jnp.asarray(faces), jnp.asarray(topo.adj_faces), jnp.asarray(ref_area), **j_kw)
        return sum(w[k] * r[k] for k in w), r

    (jv, jr), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(moved))
    tv_ = torch.tensor(moved, requires_grad=True)
    tr = tlosses.mesh_regularizers(tv_, torch.as_tensor(faces, dtype=torch.int64),
                                   torch.as_tensor(topo.adj_faces, dtype=torch.int64), torch.as_tensor(ref_area), **t_kw)
    for k in w:
        np.testing.assert_allclose(float(tr[k].detach()), float(jr[k]), rtol=1e-5, atol=1e-9, err_msg=k)
    sum(w[k] * tr[k] for k in w).backward()
    assert np.isfinite(tv_.grad.numpy()).all()
    g_ref = np.asarray(jg)
    np.testing.assert_allclose(tv_.grad.numpy(), g_ref, rtol=1e-4, atol=1e-5 * np.abs(g_ref).max())


def test_gather_rows_vjp_matches_jax():
    rng = np.random.default_rng(0)
    n, m, c = 57, 301, 3
    src = rng.standard_normal((n, c)).astype(np.float32)
    idx = rng.integers(1, n - 1, size=m).astype(np.int32)
    ct = rng.standard_normal((m, c)).astype(np.float32)
    jg = jax.grad(lambda s: (jseg.gather_rows(s, jnp.asarray(idx), jseg.gather_tables(idx, n)) * ct).sum())(
        jnp.asarray(src))
    ts = torch.tensor(src, requires_grad=True)
    out = tseg.gather_rows(ts, torch.as_tensor(idx, dtype=torch.int64), tseg.gather_tables(idx, n, "cpu"))
    (out * torch.as_tensor(ct)).sum().backward()
    exact = np.zeros((n, c))
    np.add.at(exact, idx, ct.astype(np.float64))
    np.testing.assert_allclose(ts.grad.numpy(), exact, rtol=1e-6, atol=1e-6)
    # The JAX backward takes each segment sum as a difference of one running
    # cumsum, whose float32 error grows with the running total.
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    assert (ts.grad[0] == 0).all() and (ts.grad[n - 1] == 0).all()


def test_named_group_adam_matches_optax():
    verts, faces = icosphere(1, radius=0.6, center=(0, 0, 4.0))
    jp, _ = jsugar.init_sugar(verts, faces)
    arrays = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    before = {k: v.copy() for k, v in arrays.items()}
    tp = sugar_params_from_numpy(arrays, device="cpu")
    # a short position schedule so the decay shows within the steps
    opt = dict(position_lr_max_steps=10, iterations=10)
    joptim = make_sugar_optimizer(JOpt(**opt), 2.5)
    jstate = joptim.init(jp)
    tstate = adam_init(tp)
    lr_fn = make_lr_fn(OptimizationParams(**opt), 2.5)
    rng = np.random.default_rng(5)
    for step in range(6):
        grads = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in arrays.items()}
        grads["delta_t"][:] = 0.0  # an unused group still steps
        grads["sh_rest"] *= 1e-12  # tiny gradients: the eps=1e-15 regime
        jgrads = type(jp)(**{k: jnp.asarray(v) for k, v in grads.items()})
        upd, jstate = joptim.update(jgrads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        adam_step(tp, {k: torch.as_tensor(v) for k, v in grads.items()}, tstate, lr_fn)
        for k, v in tp.named():
            np.testing.assert_allclose(v.detach().numpy(), np.asarray(getattr(jp, k)), rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} step {step + 1}")
    assert tstate.count == 6
    np.testing.assert_array_equal(tp.delta_t.detach().numpy(), arrays["delta_t"])
    # the in-place updates never reach the caller's (here JAX's) buffers
    for k, v in arrays.items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
