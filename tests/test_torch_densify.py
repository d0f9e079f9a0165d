"""The port's densifier and the Adam moment surgery against the JAX package
(train/densifier.py, train_gaussians.surgery_opt_state), on the same
parameters, statistics and seed. The JAX package pads its arrays with dead
slots up to a bucket; its live rows are the first info["n_active"], and
those are what the port's exactly sized arrays must equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gaustar_tpu.models import gaussians as jg
from gaustar_tpu.train import densifier as jdens
from gaustar_tpu.train.optimizer import OptimizationParams
from gaustar_tpu.train.train_gaussians import make_optimizer, surgery_opt_state as jsurgery
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.models import gaussians as tg
from gaustar_tpu_torch.train import densifier as tdens
from gaustar_tpu_torch.train.optimizer import adam_init, adam_step, make_gs_lr_fn, surgery_opt_state

N = 120
FIELDS = [f.name for f in dataclasses.fields(jg.GaussianParams)]


def _np(x):
    return np.array(x)


def _params(seed=0):
    """A JAX GaussianParams from a seeded cloud, with 10 small hot gaussians
    (clones), 10 large (splits), 8 transparent (pruned) and rotated quats."""
    rng = np.random.default_rng(seed)
    p = jg.create_from_pcd(rng.normal(size=(N, 3)).astype(np.float32), rng.uniform(size=(N, 3)).astype(np.float32))
    sc = _np(p.scaling)
    sc[:10] = -8.0
    sc[10:20] = rng.uniform(-1.5, 0.5, size=(10, 3))
    op = _np(p.opacity)
    op[20:28] = -7.0
    rot = rng.normal(size=(N, 4)).astype(np.float32)
    rest = rng.normal(scale=0.1, size=p.features_rest.shape).astype(np.float32)
    return dataclasses.replace(p, scaling=jnp.asarray(sc), opacity=jnp.asarray(op), rotation=jnp.asarray(rot),
                               features_rest=jnp.asarray(rest))


def _stats(seed=1):
    """Two rounds of (means2d grad, radii); about a quarter invisible."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        g = rng.normal(scale=2e-4, size=(N, 2)).astype(np.float32)
        g[:20] *= 100.0
        radii = rng.integers(0, 30, size=N).astype(np.int32) * (rng.uniform(size=N) > 0.25)
        out.append((g, radii.astype(np.int32)))
    return out


def _both_states(stats):
    js, ts = jdens.init_state(N), tdens.init_state(N, "cpu")
    for g, r in stats:
        js = jdens.update_stats(js, jnp.asarray(g), jnp.asarray(r))
        ts = tdens.update_stats(ts, torch.as_tensor(g), torch.as_tensor(r))
    return js, ts


def _port(jp):
    return bridge.gaussian_params_from_numpy({k: _np(getattr(jp, k)) for k in FIELDS}, "cpu")


def test_stats_and_detection_match_jax():
    js, ts = _both_states(_stats())
    for k in ("grad_accum", "denom", "max_radii2d"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), _np(getattr(js, k)), rtol=1e-6, err_msg=k)
    for thr in (2e-4, 5e-3):
        jm, jgr = jdens.densify_detection(js, thr)
        tm, tgr = tdens.densify_detection(ts, thr)
        np.testing.assert_array_equal(tm.numpy(), _np(jm))
        np.testing.assert_allclose(tgr.numpy(), _np(jgr), rtol=1e-6)


def test_stats_and_detection_on_the_jax_tests_case():
    st = tdens.init_state(5, "cpu")
    g = torch.tensor([[0.1, 0.0]] * 5)
    radii = torch.tensor([1, 0, 2, 3, 0], dtype=torch.int32)
    st = tdens.update_stats(tdens.update_stats(st, g, radii), g * 3, radii)
    mask, _ = tdens.densify_detection(st, max_grad=0.15)
    np.testing.assert_array_equal(mask.numpy(), [True, False, True, True, False])


@pytest.mark.parametrize("screen", [None, 20.0], ids=["no_screen_size", "screen_size_20"])
def test_densify_and_prune_live_rows_match_jax(screen):
    """Clone / split / prune: info equal (the port's n_kept and n_pruned
    counted from the JAX package's keep_mask), the live rows equal within 1e-6
    (the split positions: a 3x3 rotation applied in another order; the split
    log-scales: log(exp(s) / 1.6) through another libm, about 1 ulp)."""
    jp = _params()
    js, ts = _both_states(_stats())
    kw = dict(max_grad=2e-3, min_opacity=0.005, extent=1.0, max_screen_size=screen, percent_dense=0.01, seed=7)
    jp2, js2, jinfo = jdens.densify_and_prune(jp, js, bucket=64, **kw)
    tp2, ts2, tinfo = tdens.densify_and_prune(_port(jp), ts, **kw)
    n = jinfo["n_active"]
    assert tinfo["n_active"] == n == tp2.xyz.shape[0]
    assert (tinfo["n_clone"], tinfo["n_split"]) == (jinfo["n_clone"], jinfo["n_split"])
    assert tinfo["n_clone"] > 0 and tinfo["n_split"] > 0
    np.testing.assert_array_equal(tinfo["keep_mask"], jinfo["keep_mask"])
    assert jg.n_points(jp2) % 64 == 0 and jdens.active_mask(jp2)[:n].all() and not jdens.active_mask(jp2)[n:].any()
    for k in FIELDS:
        got, ref = getattr(tp2, k).numpy(), _np(getattr(jp2, k))[:n]
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=k)
    assert ts2.grad_accum.shape == (n,) and not ts2.denom.any()
    kept = int(jinfo["keep_mask"].sum())
    assert (tinfo["n_kept"], tinfo["n_pruned"]) == (kept, len(jinfo["keep_mask"]) - kept)
    assert tinfo["n_pruned"] > 0 and n == kept + tinfo["n_clone"] + 2 * tinfo["n_split"]


def test_densify_counts_of_the_jax_tests_case():
    """tests/test_densify.py:23: 5 clones, 5 splits, 110 active."""
    rng = np.random.default_rng(0)
    p = tg.create_from_pcd(rng.normal(size=(100, 3)).astype(np.float32),
                           rng.uniform(size=(100, 3)).astype(np.float32), device="cpu")
    p.scaling[:5] = -8.0
    p.scaling[5:10] = 2.0
    g = torch.zeros((100, 2))
    g[:10] = 1.0
    st = tdens.update_stats(tdens.init_state(100, "cpu"), g, torch.ones(100))
    p2, _, info = tdens.densify_and_prune(p, st, max_grad=0.5, extent=1.0)
    assert (info["n_clone"], info["n_split"], info["n_active"]) == (5, 5, 110) == (5, 5, tg.n_points(p2))
    assert (info["n_pruned"], info["n_kept"]) == (5, 95)


def test_reset_opacity_matches_jax():
    jp = _params(3)
    tp = tdens.reset_opacity(_port(jp))
    np.testing.assert_allclose(tp.opacity.numpy(), _np(jdens.reset_opacity(jp).opacity), rtol=1e-6)
    assert (torch.sigmoid(tp.opacity) <= 0.0101).all()


def _jax_moments(state, name):
    adam = state.inner_states[name].inner_state[0]
    return _np(getattr(adam.mu, name)), _np(getattr(adam.nu, name)), int(adam.count)


def test_moment_surgery_matches_jax():
    """Three Adam steps with seeded gradients in both packages, a densify
    event, the surgery, and one more step: the live rows' mu and nu, the
    step count and the parameters agree (rtol 1e-5); new rows start at 0."""
    jp = _params(4)
    tp = _port(jp)
    opt = make_optimizer(OptimizationParams(), 1.0)
    jstate, tstate = opt.init(jp), adam_init(tp)
    lr_fn = make_gs_lr_fn(OptimizationParams(), 1.0)
    rng = np.random.default_rng(9)

    def step(jp, tp, jstate, n):
        g = {k: rng.normal(size=(n, *getattr(jp, k).shape[1:])).astype(np.float32) for k in FIELDS}
        jgr = jg.GaussianParams(**{k: jnp.asarray(np.pad(v, [(0, getattr(jp, k).shape[0] - n)] + [(0, 0)] * (v.ndim - 1)))
                                   for k, v in g.items()})
        upd, jstate = opt.update(jgr, jstate, jp)
        adam_step(tp, {k: torch.as_tensor(v) for k, v in g.items()}, tstate, lr_fn)
        return optax.apply_updates(jp, upd), jstate

    for _ in range(3):
        jp, jstate = step(jp, tp, jstate, N)
    js, ts = _both_states(_stats())
    kw = dict(max_grad=2e-3, extent=1.0, seed=11)
    jp2, _, jinfo = jdens.densify_and_prune(jp, js, bucket=64, **kw)
    tp2, _, tinfo = tdens.densify_and_prune(tp, ts, **kw)
    jstate = jsurgery(jstate, jg.n_points(jp), jinfo["keep_mask"], jg.n_points(jp2))
    tstate = surgery_opt_state(tstate, tinfo["keep_mask"], tinfo["n_active"])
    n, kept = tinfo["n_active"], int(tinfo["keep_mask"].sum())
    assert tstate.count == 3
    jp2, jstate = step(jp2, tp2, jstate, n)
    assert tstate.count == 4
    for k in FIELDS:
        mu, nu, count = _jax_moments(jstate, k)
        assert count == tstate.count
        np.testing.assert_allclose(tstate.mu[k].numpy(), mu[:n], rtol=1e-5, atol=1e-9, err_msg=k)
        np.testing.assert_allclose(tstate.nu[k].numpy(), nu[:n], rtol=1e-5, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(getattr(tp2, k).numpy(), _np(getattr(jp2, k))[:n], rtol=1e-5, atol=1e-6, err_msg=k)
    # The new rows' moments hold one step's gradient g alone: mu = 0.1 g and
    # nu = 0.001 g^2, so nu = 0.1 mu^2.
    assert n > kept
    mu_new, nu_new = tstate.mu["xyz"][kept:].numpy(), tstate.nu["xyz"][kept:].numpy()
    np.testing.assert_allclose(nu_new, 0.1 * mu_new**2, rtol=1e-5)
