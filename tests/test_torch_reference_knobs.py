"""The reference's default-off knobs in the port against the JAX package:
the Laplacian-smoothing and area_reg losses with their gradients (the cases
of tests/test_reference_knobs.py:22,36), compute_losses with both knobs on
(as at :94), the knobs carried across by bridge.config_from_fields, and the
border-face postprocess on the closed sphere and on the open half (:70,77),
whose face masks must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import stack_cameras
from gaustar_tpu.mesh.primitives import uv_sphere
from gaustar_tpu.mesh.topology import build_topology
from gaustar_tpu.models import sugar as jsugar
from gaustar_tpu.ops import losses as jlosses
from gaustar_tpu.ops.rasterizer import RasterConfig as JRasterConfig
from gaustar_tpu.train import mesh_update as jmu
from gaustar_tpu.train import refine as jrefine
from gaustar_tpu.utils.synthetic import ring_cameras
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.ops import losses as tlosses
from gaustar_tpu_torch.train import mesh_update as tmu
from gaustar_tpu_torch.train import refine as trefine
from port_helpers import one_thread, port_sugar  # noqa: F401  (one_thread: autouse)

# Loss values: rtol 1e-5 (float32 sums in another order); gradients: the
# golden gradient tolerance of tests/test_golden.py.
RTOL = 1e-5


def _sphere_scene():
    verts, faces = uv_sphere(7, 10, radius=0.5, center=(0.0, 0.0, 3.0))
    jp, jc = jsugar.init_sugar(verts, faces)
    return np.asarray(verts, np.float32), np.asarray(faces), jp, jc


def _grad_close(got, ref, name):
    atol = max(2e-4, 1e-2 * float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=atol, err_msg=name)


def _laplacian_cases():
    verts, faces, *_ = _sphere_scene()
    edges = build_topology(faces, len(verts)).edges
    moved = verts.copy()
    moved[5] += [0.0, 0.0, 0.3]
    return {"sphere": (verts, edges), "one_vertex_moved": (moved, edges)}


@pytest.mark.parametrize("case", ["sphere", "one_vertex_moved"])
def test_laplacian_smoothing_loss_and_gradient_match_jax(case):
    v, edges = _laplacian_cases()[case]
    jv, jg = jax.value_and_grad(jlosses.mesh_laplacian_smoothing_loss)(jnp.asarray(v), jnp.asarray(edges))
    tv = torch.tensor(v, requires_grad=True)
    loss = tlosses.mesh_laplacian_smoothing_loss(tv, torch.as_tensor(edges, dtype=torch.int64))
    (tg,) = torch.autograd.grad(loss, [tv])
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=RTOL)
    _grad_close(tg.numpy(), np.asarray(jg), "d laplacian / d verts")
    if case == "one_vertex_moved":
        assert float(tg[5, 2]) > 0.0  # the gradient points along the perturbation


def test_laplacian_gradient_is_finite_at_the_centroid():
    """A vertex exactly at its neighbours' centroid: zero Laplacian there,
    and a finite gradient (the eps inside the norm), in both packages."""
    v = np.array([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0]], np.float32)
    edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4]])
    tv = torch.tensor(v, requires_grad=True)
    (tg,) = torch.autograd.grad(tlosses.mesh_laplacian_smoothing_loss(tv, torch.as_tensor(edges)), [tv])
    jg = jax.grad(jlosses.mesh_laplacian_smoothing_loss)(jnp.asarray(v), jnp.asarray(edges))
    assert np.isfinite(tg.numpy()).all() and np.isfinite(np.asarray(jg)).all()
    _grad_close(tg.numpy(), np.asarray(jg), "d laplacian / d verts")


@pytest.mark.parametrize("case", ["sphere", "sliver"])
def test_area_reg_loss_and_gradient_match_jax(case):
    verts, faces, *_ = _sphere_scene()
    v = verts.copy()
    if case == "sliver":
        v[faces[0, 1]] = v[faces[0, 0]] + 1e-4
    jv, jg = jax.value_and_grad(jlosses.mesh_area_reg_loss)(jnp.asarray(v), jnp.asarray(faces))
    tv = torch.tensor(v, requires_grad=True)
    loss = tlosses.mesh_area_reg_loss(tv, torch.as_tensor(faces, dtype=torch.int64))
    (tg,) = torch.autograd.grad(loss, [tv])
    np.testing.assert_allclose(float(loss.detach()), float(jv), rtol=RTOL, atol=1e-7)
    _grad_close(tg.numpy(), np.asarray(jg), "d area_reg / d verts")
    if case == "sliver":
        assert float(loss.detach()) > 0.0


KNOBS = dict(use_laplacian_smoothing=True, area_reg_from=0, laplacian_smoothing_factor=5.0, area_reg_loss_factor=0.1)


def test_config_from_fields_carries_the_knobs():
    """The JAX RefineConfig with the knobs set carries across. Its compile
    reuse fields (traced_hparams, batch_impl) are not ported; at their
    defaults they are left out, and passing them raises."""
    jcfg = jrefine.RefineConfig(num_iterations=10, **KNOBS)
    fields = dataclasses.asdict(jcfg)
    with pytest.raises(ValueError, match="batch_impl"):
        bridge.config_from_fields(trefine.RefineConfig, fields)
    assert (fields.pop("traced_hparams"), fields.pop("batch_impl")) == (False, "unroll")
    tcfg = bridge.config_from_fields(trefine.RefineConfig, fields)
    assert tcfg == trefine.RefineConfig(num_iterations=10, **KNOBS)
    assert dataclasses.asdict(tcfg) == fields


def _knob_frame():
    verts, faces, jp, jc = _sphere_scene()
    cams = ring_cameras(2, w=48, h=32, focal=45.0)
    batch = stack_cameras(cams)
    topo = build_topology(faces, len(verts))
    ref_edge = jlosses.edge_lengths(jnp.asarray(verts), jnp.asarray(topo.edges))
    ref_area, _ = jlosses.face_areas_normals(jnp.asarray(verts), jnp.asarray(faces))
    margins = jrefine.compute_margins(np.asarray(batch.cx), np.asarray(batch.cy), 48, 32)
    rng = np.random.default_rng(5)
    gt = rng.uniform(size=(2, 32, 48, 3)).astype(np.float32)
    jd = jrefine.FrameData(cameras=batch, gt_images=jnp.asarray(gt), gt_depths=jnp.full((2, 32, 48), 10.5),
                           margins=jnp.asarray(margins), ref_edge_len=ref_edge, ref_area=ref_area,
                           edges=jnp.asarray(topo.edges), adj_faces=jnp.asarray(topo.adj_faces))
    cam = {k: np.asarray(getattr(batch, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")}
    cam.update(width=48, height=32)
    data = {k: np.asarray(getattr(jd, k)) for k in ("gt_images", "gt_depths", "margins", "ref_edge_len",
                                                   "ref_area", "edges", "adj_faces")}
    td = bridge.frame_data_from_numpy({**data, "cameras": cam}, "cpu")
    # Off the rest state, so that the area-iso kink does not decide a sign.
    jp = dataclasses.replace(jp, points=jp.points + jnp.asarray(rng.normal(scale=5e-3, size=jp.points.shape),
                                                                 jnp.float32))
    return (jp, jc, jd), (*port_sugar(jp, jc), td)


@pytest.mark.parametrize("iteration", [0, 5], ids=["area_reg_gated_off", "area_reg_on"])
def test_compute_losses_with_the_knobs_match_jax(iteration):
    (jp, jc, jd), (tp, tc, td) = _knob_frame()
    jcfg = jrefine.RefineConfig(num_iterations=10, do_sh_warmup=False, **KNOBS)
    tcfg = trefine.RefineConfig(num_iterations=10, do_sh_warmup=False, **KNOBS)
    rc = JRasterConfig(max_pairs=1 << 14, chunk=8, impl="jax", max_per_tile=4096)

    @jax.jit
    def jloss(p):
        return jax.value_and_grad(
            lambda q: jrefine.compute_losses(q, jc, jd, jnp.int32(0), jnp.int32(iteration), jcfg, rc, 2),
            has_aux=True)(p)

    (jv, jdict), jg = jloss(jp)
    tv, tdict = trefine.compute_losses(tp, tc, td, 0, iteration, tcfg, trefine.RasterConfig(), 2)
    for k in ("laplacian_loss", "area_reg_loss", "nc_loss", "area_loss", "rgb_loss"):
        assert np.isfinite(float(tdict[k]))
        np.testing.assert_allclose(float(tdict[k].detach()), float(jdict[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=RTOL)
    grads = torch.autograd.grad(tv, [p for _, p in tp.named()], allow_unused=True)
    for (name, p), g in zip(tp.named(), grads):
        ref = np.asarray(getattr(jg, name))
        _grad_close(np.zeros_like(ref) if g is None else g.numpy(), ref, name)


def test_default_step_has_no_knob_terms():
    (_, _, _), (tp, tc, td) = _knob_frame()
    cfg = trefine.RefineConfig(num_iterations=10, do_sh_warmup=False)
    _, ld = trefine.compute_losses(tp, tc, td, 0, 5, cfg, trefine.RasterConfig(), 2)
    assert "laplacian_loss" not in ld and "area_reg_loss" not in ld


def _open_half():
    _, faces, jp, jc = _sphere_scene()
    keep = np.arange(len(faces)) < (len(faces) // 2)
    jp1, jc1 = jmu.subset_sugar_faces(jp, jc, keep)
    return (jp1, jc1), port_sugar(jp1, jc1)


@pytest.mark.parametrize("threshold,iterations", [(1e9, 2), (0.0, 2), (0.1, 5), (0.3, 5)],
                         ids=["peel_only", "readd_all", "defaults", "threshold_0.3"])
def test_postprocess_border_faces_on_the_open_half_matches_jax(threshold, iterations):
    (jp, jc), (tp, tc) = _open_half()
    (jp2, jc2), jmask = jmu.postprocess_border_faces(jp, jc, density_threshold=threshold, iterations=iterations)
    (tp2, tc2), tmask = tmu.postprocess_border_faces(tp, tc, density_threshold=threshold, iterations=iterations)
    np.testing.assert_array_equal(tmask, jmask)
    np.testing.assert_array_equal(tc2.faces.numpy(), np.asarray(jc2.faces))
    np.testing.assert_array_equal(tp2.scales.detach().numpy(), np.asarray(jp2.scales))
    if threshold > 1e8:
        assert tmask.sum() < len(tmask)  # faces were peeled
    if threshold == 0.0:
        assert tmask.all()


def test_postprocess_border_faces_keeps_the_closed_sphere():
    _, _, jp, jc = _sphere_scene()
    tp, tc = port_sugar(jp, jc)
    (_, tc2), tmask = tmu.postprocess_border_faces(tp, tc)
    _, jmask = jmu.postprocess_border_faces(jp, jc)
    assert tmask.all() and jmask.all()
    assert tc2.faces.shape == tc.faces.shape
