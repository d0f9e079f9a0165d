"""The port's detect_topo_err against the JAX package's on identical params,
cameras and GT depth (48x48, 6 ring cameras, a subdiv-2 icosphere of 1,920
gaussians): the improved defaults on a consistent scene and on a shifted GT,
and reference_mode() with half-trained opacities. The JAX blend runs as
impl="jax"."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu.train import topo_detect as jtd
from gaustar_tpu.utils import synthetic as jsynth
from gaustar_tpu.utils.general import inverse_sigmoid
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.mesh.topology import build_topology
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.train import topo_detect as ttd
from port_helpers import one_thread  # noqa: F401  (autouse)


# Per-tile capacity above this scene's longest tile list (the JAX blend's
# impl="jax" truncates a list at max_per_tile).
JAX_RCFG = JaxRasterConfig(max_pairs=1 << 16, chunk=32, max_per_tile=4096, impl="jax")
KW = dict(min_observe=2, mesh_prop=5, detect_floor=False, depth_agreement=0.1, edge_threshold=0.6)
# Face weights are float64 means of values computed from float32 renders; the
# two renderers order their float32 sums differently, so a weight may move
# by rounding, and a vertex sitting on a gate's edge may flip. With the
# defaults the renders are solid and weights agree within 1e-4. In reference
# mode the half-transparent renders carry T x max_depth: there the golden
# image tolerance (3e-5, tests/test_golden.py) times the loss scale (10) and
# depth_scalar (3) gives 1e-3.
W_SHARE, FLAG_SHARE = 0.995, 0.005


def port_params(jp):
    return bridge.sugar_params_from_numpy({f.name: np.array(getattr(jp, f.name)) for f in dataclasses.fields(jp)},
                                          "cpu")


def port_config(jc, n_verts):
    return bridge.sugar_config_from_numpy(
        dict(faces=np.array(jc.faces), bary=np.array(jc.bary), thickness=np.array(jc.thickness),
             n_gaussians_per_face=jc.n_gaussians_per_face, sh_levels=jc.sh_levels, min_scale=jc.min_scale,
             max_scale=jc.max_scale, loose_bind=jc.loose_bind, n_verts=n_verts), "cpu")


def port_cameras(jcams):
    return bridge.camera_from_numpy(*(np.array(getattr(jcams, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")),
                                    jcams.width, jcams.height, device="cpu")


CASES = {  # opacity, shifted GT, reference mode, face-weight tolerance
    "defaults_consistent": (0.999, False, False, 1e-4),
    "defaults_shifted_gt": (0.999, True, False, 1e-4),
    "reference_mode_half_trained": (0.6, False, True, 1e-3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_detect_topo_err_matches_jax(case):
    opacity, shift, reference, w_tol = CASES[case]
    _, jc, jd, target, _ = jsynth.synthetic_frame(n_cams=6, w=48, h=48, subdiv=2, target_opacity=0.999,
                                                  raster_cfg=JAX_RCFG)
    target = dataclasses.replace(target, densities=jnp.full_like(target.densities, inverse_sigmoid(opacity)))
    gt = np.array(jd.gt_depths)
    if shift:
        gt = np.where(gt < 10, gt - 0.4, gt)
    jcfg = jtd.reference_mode(**KW) if reference else jtd.TopoDetectConfig(**KW)
    tcfg = bridge.config_from_fields(ttd.TopoDetectConfig, dataclasses.asdict(jcfg))
    verts = np.array(target.points)
    topo = build_topology(np.array(jc.faces), len(verts))

    jw = jtd.detect_topo_err(target, jc, jd.cameras, gt, topo, JAX_RCFG, jcfg)
    jt = jtd.last_telemetry
    tw = ttd.detect_topo_err(port_params(target), port_config(jc, len(verts)), port_cameras(jd.cameras), gt, topo,
                             RasterConfig(), tcfg)
    tt = ttd.last_telemetry

    assert tw.shape == jw.shape and tw.dtype == np.float64
    close = np.abs(tw - jw) <= w_tol
    assert close.mean() >= W_SHARE, f"{close.mean():.4f} of faces within {w_tol}"
    flag_diff = ((tw >= 0.6) != (jw >= 0.6)).mean()
    assert flag_diff <= FLAG_SHARE, f"flagged sets differ on {flag_diff:.4f} of faces"
    if shift:
        assert (jw >= 0.6).mean() > 0.3  # the case does flag
    # telemetry: per-camera coverage and observed share within one vertex
    # flip in a hundred, the flagged count within the flagged-set tolerance
    np.testing.assert_allclose(tt.coverage_per_cam, jt.coverage_per_cam, atol=0.01)
    assert abs(tt.observed_fraction - jt.observed_fraction) <= 0.01
    assert abs(tt.flagged_faces - jt.flagged_faces) <= FLAG_SHARE * len(jw) + 1
    assert (tt.n_cameras, tt.n_vertices) == (jt.n_cameras, jt.n_vertices)


def test_reference_mode_preset():
    kw = dict(min_observe=2, mesh_prop=5)
    assert dataclasses.asdict(ttd.reference_mode(**kw)) == dataclasses.asdict(jtd.reference_mode(**kw))
    assert dataclasses.asdict(ttd.TopoDetectConfig()) == dataclasses.asdict(jtd.TopoDetectConfig())
    assert ttd.TopoDetectConfig(**kw).as_reference_mode() == ttd.reference_mode(**kw)


def test_detection_leaves_trainee_untouched():
    """The solid-opacity override renders detached copies: the trainee's
    leaves keep their values and their graph."""
    _, jc, jd, target, _ = jsynth.synthetic_frame(n_cams=6, w=48, h=48, subdiv=2)
    params = port_params(target)
    before = {k: v.detach().clone() for k, v in params.named()}
    verts = np.array(target.points)
    ttd.detect_topo_err(params, port_config(jc, len(verts)), port_cameras(jd.cameras), np.array(jd.gt_depths),
                        build_topology(np.array(jc.faces), len(verts)), RasterConfig(), ttd.TopoDetectConfig(**KW))
    for k, v in params.named():
        assert v.requires_grad and v.grad is None
        assert bool((v.detach() == before[k]).all()), k
