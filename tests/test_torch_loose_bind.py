"""The port's refine_frame with the topology-detection hook against the JAX
package's: the same 48x48 synthetic frame (480 gaussians, 4 cameras), the
same stub hook (face weights 1 on one side of the sphere), 8 iterations
with detection at 4. Both loose-bind at the same iteration, and their losses
and parameters track at test_torch_refine.py's tolerances."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from gaustar_tpu.train import refine as jrefine
from gaustar_tpu.utils import synthetic as jsynth
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.train import refine as trefine
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_lr_fn
from port_helpers import one_thread  # noqa: F401  (autouse)


ITERS, LOOSE_FROM = 8, 4


@pytest.fixture(scope="module")
def frame():
    jp, jc, jd, _, rcfg = jsynth.synthetic_frame()
    # off the mesh's rest state, as in test_torch_refine.py
    rng = np.random.default_rng(11)
    jp = dataclasses.replace(
        jp, points=jp.points + jnp.asarray(rng.normal(scale=2e-3, size=jp.points.shape), jnp.float32))
    params = {f.name: np.array(getattr(jp, f.name)) for f in dataclasses.fields(jp)}
    config = dict(faces=np.array(jc.faces), bary=np.array(jc.bary), thickness=np.array(jc.thickness),
                  n_gaussians_per_face=jc.n_gaussians_per_face, sh_levels=jc.sh_levels,
                  min_scale=jc.min_scale, max_scale=jc.max_scale, n_verts=len(params["points"]))
    cams = {k: np.array(getattr(jd.cameras, k)) for k in ("R", "T", "fx", "fy", "cx", "cy")}
    cams.update(width=jd.cameras.width, height=jd.cameras.height)
    data = {k: np.array(getattr(jd, k)) for k in ("gt_images", "gt_depths", "margins", "ref_edge_len",
                                                 "ref_area", "edges", "adj_faces")}
    data["cameras"] = cams
    port = (bridge.sugar_params_from_numpy(params, "cpu"), bridge.sugar_config_from_numpy(config, "cpu"),
            bridge.frame_data_from_numpy(data, "cpu"))
    pts = params["points"]
    centroid_x = pts[config["faces"]].mean(axis=1)[:, 0]
    face_w = np.where(centroid_x > 0.25, 1.0, 0.3 * np.clip(centroid_x, 0.0, None))  # float64
    lr_scale = 10.0 * float(np.linalg.norm(pts.max(0) - pts.min(0)) / 2.0) / np.sqrt(len(config["faces"]))
    return dict(jax=(jp, jc, jd, rcfg), port=port, face_w=face_w, lr_scale=lr_scale)


def _hooked(face_w):
    """(hook, log_fn, calls): the hook records the iteration it runs before,
    counted from log_fn (log_every=1)."""
    calls, done = [], [0]

    def log_fn(entry):
        if "loss" in entry:
            done[0] += 1

    def hook(params, config):
        calls.append(done[0] + 1)
        return face_w

    return hook, log_fn, calls


@pytest.mark.parametrize("threshold", [100, 10**6], ids=["unbinds", "below_threshold"])
def test_loose_bind_transition_matches_jax(frame, threshold):
    jp, jc, jd, rcfg = frame["jax"]
    tp, tc, td = frame["port"]
    n_flagged = 6 * int((frame["face_w"] == 1.0).sum())
    assert 100 <= n_flagged < 10**6
    kw = dict(num_iterations=ITERS, loose_bind_from=LOOSE_FROM, unbind_threshold=threshold)
    jhook, jlog, jcalls = _hooked(frame["face_w"])
    thook, tlog, tcalls = _hooked(frame["face_w"])
    scale = frame["lr_scale"]
    jout, jcfg, jhist = jrefine.refine_frame(jp, jc, jd, jrefine.RefineConfig(**kw), rcfg, spatial_lr_scale=scale,
                                             detect_topo_fn=jhook, log_every=1, log_fn=jlog)
    tout, tcfg, thist = trefine.refine_frame(tp, tc, td, trefine.RefineConfig(**kw), spatial_lr_scale=scale,
                                             detect_topo_fn=thook, log_every=1, log_fn=tlog)
    assert jcalls == tcalls == [LOOSE_FROM]
    assert tcfg.loose_bind == jcfg.loose_bind == (threshold == 100)
    assert not tc.loose_bind  # the caller's config is left as it was
    np.testing.assert_allclose([h["loss"] for h in thist], [h["loss"] for h in jhist], rtol=1e-3)
    lr_fn = make_lr_fn(OptimizationParams(iterations=ITERS), scale)
    lr_sum = {k: sum(lr_fn(c)[k] for c in range(ITERS)) for k in lr_fn(0)}
    for name, p in tout.named():
        diff = np.abs(p.detach().numpy() - np.asarray(getattr(jout, name))).max()
        assert diff <= 2 * lr_sum[name] * (1 + 1e-5), f"{name}: {diff} > 2 * {lr_sum[name]}"
    moved = float(np.abs(tout.delta_t.detach().numpy()).max())
    assert (moved > 0) == (threshold == 100)  # the deltas train only once loose-bound
