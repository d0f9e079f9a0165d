"""refscale.frame against the JAX script's train_frame (examples/
refscale_frame.py, loaded by tests/port_examples.py) with the same camera
draws: a 400-iteration refine on the widened rig (12 cameras at 96x96, the
dent in the GT) of an icosphere trainee, detection, fusion, the surgery and
the 200-iteration re-refine on the updated mesh. The JAX side runs the
script's runner (its rasterizer as impl="jax") and, for the event, the
calls of the script's main with this scale's settings, given to both
packages alike.

- The refine: segment loss sums (segment 0 at rtol 1e-3, the rest at
  SEGMENT_RTOL) and parameters within 2 sum(lr) (Adam at eps 1e-15 steps
  about lr in the sign of float noise).
- frame.run's own event: the flagged face set and cc_update_num of the
  JAX run's. Its updated mesh is not compared: the decimation turns the
  two trajectories' float differences into other meshes.
- The event on one model, the JAX run's: the port's detection, fusion
  undecimated and surgery give the JAX package's flagged face set,
  cc_update_num, updated face count and tracked faces.
- The re-refine on one updated mesh, frame.run's: its segment loss sums
  and parameters against the script's re-refine with the same draws.

At this size the trainee is an 80-face icosphere: the plain blend's CPU
step costs about 0.25 s at 480 gaussians and grows with the longest tile
list. Such a mesh misses the sphere by centimetres, so detection here
flags the faces the refine has not fitted (depth scalar 0.5) rather than
the 13 cm dent."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu_torch.mesh.primitives import icosphere
from gaustar_tpu_torch.models import sugar
from gaustar_tpu_torch.ops.rasterizer import RasterConfig
from gaustar_tpu_torch.refscale import frame, scenes
from gaustar_tpu_torch.train import refine
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_lr_fn
from gaustar_tpu_torch.train.topo_detect import TopoDetectConfig
from gaustar_tpu_torch.utils import synthetic
from port_examples import load_example
from port_helpers import one_thread  # noqa: F401  (autouse)
from port_native import jax_native

ITERS = 400
N_CAMS, W, FOCAL = 12, 96, 200.0
# The scene's tile lists hold at most 90 pairs and a view 1,720 pairs (the
# rig and the fusion views, at initialisation): these capacities leave the
# JAX blend room to grow, and its static work per step small.
JAX_RCFG = JaxRasterConfig(max_pairs=1 << 13, chunk=32, max_per_tile=512, impl="jax")
DETECT = dict(depth_scalar=0.5, min_observe=2, mesh_prop=10, detect_floor=False, depth_agreement=0.05,
              edge_threshold=0.6, edge_scalar=10.0, voxel_size=0.05)
FUSION = dict(voxel_size=0.05, sdf_trunc=0.15, max_dim=512, simplify_face_num=300)
# The event compared on one model: the decimation's greedy collapses turn
# the fused vertices' float differences into other meshes (on the same
# model 143 faces after the surgery against the JAX package's 126), so
# there the fused mesh is grafted undecimated, as tests/test_torch_sequence.py
# grafts it.
FUSION_EXACT = dict(FUSION, simplify_face_num=0)
UPDATE = dict(force_watertight=False, cc_face_threshold=5, boundary_pad=0.12)
# Segment loss sums: the first segment (sh degree 0) at rtol 1e-3; the later
# ones at SEGMENT_RTOL. From the SH band's first step on, Adam at eps 1e-15
# turns float noise into lr-sized steps: the JAX run itself, its initial
# points moved by 1e-7, gives segment sums 1.7e-3-2.1e-3 apart (segment 0:
# 7.7e-5), and the port lies 4.4e-3 from it at most.
SEGMENT_RTOL = 1e-2


def _mesh():
    """(verts, faces, colours, the trainee's initial points): the points
    start off the mesh's rest state, as in test_torch_refine.py. At it every
    face area equals its reference and the area-iso term |area - ref| sits
    on its kink, where the sign of the gradient is float noise (the JAX
    package's jitted areas differ from the reference by ULPs, the port's do
    not), and Adam turns that sign into lr-sized steps: from the rest state
    the two packages' losses part by 2% at the third iteration, from 2 mm
    off it they agree within 1e-6 over the first four."""
    verts, faces = icosphere(1, radius=0.6, center=(0.0, 0.0, 4.0))
    colors = np.random.default_rng(0).uniform(0.2, 0.9, size=(len(verts), 3)).astype(np.float32)
    points = verts + np.random.default_rng(11).normal(scale=2e-3, size=verts.shape).astype(np.float32)
    return verts, faces, colors, points


def _jax_scene(monkeypatch):
    """bench.build_scene's construction at this size, widened by the
    script's widen_rig (ring cameras at FOCAL)."""
    import jax.numpy as jnp

    from gaustar_tpu.cameras import stack_cameras
    from gaustar_tpu.mesh.topology import build_topology
    from gaustar_tpu.models import sugar as jsugar
    from gaustar_tpu.ops.losses import edge_lengths, face_areas_normals
    from gaustar_tpu.train.refine import FrameData, compute_margins, with_face_edge_tables
    from gaustar_tpu.utils import synthetic as jsyn

    verts, faces, colors, points = _mesh()
    params, config = jsugar.init_sugar(verts, faces, vertex_colors=colors)
    params = dataclasses.replace(params, points=jnp.asarray(points))
    batch = stack_cameras(jsyn.ring_cameras(4, w=W, h=W, focal=FOCAL))
    topo = build_topology(np.asarray(faces), len(verts))
    data = FrameData(
        cameras=batch, gt_images=jnp.zeros((4, W, W, 3)), gt_depths=jnp.zeros((4, W, W)),
        margins=jnp.asarray(compute_margins(np.asarray(batch.cx), np.asarray(batch.cy), W, W)),
        ref_edge_len=edge_lengths(jnp.asarray(verts), jnp.asarray(topo.edges)),
        ref_area=face_areas_normals(jnp.asarray(verts), jnp.asarray(faces))[0],
        edges=jnp.asarray(topo.edges), adj_faces=jnp.asarray(topo.adj_faces))
    data = with_face_edge_tables(data, faces)
    ns = load_example("refscale_frame", W=W, H=W, N_CAMS=N_CAMS, BATCH=1)
    ring = jsyn.ring_cameras
    monkeypatch.setattr(jsyn, "ring_cameras", lambda n, w, h, **_: ring(n, w=w, h=h, focal=FOCAL))
    return ns, params, config, ns["widen_rig"](data)


def _jax_frame(ns, params, config, data):
    """The script's main (refscale_frame.py:223-369) up to the surgery,
    without its probes, prewarm and timers, at this scale's settings; also
    the surgery on the undecimated fusion (FUSION_EXACT) and the camera
    generator as the refine left it."""
    from gaustar_tpu.mesh.topology import build_topology
    from gaustar_tpu.train import mesh_update
    from gaustar_tpu.train.refine import RefineConfig
    from gaustar_tpu.train.topo_detect import TopoDetectConfig as JaxDetect
    from gaustar_tpu.train.topo_detect import detect_topo_err

    report = {}
    rng = np.random.default_rng(0)
    cfg = RefineConfig(num_iterations=ITERS, loose_bind_from=ITERS // 2, do_sh_warmup=True)
    params, _ = ns["train_frame"](params, config, data, JAX_RCFG, cfg, ITERS, rng, "refine", report)
    topo = build_topology(np.asarray(config.faces), params.points.shape[0])
    face_w = detect_topo_err(params, config, data.cameras, np.asarray(data.gt_depths), topo, JAX_RCFG,
                             JaxDetect(**DETECT))
    fusion = mesh_update.extract_mesh_fusion(params, config, data.cameras, JAX_RCFG, **FUSION)
    out = mesh_update.update_mesh_with_fusion(params, config, fusion, face_w, **UPDATE)
    fused_exact = mesh_update.extract_mesh_fusion(params, config, data.cameras, JAX_RCFG, **FUSION_EXACT)
    return {"report": report, "params": params, "face_w": np.asarray(face_w), "update": out, "data": data,
            "rng_re": copy.deepcopy(rng),
            "update_exact": mesh_update.update_mesh_with_fusion(params, config, fused_exact, face_w, **UPDATE)}


def _jax_re_refine(ns, jax_side, update):
    """The script's re-refine (refscale_frame.py:370-400) on `update`, with
    the camera generator as the JAX run left it after its refine."""
    import jax.numpy as jnp

    from gaustar_tpu.mesh.topology import build_topology
    from gaustar_tpu.models import sugar as jsugar
    from gaustar_tpu.ops.losses import edge_lengths
    from gaustar_tpu.train.refine import FrameData, RefineConfig, compute_margins
    from gaustar_tpu.train.sequence import _face_colors_to_vertex

    data = jax_side["data"]
    um = update["updated_mesh"]
    verts2, faces2 = um.verts.astype(np.float32), um.faces.astype(np.int32)
    topo2 = build_topology(faces2, len(verts2))
    el2 = np.asarray(edge_lengths(jnp.asarray(verts2), jnp.asarray(topo2.edges)))
    params2, config2 = jsugar.init_sugar(verts2, faces2, vertex_colors=_face_colors_to_vertex(um),
                                         min_scale=float(el2.mean()) * 0.1, max_scale=float(el2.mean()) * 5.0)
    margins = compute_margins(np.asarray(data.cameras.cx), np.asarray(data.cameras.cy), W, W)
    data2 = FrameData(
        cameras=data.cameras, gt_images=data.gt_images, gt_depths=data.gt_depths, margins=jnp.asarray(margins),
        ref_edge_len=jnp.asarray(el2), ref_area=jnp.asarray(np.asarray(update["new_ref_area"], np.float32)),
        edges=jnp.asarray(topo2.edges), adj_faces=jnp.asarray(topo2.adj_faces))
    cfg2 = RefineConfig(num_iterations=ITERS // 2, edge_iso_from=999_999, loose_bind_from=10**9, do_sh_warmup=True)
    report = {}
    params2, _ = ns["train_frame"](params2, config2, data2, JAX_RCFG, cfg2, ITERS // 2, jax_side["rng_re"],
                                   "re_refine", report)
    return report["re_refine"], params2


def _port_data():
    verts, faces, colors, points = _mesh()
    params, config = sugar.init_sugar(verts, faces, vertex_colors=colors, device="cpu")
    with torch.no_grad():
        params.points.copy_(torch.as_tensor(points))
    cams = synthetic.ring_cameras(4, w=W, h=W, focal=FOCAL, device="cpu")
    data = synthetic._frame_data(verts, faces, cams, np.zeros((4, W, W, 3), np.float32),
                                 np.zeros((4, W, W), np.float32), "cpu")
    return params, config, scenes.reference_rig(refine.with_face_edge_tables(data, faces), N_CAMS, W, W, FOCAL)


def _port_event(jax_side, config, data):
    """The port's detection, fusion (FUSION_EXACT) and surgery, the calls
    frame.run makes, on the JAX run's refined model."""
    from gaustar_tpu_torch.mesh.topology import build_topology
    from gaustar_tpu_torch.train import mesh_update, topo_detect
    from port_helpers import port_sugar

    params, config = port_sugar(jax_side["params"], config)
    topo = build_topology(config.faces.numpy(), params.points.shape[0])
    face_w = topo_detect.detect_topo_err(params, config, data.cameras, data.gt_depths, topo, RasterConfig(),
                                         TopoDetectConfig(**DETECT))
    fused = mesh_update.extract_mesh_fusion(params, config, data.cameras, RasterConfig(), **FUSION_EXACT)
    return {"face_w": face_w, "update": mesh_update.update_mesh_with_fusion(params, config, fused, face_w, **UPDATE)}


def _port_frame(params, config, data, monkeypatch):
    """frame.run with this scale's detection, fusion and surgery settings."""
    monkeypatch.setattr(frame, "DETECT", TopoDetectConfig(**DETECT))
    monkeypatch.setattr(frame, "FUSION", FUSION)
    monkeypatch.setattr(frame, "UPDATE", UPDATE)
    return frame.run(params, config, data, RasterConfig(), ITERS, log=lambda *_: None)


def _within_lr(port, jax_params, iters, points):
    """Each group of `port` within 2 sum(lr) of the JAX run's; the scale of
    the position lr as train_frame derives it from the initial `points`."""
    radius = float(np.linalg.norm(points.max(0) - points.min(0)) / 2.0)
    n_faces = len(port.sh_dc) // 6
    lr_fn = make_lr_fn(OptimizationParams(iterations=iters), 10.0 * radius / np.sqrt(n_faces))
    lr_sum = {k: sum(lr_fn(c)[k] for c in range(iters)) for k in lr_fn(0)}
    for name, t in port.named():
        diff = float(np.abs(t.detach().numpy() - np.asarray(getattr(jax_params, name))).max())
        assert diff <= 2 * lr_sum[name] * (1 + 1e-5), f"{name}: {diff} > 2 * {lr_sum[name]}"


@pytest.fixture(scope="module")
def both(request):
    """(the JAX run, with its re-refine on the port run's update; frame.run;
    the port's event on the JAX run's model)."""
    jax_native()  # the JAX run decimates its fused mesh natively
    mp = pytest.MonkeyPatch()
    request.addfinalizer(mp.undo)
    ns, jp, jc, jd = _jax_scene(mp)
    jax_side = _jax_frame(ns, jp, jc, jd)
    params, config, data = _port_data()
    port = _port_frame(params, config, data, mp)
    jax_side["re_refine"], jax_side["re_params"] = _jax_re_refine(ns, jax_side, port["update"])
    return jax_side, port, _port_event(jax_side, config, data)


def _sums(record):
    return [s["loss_sum"] for s in record["segments"]]


def test_refine_segments_and_parameters_match_jax(both):
    jax_side, port, _ = both
    assert [s["iters"] for s in port["report"]["refine"]["segments"]] == [ITERS // 4] * 4
    got, want = _sums(port["report"]["refine"]), _sums(jax_side["report"]["refine"])
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=SEGMENT_RTOL)
    _within_lr(port["params"], jax_side["params"], ITERS, _mesh()[3])


def test_frame_flags_and_grafts_as_jax(both):
    """frame.run's own event: the flagged faces and the surgery's decision
    equal the JAX run's."""
    jax_side, port, _ = both
    flagged = port["face_w"] >= frame.FLAG
    np.testing.assert_array_equal(flagged, jax_side["face_w"] >= frame.FLAG)
    assert 0 < flagged.sum() < len(flagged)
    assert port["report"]["cc_update_num"] == int(jax_side["update"]["cc_update_num"]) >= 1


def test_event_on_the_same_model_matches_jax(both):
    """On the JAX run's refined model the port's detection, fusion (not
    decimated, FUSION_EXACT) and surgery give the flagged face set,
    cc_update_num, updated face count and tracked-face mask of the JAX
    package's."""
    jax_side, _, event = both
    want = jax_side["update_exact"]
    np.testing.assert_array_equal(event["face_w"] >= frame.FLAG, jax_side["face_w"] >= frame.FLAG)
    assert event["update"]["cc_update_num"] == want["cc_update_num"] >= 1
    assert len(event["update"]["updated_mesh"].faces) == len(want["updated_mesh"].faces)
    np.testing.assert_array_equal(event["update"]["track_face_mask"], want["track_face_mask"])


def test_re_refine_matches_jax_on_the_same_update(both):
    """frame.run's re-refine against the script's on frame.run's updated
    mesh, the same camera draws."""
    jax_side, port, _ = both
    got, want = _sums(port["report"]["re_refine"]), _sums(jax_side["re_refine"])
    assert [s["iters"] for s in port["report"]["re_refine"]["segments"]] == [ITERS // 8] * 4
    assert port["report"]["updated_faces"] == len(port["update"]["updated_mesh"].faces)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    np.testing.assert_allclose(got, want, rtol=SEGMENT_RTOL)
    _within_lr(port["re_params"], jax_side["re_params"], ITERS // 2,
               port["update"]["updated_mesh"].verts.astype(np.float32))
