"""The flow warp and face tracking, the port against the JAX package: the
geometry helpers (get_depth_edge and pad_and_resize_flow against OpenCV,
which the JAX package calls and the port does not), the vectorized robust
average against the JAX package's per-vertex loop, warp_mesh_using_flow on
tests/test_warp_tracking.py's scenes, and FaceTracker; and the port's warp
on the full-width sequence dataset's depths and flows."""

import sys
import os

import cv2
import numpy as np
import pytest

from gaustar_tpu.mesh.primitives import icosphere, uv_sphere
from gaustar_tpu.mesh.topology import build_topology
from gaustar_tpu.tools import geometry as jgeo
from gaustar_tpu.tools import warp_mesh as jwarp
from gaustar_tpu_torch.io import dataset as tds
from gaustar_tpu_torch.tools import geometry as tgeo
from gaustar_tpu_torch.tools import warp_mesh as twarp
from gaustar_tpu_torch.utils.synthetic import SEQ_CAMS, SEQ_CENTER, SEQ_SIZES, SEQ_WARP, sequence_geometry

sys.path.insert(0, os.path.dirname(__file__))
from test_warp_tracking import _plane_scene  # noqa: E402


def _depth(rng, h=64, w=80):
    """A sloped surface at 3-5 m with holes of invalid depth (999)."""
    yy, xx = np.mgrid[0:h, 0:w]
    d = (4.0 + 0.01 * xx - 0.005 * yy + rng.normal(scale=0.002, size=(h, w))).astype(np.float32)
    d[rng.uniform(size=d.shape) < 0.1] = 999.0
    d[10:20, 30:50] = 3.0
    return d


@pytest.mark.parametrize("ker", [3, 7, 9])
def test_get_depth_edge_matches_cv2_blur(ker):
    """Within 1e-5 x max of the cv2.blur version (the JAX package's):
    float64 window sums in another order than OpenCV's sliding sums."""
    d = _depth(np.random.default_rng(ker))
    ref = jgeo.get_depth_edge(d, ker)
    out = tgeo.get_depth_edge(d, ker)
    assert out.dtype == ref.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-5 * ref.max()
    x = d.astype(np.float32)
    assert np.abs(tgeo.box_mean(x, ker) - cv2.blur(x, (ker, ker))).max() <= 1e-5 * np.abs(x).max()


@pytest.mark.parametrize("shape,pad", [((96, 80), None), ((144, 120), None), ((100, 70), None),
                                       ((1031, 1611), (2, 3, 1, 4))], ids=["x2", "x3", "non-integer", "padded"])
def test_pad_and_resize_flow_equals_cv2(shape, pad):
    """Exactly cv2.resize(INTER_NEAREST)'s, through the JAX package's call."""
    rng = np.random.default_rng(0)
    src = (48, 40) if pad is None else (512, 800)
    f = rng.normal(size=(*src, 2)).astype(np.float32)[..., ::-1]
    pad = None if pad is None else np.asarray(pad)
    out = tgeo.pad_and_resize_flow(f, pad, shape)
    assert out.shape == (*shape, 2)
    np.testing.assert_array_equal(out, jgeo.pad_and_resize_flow(f, pad, shape))


def test_geometry_helpers_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.normal(scale=0.5, size=(200, 3)) + [0, 0, 4.0]
    intr = np.array([[90.0, 0, 0], [0, 95.0, 0], [0, 0, 1.0]])
    extr = np.eye(4)
    extr[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0] * np.array([1, 1, np.sign(1)])
    extr[:3, 3] = [0.1, -0.2, 0.3]
    shape = (64, 80)
    for a, b in zip(tgeo.project(pts, intr, extr, shape, True), jgeo.project(pts, intr, extr, shape, True)):
        np.testing.assert_array_equal(a, b)
    pix = rng.uniform(-2, 82, size=(200, 2))
    depth = rng.uniform(2, 6, 200)
    np.testing.assert_array_equal(tgeo.pixel_to_local_rays(pix, intr, shape), jgeo.pixel_to_local_rays(pix, intr, shape))
    np.testing.assert_array_equal(tgeo.pixels_to_points(pix, depth, intr, extr, shape),
                                  jgeo.pixels_to_points(pix, depth, intr, extr, shape))
    img = _depth(rng)
    for a, b in zip(tgeo.query_at_image(img, pix, True), jgeo.query_at_image(img, pix, True)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgeo.query_at_image_bilinear(img, pix, True), jgeo.query_at_image_bilinear(img, pix, True)):
        np.testing.assert_array_equal(a, b)
    verts, faces = icosphere(2)
    np.testing.assert_array_equal(tgeo.vertex_normals(verts, faces), jgeo.vertex_normals(verts, faces))
    topo = build_topology(faces, len(verts))
    val = rng.normal(size=(len(verts), 3))
    np.testing.assert_array_equal(tgeo.mesh_value_smoothing(topo.vert_adj, topo.vert_adj_count, val, 4),
                                  jgeo.mesh_value_smoothing(topo.vert_adj, topo.vert_adj_count, val, 4))
    obs = rng.normal(size=(9, 3))
    obs[2] += 5.0
    np.testing.assert_array_equal(tgeo.remove_outlier_mask(obs), jgeo.remove_outlier_mask(obs))


def _loop_average(move_total, visual_total, min_observe):
    """gaustar_tpu/tools/warp_mesh.py:121-135, the per-vertex loop."""
    cnt = visual_total.sum(axis=0)
    out = np.zeros((move_total.shape[1], 3))
    for vi in np.where(cnt >= min_observe)[0]:
        obs = move_total[visual_total[:, vi], vi]
        obs = obs[jgeo.remove_outlier_mask(obs)]
        cnt[vi] = len(obs)
        if len(obs) >= min_observe:
            out[vi] = obs.mean(axis=0)
    return out, cnt >= min_observe


@pytest.mark.parametrize("min_observe", [2, 4])
def test_robust_average_equals_the_loop(min_observe):
    """Exactly the loop's means and observed mask, outliers cut included."""
    rng = np.random.default_rng(min_observe)
    c, v = 9, 4000
    vis = rng.uniform(size=(c, v)) < 0.55
    move = rng.normal(scale=0.01, size=(c, v, 3))
    move[rng.uniform(size=(c, v)) < 0.1] += 0.15  # outliers
    move[~vis] = 0.0
    ref_avg, ref_obs = _loop_average(move, vis, min_observe)
    avg, obs = twarp.robust_average(move, vis, min_observe)
    assert 0.2 < ref_obs.mean() < 1.0
    np.testing.assert_array_equal(obs, ref_obs)
    np.testing.assert_array_equal(avg, ref_avg)


@pytest.mark.parametrize("corrupt", [False, True], ids=["translation", "bad-backward-flow"])
def test_warp_mesh_using_flow_matches_jax(corrupt):
    """tests/test_warp_tracking.py's plane scenes: the observed masks equal,
    the warped vertices within 1e-6 m. Inputs are equal, so every discrete
    decision is the same, and the moves come out bit-equal here."""
    verts, faces, cams, ff, fb, dc, dn, dx = _plane_scene()
    if corrupt:
        fb = [b * 0.0 + 30.0 for b in fb]
    kw = dict(min_observe=2, depth_agreement=0.01)
    jw = jwarp.warp_mesh_using_flow(verts.astype(np.float64), faces, cams, ff, fb, dc, dn, jwarp.WarpConfig(**kw))
    tw = twarp.warp_mesh_using_flow(verts.astype(np.float64), faces, cams, ff, fb, dc, dn, twarp.WarpConfig(**kw))
    np.testing.assert_array_equal(tw[2], jw[2])
    assert (tw[2].sum() == 0) == corrupt
    assert np.abs(tw[0] - jw[0]).max() <= 1e-6
    assert twarp.last_warp["observed_fraction"] == tw[2].mean()


def test_warp_on_a_sphere_with_noisy_flow_matches_jax():
    """A sphere seen by 12 cameras, with rendered-like depth maps and flows
    with outliers: many discrete decisions (depth agreement, normals, edges,
    bidirectional checks, the z-score cut), the same outcome."""
    rng = np.random.default_rng(7)
    verts, faces = icosphere(3, radius=0.5, center=(0, 0, 0))
    h = w = 64
    intr = np.array([[80.0, 0, 0], [0, 80.0, 0], [0, 0, 1.0]])
    cams = {"intrinsics": [], "extrinsics": [], "shape": []}
    ff, fb, dc, dn = [], [], [], []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for ci in range(12):
        a = 2 * np.pi * ci / 12
        pos = 2.5 * np.array([np.sin(a), 0.0, -np.cos(a)])
        z = -pos / np.linalg.norm(pos)
        x = np.cross([0, -1.0, 0], z)
        x /= np.linalg.norm(x)
        rot = np.stack([x, np.cross(z, x), z])  # rows: w2c rotation
        extr = np.eye(4)
        extr[:3, :3] = rot
        extr[:3, 3] = -rot @ pos
        # analytic sphere depth along each pixel ray
        rays = np.stack([(xx - w / 2) / 80.0, (yy - h / 2) / 80.0, np.ones_like(xx)], -1)
        o = -rot @ pos  # sphere centre in camera space
        b = (rays * o).sum(-1)
        disc = b * b - (rays * rays).sum(-1) * ((o * o).sum() - 0.25)
        t = (b - np.sqrt(np.maximum(disc, 0))) / (rays * rays).sum(-1)
        depth = np.where(disc > 0, t, 999.0).astype(np.float32)
        flow = np.zeros((h, w, 2), np.float32)
        flow[..., 1] = 0.6
        flow += rng.normal(scale=0.3, size=flow.shape).astype(np.float32) * (rng.uniform(size=(h, w, 1)) < 0.2)
        cams["intrinsics"].append(intr)
        cams["extrinsics"].append(extr)
        cams["shape"].append((h, w))
        ff.append(flow)
        fb.append(-flow + rng.normal(scale=0.05, size=flow.shape).astype(np.float32))
        dc.append(depth)
        dn.append(depth + rng.normal(scale=0.001, size=depth.shape).astype(np.float32))
    cams = {k: np.asarray(v) for k, v in cams.items()}
    kw = dict(min_observe=2, depth_agreement=0.1, edge_scalar=100.0, edge_threshold=0.7, depth_edge_ker_size=3)
    jw = jwarp.warp_mesh_using_flow(verts.astype(np.float64), faces, cams, ff, fb, dc, dn, jwarp.WarpConfig(**kw))
    tw = twarp.warp_mesh_using_flow(verts.astype(np.float64), faces, cams, ff, fb, dc, dn, twarp.WarpConfig(**kw))
    assert 0.05 < jw[2].mean() < 0.95, jw[2].mean()
    np.testing.assert_array_equal(tw[2], jw[2])
    assert np.abs(tw[0] - jw[0]).max() <= 1e-6


def test_face_tracker_matches_jax():
    """tests/test_warp_tracking.py's re-mesh, plus lost faces that snap to
    the nearest new face: the same ids and barycentrics."""
    verts, faces = icosphere(2, radius=1.0)
    centers = verts[faces].mean(axis=1)
    drop = np.argsort(-centers[:, 1])[:30]
    track = np.ones(len(faces), dtype=bool)
    track[drop] = False
    new_faces = np.concatenate([faces[track], faces[drop][:, ::-1]])
    new_verts = verts * 1.01
    outs = []
    for mod in (jwarp, twarp):
        tr = mod.FaceTracker.sample(len(faces), start=2, step=7)
        pos = tr.positions(verts, faces)
        tr.remap_after_update(pos, track, new_verts, new_faces)
        outs.append((tr.face_ids, tr.face_bary, tr.positions(new_verts, new_faces)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    tri = np.random.default_rng(1).normal(size=(10, 3, 3))
    p = tri.mean(axis=1)
    np.testing.assert_array_equal(twarp.barycentric_coords(tri, p), jwarp.barycentric_coords(tri, p))


def test_mesh_propagation_on_high_degree_poles():
    """A uv_sphere's poles pad the adjacency to their degree; with an
    isolated vertex and a signed field: smoothing and the BFS fill equal the
    JAX package's padded sums."""
    verts, faces = uv_sphere(17, 24)
    rng = np.random.default_rng(4)
    topo = build_topology(faces, len(verts) + 1)
    assert topo.vert_adj.shape[1] == 24 and topo.vert_adj_count[-1] == 0
    val = rng.normal(size=(len(verts) + 1, 3))
    args = (topo.vert_adj, topo.vert_adj_count)
    for iters in (1, 5):
        np.testing.assert_array_equal(tgeo.mesh_value_smoothing(*args, val, iters),
                                      jgeo.mesh_value_smoothing(*args, val, iters))
    valid = rng.uniform(size=len(val)) < 0.1
    valid[0] = True  # a pole
    for iters in (1, 3, 20):
        np.testing.assert_array_equal(tgeo.mesh_vert_propagate(*args, valid, val * valid[:, None], iters),
                                      jgeo.mesh_vert_propagate(*args, valid, val * valid[:, None], iters))


def test_warp_observes_the_full_width_sequence_dataset(tmp_path):
    """The warp of the frame-0 sphere (100,000 faces) over the full-width
    sequence dataset's 8 cameras, as run_sequence loads them: on the
    sphere's analytic depth, as on a mesh render's, the gates pass, so the
    robust average rests on observations (not on propagation alone), the
    observed vertices move by dx and the warped mesh lies on frame 1's
    sphere. Deterministic float64 host code; the bounds hold the values
    printed here within a few per cent."""
    root = str(tmp_path)
    info = sequence_geometry(root, "full")
    cmr = tds.load_rgb_cameras(os.path.join(root, "rgb_cameras.npz"))
    shape = tuple(cmr["shape"][0])
    depths = [list(tds.load_frame_depths(root, f, SEQ_CAMS)) for f in (0, 1)]
    flows = tds.load_frame_flows(root, 0, SEQ_CAMS, 1, shape=shape)
    verts, dx = info["verts"].astype(np.float64), info["dx"]
    warped, move, observed = twarp.warp_mesh_using_flow(verts, info["faces"], cmr, *flows, *depths,
                                                        twarp.WarpConfig(**SEQ_WARP))
    radius = SEQ_SIZES["full"][1]
    off = [np.median(np.abs(np.linalg.norm(v - np.add(SEQ_CENTER, (dx, 0, 0)), axis=1) - radius))
           for v in (warped, verts)]
    median_obs, median_all = np.median(move[observed, 0]) / dx, np.median(move[:, 0]) / dx
    print(f"observed {observed.mean():.4f}; median x-move {median_obs:.4f} dx observed, {median_all:.4f} dx all, "
          f"mean {move[:, 0].mean() / dx:.4f} dx; median |r - {radius}| about frame 1's centre {off[0]:.6f} m "
          f"warped, {off[1]:.6f} m unwarped; visible per camera {twarp.last_warp['visible_per_camera']}")
    assert 0.45 <= observed.mean() <= 0.5
    assert 0.95 <= median_obs <= 1.05 and 0.9 <= median_all <= 1.05
    assert off[0] < 0.05 * off[1]
