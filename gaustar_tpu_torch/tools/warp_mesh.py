"""Flow-guided mesh warping: initialize frame t+1's mesh from frame t
(counterpart of gaustar_tpu/tools/warp_mesh.py; gaustar_tools/warp_mesh.py:
216-402).

Per camera: project the vertices, test visibility (depth agreement < 5 mm,
view-facing normal, off depth edges), advect the pixel by the forward optical
flow, check bidirectional flow consistency (4 px / 4 mm), lift by the next
frame's depth to a 3D motion vector (capped at 0.2 m); then a per-vertex
z-score-outlier-robust average over >= 4 observing cameras, BFS propagation
to unobserved vertices over the mesh graph, and 5 rounds of neighbour-average
smoothing -> warp_smooth vertices.

Every stage runs on the host in float64, as in the JAX package: the
thresholds are discrete decisions, and equal inputs give equal observed
masks. The robust average, a Python loop over every observed vertex in the
JAX package, is one pass over the [C, V] stacks here with the same result
per vertex: masked sums over the cameras add exact zeros for the cameras
that do not observe a vertex, so they equal numpy's sums over the observing
rows alone.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from gaustar_tpu_torch.mesh.topology import MeshTopology, build_topology
from gaustar_tpu_torch.tools import geometry as geo

#: What the most recent warp_mesh_using_flow call did: {"observe_ms" (the
#: per-camera observations), "average_ms" (robust average, propagation and
#: smoothing), host clock; "visible_per_camera" (the fraction of vertices
#: that pass every gate of each camera), "observed_fraction"}.
last_warp: dict | None = None


@dataclasses.dataclass(frozen=True)
class WarpConfig:
    """warp_config (warp_mesh.py:14-45)."""

    min_observe: int = 4
    depth_edge_ker_size: int = 7
    knn_k: int = 8
    cmr_view_max_cos: float = -0.5
    max_move_dist: float = 0.2
    voxel_size: float = 0.04
    bi_direct_pix_threshold: float = 4.0
    bi_direct_depth_threshold: float = 0.004
    edge_scalar: float = 10000.0
    edge_threshold: float = 0.1
    post_processing: str = "mesh"  # 'mesh' | 'voxel'
    depth_agreement: float = 0.005
    smooth_iters: int = 5


def warp_vertex_observations(
    verts: np.ndarray,
    faces: np.ndarray,
    intr: np.ndarray,
    extr: np.ndarray,
    shape,
    flow_f: np.ndarray,  # [H, W, 2] (row, col) displacement, full-res
    flow_b: np.ndarray,
    depth_cur: np.ndarray,
    depth_next: np.ndarray,
    cfg: WarpConfig,
):
    """One camera's vertex motion observations (warp_mesh.py:259-340).
    Returns (vert_move [V, 3], visible [V])."""
    edge_cur = geo.get_depth_edge(depth_cur, cfg.depth_edge_ker_size)
    edge_next = geo.get_depth_edge(depth_next, cfg.depth_edge_ker_size)

    pix_cur, local = geo.project(verts, intr, extr, shape, return_local_points=True)
    pix_depth_cur, valid = geo.query_at_image(depth_cur, pix_cur, return_valid=True)

    # Camera-view vertex normals: z component of the normal in camera frame.
    local_normals = geo.vertex_normals(local, faces)
    depth_diff = np.abs(local[..., 2] - pix_depth_cur)
    visual = valid & (depth_diff < cfg.depth_agreement) & (local_normals[..., 2] < cfg.cmr_view_max_cos)

    edge_vis = np.minimum(edge_cur / max(edge_cur.max(), 1e-12) * cfg.edge_scalar, 1)
    visual &= geo.query_at_image(edge_vis, pix_cur) < cfg.edge_threshold

    pix_next = pix_cur + geo.query_at_image(flow_f, pix_cur)

    # Bidirectional consistency.
    pix_cur_back = pix_next + geo.query_at_image(flow_b, pix_next)
    pix_depth_back = geo.query_at_image(depth_cur, pix_cur_back)
    visual &= np.abs(pix_depth_back - pix_depth_cur) < cfg.bi_direct_depth_threshold
    visual &= np.linalg.norm(pix_cur_back - pix_cur, axis=-1) < cfg.bi_direct_pix_threshold

    edge_vis_next = np.minimum(edge_next / max(edge_next.max(), 1e-12) * cfg.edge_scalar, 1)
    visual &= geo.query_at_image(edge_vis_next, pix_next) < cfg.edge_threshold

    pix_depth_next, valid_n = geo.query_at_image(depth_next, pix_next, return_valid=True)
    visual &= valid_n & (pix_depth_next < 10)

    moved = geo.pixels_to_points(pix_next, pix_depth_next, intr, extr, shape)
    vert_move = moved - verts
    visual &= np.linalg.norm(vert_move, axis=-1) < cfg.max_move_dist
    vert_move[~visual] = 0.0
    return vert_move, visual


def robust_average(move_total: np.ndarray, visual_total: np.ndarray, min_observe: int, threshold: float = 2.0):
    """The per-vertex z-score-robust mean of the observing cameras' moves
    (warp_mesh.py:349-358) for all vertices at once. `move_total` [C, V, 3]
    is 0 where `visual_total` [C, V] is False. Returns (move_avg [V, 3],
    observed [V]): a vertex seen by >= min_observe cameras keeps the
    observations whose three z-scores (population std over the observing
    cameras) are below `threshold`, and is observed if >= min_observe remain.

    Per vertex this is geometry.remove_outlier_mask and numpy's mean over the
    observing rows: the sums run over the camera axis in order, and a
    non-observing camera adds an exact zero."""
    v = move_total.shape[1]
    cnt = visual_total.sum(axis=0)
    cand = np.flatnonzero(cnt >= min_observe)
    x = move_total[:, cand]  # [C, K, 3]
    m = visual_total[:, cand][..., None]
    n = cnt[cand][:, None].astype(np.float64)
    mean = (x * m).sum(axis=0) / n
    dev = (x - mean) * m
    std = np.sqrt((dev * dev).sum(axis=0) / n)
    z = (x - mean) / np.maximum(std, 1e-12)
    keep = m[..., 0] & ((z < threshold).sum(axis=-1) == 3)
    n_keep = keep.sum(axis=0)
    ok = n_keep >= min_observe
    move_avg = np.zeros((v, 3))
    with np.errstate(invalid="ignore", divide="ignore"):
        kept_mean = (x * keep[..., None]).sum(axis=0) / n_keep[:, None]
    move_avg[cand[ok]] = kept_mean[ok]
    observed = np.zeros(v, bool)
    observed[cand[ok]] = True
    return move_avg, observed


def warp_mesh_using_flow(
    verts: np.ndarray,
    faces: np.ndarray,
    cameras: dict,  # {'intrinsics': [C,3,3], 'extrinsics': [C,3|4,4], 'shape': [C,2]}
    flows_f: list[np.ndarray],
    flows_b: list[np.ndarray],
    depths_cur: list[np.ndarray],
    depths_next: list[np.ndarray],
    cfg: WarpConfig = WarpConfig(),
    topo: MeshTopology | None = None,
):
    """Warp all vertices to the next frame (warp_mesh.py:216-402).
    Returns (warped_verts, vert_move, observed_mask)."""
    global last_warp
    intr = cameras["intrinsics"]
    extr = cameras["extrinsics"]
    shape = cameras["shape"]
    n_cams = len(flows_f)
    v = len(verts)

    t0 = time.perf_counter()
    move_total = np.zeros((n_cams, v, 3))
    visual_total = np.zeros((n_cams, v), dtype=bool)
    for ci in range(n_cams):
        move_total[ci], visual_total[ci] = warp_vertex_observations(
            verts, faces, intr[ci], extr[ci], shape[ci],
            flows_f[ci], flows_b[ci], depths_cur[ci], depths_next[ci], cfg,
        )
    t1 = time.perf_counter()

    move_avg, observed = robust_average(move_total, visual_total, cfg.min_observe)
    if topo is None:
        topo = build_topology(faces, v)
    if cfg.post_processing == "voxel":
        centers, vals = geo.build_voxel_from_pc(verts[observed], move_avg[observed], cfg.voxel_size)
        move_avg = geo.interpolate_in_voxel(verts, centers, vals, cfg.voxel_size, cfg.knn_k)
    else:  # 'mesh'
        move_avg = geo.mesh_vert_propagate(topo.vert_adj, topo.vert_adj_count, observed, move_avg, max_ite=20)
    move_avg = geo.mesh_value_smoothing(topo.vert_adj, topo.vert_adj_count, move_avg, ite_num=cfg.smooth_iters)
    last_warp = {"observe_ms": 1e3 * (t1 - t0), "average_ms": 1e3 * (time.perf_counter() - t1),
                 "visible_per_camera": visual_total.mean(axis=1).tolist() if v else [0.0] * n_cams,
                 "observed_fraction": float(observed.mean()) if v else 0.0}
    return verts + move_avg, move_avg, observed


# ---------------------------------------------------------------------------
# Face tracking through re-meshes (gaustar_tools/tracking_util.py:34-148)
# ---------------------------------------------------------------------------


def barycentric_coords(tri_verts: np.ndarray, points: np.ndarray) -> np.ndarray:
    """[..., 3, 3] triangles, [..., 3] points -> barycentric [..., 3]."""
    a, b, c = tri_verts[..., 0, :], tri_verts[..., 1, :], tri_verts[..., 2, :]
    v0 = b - a
    v1 = c - a
    v2 = points - a
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    d20 = (v2 * v0).sum(-1)
    d21 = (v2 * v1).sum(-1)
    denom = np.maximum(d00 * d11 - d01 * d01, 1e-20)
    w1 = (d11 * d20 - d01 * d21) / denom
    w2 = (d00 * d21 - d01 * d20) / denom
    return np.stack([1.0 - w1 - w2, w1, w2], axis=-1)


@dataclasses.dataclass
class FaceTracker:
    """Propagates (face_id, barycentric) samples across frames and re-meshes."""

    face_ids: np.ndarray  # [K]
    face_bary: np.ndarray  # [K, 3]

    @staticmethod
    def sample(n_faces: int, start=10, step=200) -> "FaceTracker":
        ids = np.arange(start, n_faces, step)[:-1]
        return FaceTracker(ids.copy(), np.full((len(ids), 3), 1.0 / 3.0))

    def positions(self, verts, faces) -> np.ndarray:
        tv = verts[faces[self.face_ids]]
        return (tv * self.face_bary[..., None]).sum(axis=1)

    def remap_after_update(self, positions, track_face_mask, new_verts, new_faces):
        """Carry samples through a re-mesh (tracking_util.py:89-126): tracked
        faces map by prefix rank; lost faces snap to the nearest new face center
        with clamped barycentrics."""
        new_centers = new_verts[new_faces].mean(axis=1)
        prefix = np.cumsum(track_face_mask) - track_face_mask.astype(int)
        for i in range(len(self.face_ids)):
            fid = self.face_ids[i]
            mapped = False
            if fid < len(track_face_mask) and track_face_mask[fid]:
                new_fid = int(prefix[fid])
                bary = barycentric_coords(new_verts[new_faces[new_fid]][None], positions[None, i])[0]
                if (bary >= 0).all():
                    self.face_ids[i] = new_fid
                    self.face_bary[i] = bary
                    mapped = True
            if not mapped:
                new_fid = int(np.argmin(np.linalg.norm(new_centers - positions[i], axis=-1)))
                bary = barycentric_coords(new_verts[new_faces[new_fid]][None], positions[None, i])[0]
                bary = np.maximum(bary, 0)
                bary = bary / bary.sum()
                self.face_ids[i] = new_fid
                self.face_bary[i] = bary
