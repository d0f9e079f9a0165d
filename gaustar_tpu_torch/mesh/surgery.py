"""Local re-meshing (topology update), host-side mesh surgery (numpy copy
of gaustar_tpu/mesh/surgery.py).

A trimesh/open3d-free port of gaustar_trainers/refined_mesh.py:84-693:
update_mesh_topo cuts the base (tracked) mesh outside changed regions, cuts the
TSDF fusion mesh inside them, snaps the two boundary rings together by mutual
nearest neighbors, merges duplicate vertices, repairs small holes, and keeps
face-level tracking identity for the surviving base faces (track_face_mask +
new_ref_area bookkeeping consumed by tracking_util and the next refine).

Face-order invariants mirror the reference exactly: masking keeps relative face
order; connection concatenates [base faces..., fusion faces...]; the tracked
faces therefore stay a prefix across repeated regional updates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from gaustar_tpu_torch.mesh.topology import build_topology, face_connected_components


@dataclasses.dataclass
class Mesh:
    """Minimal host mesh (trimesh stand-in)."""

    verts: np.ndarray  # [V, 3] float64
    faces: np.ndarray  # [F, 3] int64
    face_colors: np.ndarray | None = None  # [F, 3-4]

    def copy(self) -> "Mesh":
        return Mesh(
            self.verts.copy(),
            self.faces.copy(),
            None if self.face_colors is None else self.face_colors.copy(),
        )

    def update_faces(self, mask: np.ndarray):
        """Keep faces where mask (order preserved, like trimesh.update_faces)."""
        self.faces = self.faces[mask]
        if self.face_colors is not None:
            self.face_colors = self.face_colors[mask]

    def remove_unreferenced_vertices(self):
        used = np.flatnonzero(np.bincount(self.faces.reshape(-1), minlength=len(self.verts)))
        remap = np.full(len(self.verts), -1, np.int64)
        remap[used] = np.arange(len(used))
        self.verts = self.verts[used]
        self.faces = remap[self.faces]

    def nondegenerate_faces(self) -> np.ndarray:
        f = self.faces
        return (f[:, 0] != f[:, 1]) & (f[:, 1] != f[:, 2]) & (f[:, 0] != f[:, 2])

    def edges_sorted(self) -> np.ndarray:
        he = np.concatenate(
            [self.faces[:, [0, 1]], self.faces[:, [1, 2]], self.faces[:, [2, 0]]], axis=0
        )
        return np.sort(he, axis=1)

    def boundary_edges_directed(self) -> np.ndarray:
        """Directed half-edges that have no opposite (hole/boundary edges):
        those whose undirected edge occurs once, found by one sort."""
        he = np.concatenate(
            [self.faces[:, [0, 1]], self.faces[:, [1, 2]], self.faces[:, [2, 0]]], axis=0
        )
        lo, hi = np.minimum(he[:, 0], he[:, 1]), np.maximum(he[:, 0], he[:, 1])
        lin = lo * np.int64(len(self.verts)) + hi
        order = np.argsort(lin)
        s = lin[order]
        differs = np.ones(len(s) + 1, bool)  # from the previous sorted key; ends count as different
        differs[1:-1] = s[1:] != s[:-1]
        once = np.empty(len(s), bool)
        once[order] = differs[:-1] & differs[1:]
        return he[once]

    def face_areas(self) -> np.ndarray:
        fv = self.verts[self.faces]
        return 0.5 * np.linalg.norm(
            np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0]), axis=-1
        )

    def is_watertight(self) -> bool:
        return len(self.boundary_edges_directed()) == 0

    def face_components(self) -> np.ndarray:
        return face_connected_components(self.faces)


# ---------------------------------------------------------------------------
# Primitive operations (refined_mesh.py:84-308)
# ---------------------------------------------------------------------------


def find_points_in_boundingbox(verts, bb):
    lo, hi = bb[0], bb[1]
    return ((verts > lo) & (verts < hi)).all(axis=-1)


def find_boundary_verts(mesh: Mesh, pc_aabb=None, cut_inner=False, pad=0.02):
    """Boundary (open-edge) vertices, optionally restricted near an AABB
    (refined_mesh.py:84-123)."""
    boundary_vid = np.unique(mesh.boundary_edges_directed().reshape(-1))
    if pc_aabb is None:
        return boundary_vid
    if cut_inner:
        new_aabb = np.stack([pc_aabb[0] - pad, pc_aabb[1] + pad])
        mask = find_points_in_boundingbox(mesh.verts[boundary_vid], new_aabb)
        return boundary_vid[mask]
    inside = find_points_in_boundingbox(mesh.verts, pc_aabb)
    inside_face_vert = inside[mesh.faces]
    boundary_face = inside_face_vert.any(axis=1) & ~inside_face_vert.all(axis=1)
    on_boundary_face = np.unique(mesh.faces[boundary_face])
    return boundary_vid[np.isin(boundary_vid, on_boundary_face)]


def reset_duplicate_vert(verts, faces, candidate_vid):
    """Merge candidate vertices with identical positions: all duplicates remap to
    the candidate with the smallest group index (refined_mesh.py:116-124
    reset_duplicate_vert semantics, vectorized)."""
    pos = verts[candidate_vid]
    _, first_idx, inv = np.unique(
        pos.round(decimals=12), axis=0, return_index=True, return_inverse=True
    )
    # The reference maps each group to min(group) in candidate order.
    group_min = np.full(first_idx.shape[0], len(candidate_vid), np.int64)
    np.minimum.at(group_min, inv, np.arange(len(candidate_vid)))
    target = candidate_vid[group_min[inv]]  # per candidate: its group representative
    remap = np.arange(len(verts))
    remap[candidate_vid] = target
    faces[:] = remap[faces]


def merge_vert_around_holes(mesh: Mesh, max_hole_vert_num=10):
    """Collapse small boundary loops (holes) to a single vertex
    (refined_mesh.py:126-155)."""
    hole_edges = mesh.boundary_edges_directed()
    hole_verts = np.unique(hole_edges.reshape(-1))
    if hole_verts.size == 0:
        return
    # Connected components over the hole-edge graph; the components are
    # disjoint, so each small one moves to its smallest vertex at once.
    n = len(hole_verts)
    remap = np.full(len(mesh.verts), -1, np.int64)
    remap[hole_verts] = np.arange(n)
    e = remap[hole_edges]
    graph = coo_matrix((np.ones(len(e), np.int8), (e[:, 0], e[:, 1])), shape=(n, n))
    n_cc, labels = connected_components(graph, directed=False)
    small = np.bincount(labels, minlength=n_cc)[labels] <= max_hole_vert_num
    first = np.full(n_cc, n, np.int64)
    np.minimum.at(first, labels, np.arange(n))  # hole_verts is sorted: the smallest vertex
    mesh.verts[hole_verts[small]] = mesh.verts[hole_verts[first[labels[small]]]]
    reset_duplicate_vert(mesh.verts, mesh.faces, hole_verts)


def _walk_loops(edges, max_loop):
    """fill_holes's walk: over the successor map `source -> target of its
    last edge`, from each unvisited source in the order of its first edge,
    marking what it visits; [(start, loop)] of the walks that close on their
    start with 3..max_loop vertices."""
    nxt = {}
    for a, b in edges.tolist():
        nxt[a] = b
    visited = set()
    found = []
    for a in list(nxt):
        if a in visited:
            continue
        loop = [a]
        visited.add(a)
        cur = nxt.get(a)
        ok = True
        while cur is not None and cur != a:
            if cur in visited or len(loop) > max_loop + 1:
                ok = False
                break
            loop.append(cur)
            visited.add(cur)
            cur = nxt.get(cur)
        if ok and cur == a and 3 <= len(loop) <= max_loop:
            found.append((a, loop))
    return found


def fill_holes(mesh: Mesh, max_loop=4):
    """Fan-fill small boundary loops (trimesh.repair.fill_holes fills only 3- and
    4-edge holes; same here). Winding follows the reversed boundary direction so
    filled faces orient consistently with their neighbors.

    A walk stays in its weakly connected component of the successor map. A
    component in which every vertex has one successor and one predecessor is
    a single cycle that no other walk enters: the walk from its first source
    closes on it, so such cycles are taken at once; the other components are
    walked as written (_walk_loops). Faces follow the walks' starts."""
    edges = mesh.boundary_edges_directed()
    if len(edges) == 0:
        return
    ids, e = np.unique(edges, return_inverse=True)  # compact vertex ids
    e = e.reshape(-1, 2)
    n, pos = len(ids), np.arange(len(e))
    last = np.full(n, -1)
    np.maximum.at(last, e[:, 0], pos)
    rank = np.full(n, len(e))  # a source's first edge: when its walk would start
    np.minimum.at(rank, e[:, 0], pos)
    src = np.flatnonzero(last >= 0)
    nxt = np.full(n, -1)
    nxt[src] = e[last[src], 1]
    graph = coo_matrix((np.ones(len(src), np.int8), (src, nxt[src])), shape=(n, n))
    n_cc, labels = connected_components(graph, directed=False)
    one_in_one_out = (nxt >= 0) & (np.bincount(nxt[src], minlength=n) == 1)
    is_cycle = np.bincount(labels, weights=~one_in_one_out, minlength=n_cc) == 0
    size = np.bincount(labels, minlength=n_cc)
    head = np.full(n_cc, len(e))
    np.minimum.at(head, labels, rank)

    found = []  # (rank of the start, loop)
    for length in range(3, max_loop + 1):
        start = np.flatnonzero((is_cycle & (size == length))[labels] & (rank == head[labels]))
        walk = [start]
        for _ in range(length - 1):
            walk.append(nxt[walk[-1]])
        found += zip(rank[start].tolist(), ids[np.stack(walk, axis=1)].tolist())
    rest = edges[~is_cycle[labels[e[:, 0]]]]
    found += [(int(rank[np.searchsorted(ids, a)]), loop) for a, loop in _walk_loops(rest, max_loop)]

    new_faces = []
    for _, loop in sorted(found):
        # Boundary half-edges run opposite to face winding; reverse for the fill.
        loop = loop[::-1]
        for i in range(1, len(loop) - 1):
            new_faces.append([loop[0], loop[i], loop[i + 1]])
    if new_faces:
        mesh.faces = np.concatenate([mesh.faces, np.asarray(new_faces, mesh.faces.dtype)])
        if mesh.face_colors is not None:
            pad = np.zeros((len(new_faces), mesh.face_colors.shape[1]), mesh.face_colors.dtype)
            mesh.face_colors = np.concatenate([mesh.face_colors, pad])


def cut_mesh_by_boundingbox(mesh: Mesh, bb, cut_inner=False, inplace=False):
    """Keep faces with any vertex inside bb (or outside if cut_inner)
    (refined_mesh.py:227-252)."""
    inside = find_points_in_boundingbox(mesh.verts, bb)
    inside_face = inside[mesh.faces].any(axis=1)
    keep = ~inside_face if cut_inner else inside_face
    cut = mesh if inplace else mesh.copy()
    cut.update_faces(keep)
    cut.remove_unreferenced_vertices()
    return {"cut_mesh": cut, "inside_face_mask": keep}


def combine_overlap_aabbs(aabb_list):
    """Merge AABBs whose corners overlap, to fixpoint (refined_mesh.py:254-288)."""
    new_list = []
    for aabb in aabb_list:
        lo, hi = aabb[0], aabb[1]
        corners = np.array(
            [[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1]) for z in (lo[2], hi[2])]
        )
        overlap_id = -1
        for i, other in enumerate(new_list):
            if find_points_in_boundingbox(corners, other).any():
                overlap_id = i
                break
        if overlap_id == -1:
            new_list.append(np.asarray(aabb).copy())
        else:
            other = new_list[overlap_id]
            new_list[overlap_id] = np.stack(
                [np.minimum(other[0], aabb[0]), np.maximum(other[1], aabb[1])]
            )
    if len(new_list) == len(aabb_list):
        return new_list
    return combine_overlap_aabbs(new_list)


def get_outlier_cc_mask(faces, face_num_threshold=None):
    """True for faces in large connected components (refined_mesh.py:291-308).
    Only the components' sizes and members matter here, not the order of
    their labels, so scipy labels them (the union-find's Python loop takes
    seconds on a fused mesh of a million faces)."""
    n = len(faces)
    adj = build_topology(faces).adj_faces
    graph = coo_matrix((np.ones(len(adj), np.int8), (adj[:, 0], adj[:, 1])), shape=(n, n))
    labels = connected_components(graph, directed=False)[1]
    counts = np.bincount(labels)
    if face_num_threshold is None:
        thr = counts.max() * 0.3
    else:
        thr = min(face_num_threshold, counts.max() * 0.3)
    keep_labels = np.where(counts >= thr)[0]
    return np.isin(labels, keep_labels)


def connect_two_meshes(mesh1: Mesh, boundary_vid1, mesh2: Mesh, boundary_vid2):
    """Snap two boundary rings together by mutual nearest neighbor, concatenate,
    merge duplicates, repair small holes (refined_mesh.py:158-215)."""
    vert_num1 = len(mesh1.verts)
    pc1 = mesh1.verts[boundary_vid1]
    pc2 = mesh2.verts[boundary_vid2]

    d21, i21 = cKDTree(pc1).query(pc2)
    mesh2.verts[boundary_vid2] = pc1[i21]
    pc2n = mesh2.verts[boundary_vid2]
    d12, i12 = cKDTree(pc2n).query(pc1)
    mesh1.verts[boundary_vid1] = pc2n[i12]

    verts = np.concatenate([mesh1.verts, mesh2.verts])
    faces = np.concatenate([mesh1.faces, mesh2.faces + vert_num1])
    fc1 = mesh1.face_colors if mesh1.face_colors is not None else np.zeros((len(mesh1.faces), 3))
    fc2 = mesh2.face_colors if mesh2.face_colors is not None else np.zeros((len(mesh2.faces), 3))
    face_colors = np.concatenate([fc1, fc2])
    boundary_vids = np.concatenate([boundary_vid1, boundary_vid2 + vert_num1])

    reset_duplicate_vert(verts, faces, boundary_vids)
    connected = Mesh(verts, faces, face_colors)

    valid1 = connected.nondegenerate_faces()
    connected.update_faces(valid1)
    connected.remove_unreferenced_vertices()
    merge_vert_around_holes(connected)
    valid2 = connected.nondegenerate_faces()
    connected.update_faces(valid2)
    connected.remove_unreferenced_vertices()

    valid_face_mask = valid1.copy()
    valid_face_mask[valid1] = valid2
    max_dist = float(max(d21.max(initial=0.0), d12.max(initial=0.0)))
    return {"connected_mesh": connected, "valid_face_mask": valid_face_mask, "max_dist": max_dist}


# ---------------------------------------------------------------------------
# update_mesh_topo (refined_mesh.py:463-693)
# ---------------------------------------------------------------------------


def update_mesh_topo(
    base_mesh: Mesh,
    fusion_mesh: Mesh,
    face_delta: np.ndarray,  # [F] in [0, 1] — detection weight per base face
    gauss_points: np.ndarray | None = None,  # [F, n_g, 3] gaussian centers (AABB support)
    delta_threshold=0.6,
    cc_face_threshold=80,
    outlier_face_threshold=50,
    aabb_pad=0.02,
    force_watertight=True,
    force_short_edge=False,
    boundary_pad=0.02,
):
    """Regional re-mesh. Returns dict with updated_mesh, cc_update_num,
    track_face_mask [F_orig] and new_ref_area, or cc_update_num in {-1, 0}."""
    base_mesh_ori = base_mesh.copy()
    base_mesh = base_mesh.copy()
    topo = build_topology(np.asarray(base_mesh.faces), len(base_mesh.verts))
    ev = base_mesh.verts[topo.edges]
    base_edge_avg = np.linalg.norm(ev[:, 0] - ev[:, 1], axis=1).mean() if len(topo.edges) else 0.0

    # Select flagged faces, then large connected components among them.
    face_update_mask1 = face_delta >= delta_threshold
    delta_mesh = base_mesh.copy()
    delta_mesh.update_faces(face_update_mask1)
    if len(delta_mesh.faces) == 0:
        return {"cc_update_num": -1}
    labels = face_connected_components(delta_mesh.faces)
    counts = np.bincount(labels)
    cc_update_label = np.where(counts > cc_face_threshold)[0]
    if cc_update_label.size == 0:
        return {"cc_update_num": -1}
    face_update_mask2 = np.isin(labels, cc_update_label)

    # AABBs per selected component (+ gaussian centers of those faces), merged.
    aabb_list = []
    for lab in cc_update_label:
        in_cc = labels == lab
        sel = delta_mesh.copy()
        sel.update_faces(in_cc)
        sel.remove_unreferenced_vertices()
        pts = [sel.verts]
        if gauss_points is not None:
            pts.append(gauss_points[face_update_mask1][in_cc].reshape(-1, 3))
        pts = np.concatenate(pts, axis=0)
        aabb = np.stack([pts.min(axis=0) - aabb_pad, pts.max(axis=0) + aabb_pad])
        aabb_list.append(aabb)
    aabb_list = combine_overlap_aabbs(aabb_list)

    track_face_mask = np.ones(len(base_mesh_ori.faces), dtype=bool)
    cc_success = 0
    max_dist_in_connection = 0.0

    for aabb in aabb_list:
        cut_fusion = cut_mesh_by_boundingbox(fusion_mesh, aabb, cut_inner=False)["cut_mesh"]
        if len(cut_fusion.verts) == 0:
            continue
        fill_holes(cut_fusion)
        outlier_mask = get_outlier_cc_mask(cut_fusion.faces, outlier_face_threshold)
        cut_fusion.update_faces(outlier_mask)
        cut_fusion.remove_unreferenced_vertices()
        fus_boundary = find_boundary_verts(cut_fusion, pc_aabb=aabb, cut_inner=False)
        if fus_boundary.shape[0] == 0:
            continue

        cut_base_out = cut_mesh_by_boundingbox(base_mesh, aabb, cut_inner=True)
        cut_base = cut_base_out["cut_mesh"]
        if len(cut_base.verts) == 0:
            continue
        cut_base_face_mask = cut_base_out["inside_face_mask"]
        cur_base_face_num = len(cut_base.faces)
        fill_holes(cut_base)
        base_boundary = find_boundary_verts(cut_base, pc_aabb=aabb, cut_inner=True, pad=boundary_pad)
        if base_boundary.shape[0] == 0:
            continue

        out = connect_two_meshes(cut_base, base_boundary, cut_fusion, fus_boundary)
        connected = out["connected_mesh"]
        max_dist_in_connection = max(max_dist_in_connection, out["max_dist"])

        if force_watertight and not connected.is_watertight():
            continue
        if force_short_edge and out["max_dist"] > 6 * base_edge_avg:
            continue
        fill_holes(connected)

        face_mask_this = np.ones(len(base_mesh.faces), dtype=bool)
        face_mask_this[~cut_base_face_mask] = False
        face_mask_this[cut_base_face_mask] = out["valid_face_mask"][:cur_base_face_num]

        base_mesh = connected.copy()
        track_num = track_face_mask.sum()
        track_face_mask[track_face_mask] = face_mask_this[:track_num]
        cc_success += 1

    if cc_success == 0:
        return {"cc_update_num": 0}

    new_ref_area = base_mesh.face_areas()
    track_num = int(track_face_mask.sum())
    new_ref_area[:track_num] = base_mesh_ori.face_areas()[track_face_mask]
    if len(new_ref_area) > track_num:
        new_ref_area[track_num:] = new_ref_area[track_num:].mean()

    return {
        "updated_mesh": base_mesh,
        "cc_update_num": cc_success,
        "track_face_mask": track_face_mask,
        "new_ref_area": new_ref_area,
        "max_dist_in_connection": max_dist_in_connection,
    }
