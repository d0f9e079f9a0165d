"""Host-side mesh topology (numpy copy of gaustar_tpu/mesh/topology.py).

Replaces the pytorch3d `Meshes` connectivity queries used by the reference
(edges_packed, faces_areas_packed neighborhoods, mesh_normal_consistency pairs).
Computed once per mesh on the host; the losses take them as static index tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class MeshTopology(NamedTuple):
    edges: np.ndarray  # [E, 2] unique undirected edges (sorted pairs)
    adj_faces: np.ndarray  # [E_int, 2] face pairs sharing an interior edge
    boundary_edges: np.ndarray  # [E_b, 2] edges with exactly one incident face
    vert_adj: np.ndarray  # [V, max_deg] padded vertex neighbors (pad = V)
    vert_adj_count: np.ndarray  # [V]


def build_topology(faces: np.ndarray, n_verts: int | None = None) -> MeshTopology:
    faces = np.asarray(faces, np.int64)
    if n_verts is None:
        n_verts = int(faces.max()) + 1 if faces.size else 0

    # All half-edges with their face ids.
    he = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    fid = np.tile(np.arange(len(faces)), 3)
    uniq, inv, counts = np.unique(
        np.minimum(he[:, 0], he[:, 1]) * np.int64(n_verts) + np.maximum(he[:, 0], he[:, 1]),
        return_inverse=True, return_counts=True,
    )
    edges = np.stack([uniq // n_verts, uniq % n_verts], axis=1).astype(np.int32)

    # Interior edges: exactly two incident faces -> adjacency pair.
    order = np.argsort(inv, kind="stable")
    inv_sorted = inv[order]
    fid_sorted = fid[order]
    starts = np.searchsorted(inv_sorted, np.arange(len(uniq)))
    interior = counts == 2
    i0 = starts[interior]
    adj_faces = np.stack([fid_sorted[i0], fid_sorted[i0 + 1]], axis=1).astype(np.int32)
    boundary = counts == 1
    boundary_edges = edges[boundary]

    # Vertex adjacency (from unique edges), padded: each vertex lists its
    # neighbours in edge order, as appending edge by edge would.
    deg = np.zeros(n_verts, np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    max_deg = int(deg.max()) if len(deg) else 0
    vert_adj = np.full((n_verts, max_deg), n_verts, np.int32)
    src = edges.reshape(-1)  # edge-major: a0, b0, a1, b1, ...
    dst = edges[:, ::-1].reshape(-1)
    order = np.argsort(src, kind="stable")
    row_start = np.cumsum(deg) - deg
    slot = np.arange(len(order)) - row_start[src[order]]
    vert_adj[src[order], slot] = dst[order]

    return MeshTopology(
        edges=edges,
        adj_faces=adj_faces,
        boundary_edges=boundary_edges.astype(np.int32),
        vert_adj=vert_adj,
        vert_adj_count=deg.astype(np.int32),
    )


def face_connected_components(faces: np.ndarray, adj_faces: np.ndarray | None = None) -> np.ndarray:
    """Label faces by edge-connected component (union-find). Returns [F] labels."""
    faces = np.asarray(faces)
    if adj_faces is None:
        adj_faces = build_topology(faces).adj_faces
    parent = np.arange(len(faces))

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    for a, b in adj_faces:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[rb] = ra
    labels = np.fromiter((find(i) for i in range(len(faces))), dtype=np.int64, count=len(faces))
    # Relabel to consecutive ids.
    _, labels = np.unique(labels, return_inverse=True)
    return labels
