"""Simple procedural meshes (numpy copy of gaustar_tpu/mesh/primitives.py)."""

from __future__ import annotations

import numpy as np


def icosphere(subdivisions: int = 1, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Returns (verts [V,3] f32, faces [F,3] i32). 20 * 4^s faces."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)

    for _ in range(subdivisions):
        edge_mid = {}
        new_faces = []
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in edge_mid:
                m = (vlist[a] + vlist[b]) / 2.0
                m /= np.linalg.norm(m)
                vlist.append(m)
                edge_mid[key] = len(vlist) - 1
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        faces = np.asarray(new_faces, np.int64)

    verts = verts * radius + np.asarray(center, np.float64)
    return verts.astype(np.float32), faces.astype(np.int32)


def uv_sphere(n_lat: int, n_lon: int, radius: float = 1.0, center=(0.0, 0.0, 0.0)):
    """Lat-long sphere with EXACTLY 2 * n_lon * (n_lat - 1) faces
    (reference-scale benchmark meshes need precise face counts,
    e.g. 100k = 2 * 250 * (201 - 1)).

    Rows 1..n_lat-1 are rings of n_lon verts; poles cap the ends.
    Returns (verts [V,3] f32, faces [F,3] i32)."""
    ring_rows = n_lat - 1
    theta = np.pi * np.arange(1, n_lat) / n_lat  # [ring_rows]
    phi = 2.0 * np.pi * np.arange(n_lon) / n_lon  # [n_lon]
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    sp, cp = np.sin(phi)[None, :], np.cos(phi)[None, :]
    rings = np.stack([st * cp, ct * np.ones_like(sp), st * sp], axis=-1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], rings, [[0.0, -1.0, 0.0]]], axis=0)

    def rid(r, c):  # ring r in [0, ring_rows), col c mod n_lon
        return 1 + r * n_lon + (c % n_lon)

    faces = []
    for c in range(n_lon):  # north cap
        faces.append([0, rid(0, c), rid(0, c + 1)])
    for r in range(ring_rows - 1):  # quad strips
        for c in range(n_lon):
            a, b = rid(r, c), rid(r, c + 1)
            d, e = rid(r + 1, c), rid(r + 1, c + 1)
            faces += [[a, d, b], [b, d, e]]
    south = len(verts) - 1
    for c in range(n_lon):  # south cap
        faces.append([south, rid(ring_rows - 1, c + 1), rid(ring_rows - 1, c)])

    verts = verts * radius + np.asarray(center, np.float64)
    faces = np.asarray(faces, np.int32)[:, ::-1]  # outward winding
    return verts.astype(np.float32), np.ascontiguousarray(faces)

