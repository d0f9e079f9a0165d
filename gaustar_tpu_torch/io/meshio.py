"""Wavefront OBJ read/write (vertices, vertex colors, faces): the reference's
inter-stage mesh contract (color_mesh.obj, warp_smooth.obj, updated_mesh.obj).
A numpy copy of gaustar_tpu/io/meshio.py.

The reference writes OBJ through open3d, which emits `v x y z [r g b]` lines and
`f i j k` (1-based); this module parses and emits exactly that subset.
"""

from __future__ import annotations

import numpy as np


def read_obj(path: str):
    """Returns (verts [V,3] f32, faces [F,3] i32, vertex_colors [V,3] f32 or None)."""
    verts, colors, faces = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(x) for x in parts[1:4]])
                if len(parts) >= 7:
                    colors.append([float(x) for x in parts[4:7]])
            elif line.startswith("f "):
                idx = [p.split("/")[0] for p in line.split()[1:4]]
                faces.append([int(i) - 1 for i in idx])
    v = np.asarray(verts, np.float32)
    fc = np.asarray(faces, np.int32) if faces else np.zeros((0, 3), np.int32)
    c = np.asarray(colors, np.float32) if len(colors) == len(verts) and colors else None
    return v, fc, c


def write_obj(path: str, verts, faces, vertex_colors=None):
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    with open(path, "w") as f:
        if vertex_colors is not None:
            vertex_colors = np.asarray(vertex_colors, np.float64)
            for v, c in zip(verts, vertex_colors):
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f}\n")
        else:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces:
            f.write(f"f {tri[0]+1} {tri[1]+1} {tri[2]+1}\n")
