"""Minimal PLY I/O (binary little-endian + ascii), no external deps; a numpy
copy of gaustar_tpu/io/ply.py.

Round-trips the 3DGS checkpoint format written by the reference
(gaussian_splatting/scene/gaussian_model.py:191-256): vertex properties
x y z nx ny nz f_dc_0..2 f_rest_0..(3K-4) opacity scale_0..2 rot_0..3.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "short": "<i2",
    "ushort": "<u2",
    "int": "<i4",
    "int32": "<i4",
    "uint": "<u4",
    "uint32": "<u4",
}


def read_ply(path: str) -> dict[str, dict[str, np.ndarray]]:
    """Read a PLY file -> {element_name: {property_name: array}}.

    Supports float/int scalar properties and the common `list uchar int
    vertex_indices` face property (returned as an [F, 3] int array when
    triangular)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError("not a ply file")
        fmt = None
        elements = []  # (name, count, [(prop_name, dtype)|('list', ...)], )
        while True:
            line = f.readline().strip().decode()
            if line.startswith("comment") or line.startswith("obj_info"):
                continue
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, count = line.split()
                elements.append([name, int(count), []])
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elements[-1][2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    elements[-1][2].append((parts[2], parts[1]))
            elif line == "end_header":
                break

        out = {}
        for name, count, props in elements:
            if any(p[0] == "list" for p in props):
                assert len(props) == 1, "mixed list/scalar elements unsupported"
                _, cnt_t, idx_t, pname = props[0]
                cnt_dt = np.dtype(_DTYPES[cnt_t])
                idx_dt = np.dtype(_DTYPES[idx_t])
                if fmt == "ascii":
                    rows = [
                        np.fromstring(f.readline(), dtype=np.int64, sep=" ")[1:]
                        for _ in range(count)
                    ]
                    faces = np.asarray(rows)
                else:
                    faces = []
                    for _ in range(count):
                        (k,) = np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)
                        faces.append(np.frombuffer(f.read(idx_dt.itemsize * int(k)), idx_dt))
                    faces = np.asarray(faces)
                out[name] = {pname: faces.astype(np.int32)}
            else:
                if fmt == "ascii":
                    data = np.loadtxt([f.readline() for _ in range(count)], ndmin=2)
                    out[name] = {p[0]: data[:, i] for i, p in enumerate(props)}
                else:
                    dt = np.dtype([(p[0], _DTYPES[p[1]]) for p in props])
                    raw = np.frombuffer(f.read(dt.itemsize * count), dt)
                    out[name] = {p[0]: np.ascontiguousarray(raw[p[0]]) for p in props}
        return out


def write_ply(path: str, vertex_props: dict[str, np.ndarray], faces: np.ndarray | None = None):
    """Write binary little-endian PLY with the given per-vertex properties (in dict
    order) and optional triangle faces."""
    names = list(vertex_props)
    n = len(next(iter(vertex_props.values())))
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for name in names:
            f.write(f"property float {name}\n".encode())
        if faces is not None:
            f.write(f"element face {len(faces)}\n".encode())
            f.write(b"property list uchar int vertex_indices\n")
        f.write(b"end_header\n")
        dt = np.dtype([(name, "<f4") for name in names])
        rec = np.empty(n, dt)
        for name in names:
            rec[name] = np.asarray(vertex_props[name], np.float32).reshape(-1)
        f.write(rec.tobytes())
        if faces is not None:
            faces = np.asarray(faces, np.int32)
            fdt = np.dtype([("k", "u1"), ("v", "<i4", (faces.shape[1],))])
            frec = np.empty(len(faces), fdt)
            frec["k"] = faces.shape[1]
            frec["v"] = faces
            f.write(frec.tobytes())
