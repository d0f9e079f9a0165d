"""ctypes bindings of the native mesh library (counterpart of
gaustar_tpu/native): quadric decimation, Laplacian smoothing, 3-NN mean
squared distance and face connected components.

`meshops.cpp` is a copy of the JAX package's source. It is built at first use
with g++ and the JAX package's Makefile flags into
`build/native/libmeshops-<hash>.so` at the repo root, keyed by the hash of
the source, the flags and the host's CPU model (-march=native builds for the
CPU it runs on, so a library built on another machine is not reused); the
same source and flags on one machine give bit-equal results. There is no
fallback: without g++, or if the build fails, every function raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np

from gaustar_tpu_torch.utils.general import cpu_model

SOURCE = Path(__file__).resolve().parent / "meshops.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lib = None
BUILD_LOG: dict = {}  # {"seconds": s, "log": g++ output} of a build in this process


def lib_path() -> Path:
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + cpu_model().encode()
    return BUILD_DIR / f"libmeshops-{hashlib.sha1(key).hexdigest()[:12]}.so"


def build() -> Path:
    """Compile meshops.cpp unless it is built already; raises if it fails."""
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native mesh library is built at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True)
    BUILD_LOG.update(seconds=time.perf_counter() - t0, log=proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{BUILD_LOG['log']}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    d, i32, i64, f32 = (ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int32),
                        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_float))
    lib.decimate_quadric.argtypes = [d, ctypes.c_int64, i32, ctypes.c_int64, ctypes.c_int64, ctypes.c_double,
                                     d, i32, i64, i64]
    lib.laplacian_smooth.argtypes = [d, ctypes.c_int64, i32, ctypes.c_int64, ctypes.c_int, ctypes.c_double]
    lib.knn3_mean_sq_dist.argtypes = [f32, ctypes.c_int64, f32]
    lib.face_connected_components.argtypes = [i32, ctypes.c_int64, ctypes.c_int64, i32]
    for fn in (lib.decimate_quadric, lib.laplacian_smooth, lib.knn3_mean_sq_dist, lib.face_connected_components):
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def _ptr(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int, aggressiveness: float = 7.0):
    """Quadric edge-collapse decimation (pyfqmr / o3d
    simplify_quadric_decimation). Returns (verts [V', 3] f64, faces [F', 3] i32)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float64)
    faces = np.ascontiguousarray(faces, np.int32)
    out_v = np.empty_like(verts)
    out_f = np.empty_like(faces)
    nv, nf = ctypes.c_int64(), ctypes.c_int64()
    lib.decimate_quadric(_ptr(verts, ctypes.c_double), len(verts), _ptr(faces, ctypes.c_int32), len(faces),
                         int(target_faces), float(aggressiveness), _ptr(out_v, ctypes.c_double),
                         _ptr(out_f, ctypes.c_int32), ctypes.byref(nv), ctypes.byref(nf))
    return out_v[: nv.value].copy(), out_f[: nf.value].copy()


def laplacian_smooth(verts: np.ndarray, faces: np.ndarray, iterations: int = 10, lam: float = 0.5) -> np.ndarray:
    """Uniform Laplacian smoothing (o3d filter_smooth_laplacian), float64."""
    lib = _load()
    out = np.ascontiguousarray(verts, np.float64).copy()
    faces = np.ascontiguousarray(faces, np.int32)
    lib.laplacian_smooth(_ptr(out, ctypes.c_double), len(out), _ptr(faces, ctypes.c_int32), len(faces),
                         int(iterations), float(lam))
    return out


def knn3_mean_sq_dist(points: np.ndarray) -> np.ndarray:
    """Mean squared distance to the 3 nearest neighbours (simple-knn
    distCUDA2), by the library's uniform grid. [N] float32."""
    lib = _load()
    pts = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(pts), np.float32)
    lib.knn3_mean_sq_dist(_ptr(pts, ctypes.c_float), len(pts), _ptr(out, ctypes.c_float))
    return out


def face_components(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Face connected-component labels [F] int32 (faces sharing a vertex)."""
    lib = _load()
    faces = np.ascontiguousarray(faces, np.int32)
    labels = np.empty(len(faces), np.int32)
    lib.face_connected_components(_ptr(faces, ctypes.c_int32), len(faces), int(n_verts),
                                  _ptr(labels, ctypes.c_int32))
    return labels
