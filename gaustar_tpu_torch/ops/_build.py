"""Builds the port's CUDA sources at first use and loads them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles with nvcc alone
(no PyTorch headers: seconds, not minutes) into
`build/kernels/lib<name>-<hash>.so` at the repo root, keyed by the hash of
the source, the headers of `csrc/`, the flags and the library's own link
flags (`LINK_FLAGS`: `jpeg_codec` links the toolkit's libnvjpeg, found at run
time through an rpath to the toolkit's lib64), so an edited source, header or
flag is rebuilt. `build()` starts one nvcc per source, all at once; the
first `load` of a source the refine step runs (STEP_KERNELS) builds every
one of them that is missing in that one round.

`-fmad=false`: the blend's discrete decisions (power <= 0, alpha >= 1/255,
T * (1 - alpha) < 1e-4, and so `n_contrib`) flip on one ULP. Without FMA
contraction every product and sum rounds separately, as in the plain PyTorch
version, which runs each operation as its own kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# The sources every refine step launches: the blend and the pixel losses.
STEP_KERNELS = ("blend_fwd", "blend_bwd", "pixel_loss")

# Libraries a source links beyond the CUDA runtime, per source name.
LINK_FLAGS = {"jpeg_codec": ("-lnvjpeg",)}

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, dict] = {}  # name -> {"seconds": s, "log": nvcc output}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")
    return path


def cuda_home() -> Path:
    """The CUDA toolkit's root: $CUDA_HOME, else /usr/local/cuda."""
    return Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda")


def link_flags(name: str) -> tuple:
    """The source's own link flags, with an rpath to the toolkit's lib64 so
    that ctypes finds the linked library without LD_LIBRARY_PATH."""
    extra = LINK_FLAGS.get(name, ())
    if not extra:
        return ()
    return (*extra, "-Xlinker", f"-rpath,{cuda_home() / 'lib64'}")


def lib_path(name: str) -> Path:
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    flags = " ".join((*NVCC_FLAGS, *link_flags(name))).encode()
    digest = hashlib.sha1(src + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, dict]:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together. Returns BUILD_LOG; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu"), *link_flags(name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            errors.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return BUILD_LOG


def load(name: str, argtypes: dict) -> ctypes.CDLL:
    """The built library of `csrc/<name>.cu` (built now if missing), with its
    C functions bound to their argtypes ({function: argtypes}) and an int
    (error code) result."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not path.exists():
            build(STEP_KERNELS if name in STEP_KERNELS else [name])
        lib = ctypes.CDLL(str(path))
        for fn_name, types in argtypes.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = types
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib
