"""tests/port_native.py against the race it covers: several processes
importing a fresh copy of the JAX package's native module at once, each
running its own `make` into the same directory; a library that is still
being written when the processes import it; and a stale import-time
flag."""

import os
import shutil
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import numpy as np

from gaustar_tpu import native as jnative
from gaustar_tpu_torch.mesh.primitives import icosphere
from port_native import jax_native

N_PROCS = 6
NATIVE_DIR = Path(jnative.__file__).resolve().parent
TESTS_DIR = Path(__file__).resolve().parent

# Each child waits for the go file and its own delay, imports the copy (its
# `make` races the others'), then loads the library through the helper and
# decimates.
CHILD = textwrap.dedent("""
    import os, sys, time
    from pathlib import Path
    import numpy as np
    root, tests_dir, rank, delay = sys.argv[1], sys.argv[2], sys.argv[3], float(sys.argv[4])
    sys.path[:0] = [root, tests_dir]
    while not os.path.exists(os.path.join(root, "go")):
        time.sleep(0.001)
    time.sleep(delay)
    import racenative
    from port_native import jax_native
    flag_at_import = racenative.HAVE_NATIVE
    lib = jax_native(racenative, lock_path=Path(root) / "lock")
    mesh = np.load(os.path.join(root, "mesh.npz"))
    v, f = racenative.decimate(mesh["verts"], mesh["faces"], 200)
    np.savez(os.path.join(root, f"out{rank}.npz"), verts=v, faces=f, loaded=lib is not None and
             racenative._lib is lib and racenative.HAVE_NATIVE, flag_at_import=flag_at_import)
""")


def _copy_package(root):
    """The JAX package's native module copied to root/racenative, without
    its library, and the icosphere the children decimate."""
    pkg = root / "racenative"
    pkg.mkdir()
    for name in ("__init__.py", "Makefile", "meshops.cpp"):
        shutil.copy(NATIVE_DIR / name, pkg / name)
    verts, faces = icosphere(3)
    np.savez(root / "mesh.npz", verts=verts, faces=faces)
    return pkg


def _race(root, delays, while_waiting=lambda: None):
    """Start one child per delay, release them together, run
    `while_waiting`, and return each child's output."""
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(root), str(TESTS_DIR), str(r), str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r, d in enumerate(delays)]
    (root / "go").touch()
    while_waiting()
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0] * len(procs), logs
    outs = [np.load(root / f"out{r}.npz") for r in range(len(procs))]
    assert all(bool(o["loaded"]) for o in outs)
    assert 180 <= len(outs[0]["faces"]) <= 200
    for o in outs[1:]:
        np.testing.assert_array_equal(o["verts"], outs[0]["verts"])
        np.testing.assert_array_equal(o["faces"], outs[0]["faces"])
    return outs


def test_concurrent_first_imports_all_load_the_library(tmp_path):
    """Six first imports, spread over about one build, each with its own
    `make`: every one ends with the library and the same decimation."""
    _copy_package(tmp_path)
    _race(tmp_path, [0.25 * r for r in range(N_PROCS)])


def test_library_still_being_written_is_waited_for(tmp_path):
    """The failure the helper covers, made deterministic: the library file
    exists but is still empty (a linker has created it and not yet written
    it), so every import's loader fails and its HAVE_NATIVE is False; two
    seconds later the whole library takes its name, and every helper
    returns it."""
    pkg = _copy_package(tmp_path)
    subprocess.run(["make", "-C", str(pkg)], check=True, capture_output=True, timeout=120)
    lib = pkg / "libmeshops.so"
    whole = lib.read_bytes()
    lib.write_bytes(b"")

    def finish_writing():
        time.sleep(2.0)
        tmp = lib.with_suffix(".tmp")
        tmp.write_bytes(whole)
        os.replace(tmp, lib)

    outs = _race(tmp_path, [0.0] * N_PROCS, finish_writing)
    assert not any(bool(o["flag_at_import"]) for o in outs)


def test_helper_ignores_a_stale_flag(monkeypatch):
    monkeypatch.setattr(jnative, "HAVE_NATIVE", False)
    monkeypatch.setattr(jnative, "_lib", None)
    lib = jax_native(jnative)
    assert lib is not None and jnative._lib is lib and jnative.HAVE_NATIVE
    verts, faces = icosphere(3)
    v, f = jnative.decimate(verts, faces, 200)
    assert 180 <= len(f) <= 200
