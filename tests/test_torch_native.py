"""The port's native mesh library against the JAX package's: the same
meshops.cpp built with the same g++ flags on one machine, so decimate,
laplacian_smooth, knn3_mean_sq_dist and face_components are bit-equal. And
there is no fallback: without g++ the build raises."""

import numpy as np
import pytest

from gaustar_tpu import native as jnative
from gaustar_tpu.mesh.primitives import icosphere, uv_sphere
from gaustar_tpu_torch import native as tnative
from port_native import jax_native


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's libmeshops.so, loaded in this worker (its `make`
    may still be running in another one: tests/port_native.py)."""
    return jax_native(jnative)


def _noisy_sphere(seed, subdiv=4):
    rng = np.random.default_rng(seed)
    verts, faces = icosphere(subdiv, radius=0.6, center=(0, 0, 4.0))
    return verts + rng.normal(scale=0.004, size=verts.shape), faces


@pytest.mark.parametrize("target", [600, 2000])
def test_decimate_bit_equal(jax_lib, target):
    verts, faces = _noisy_sphere(target)
    tv, tf = tnative.decimate(verts, faces, target)
    jv, jf = jnative.decimate(verts, faces, target)
    assert target * 0.9 <= len(tf) <= target
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_decimate_open_mesh_bit_equal(jax_lib):
    verts, faces = uv_sphere(20, 30, radius=1.0)
    keep = verts[faces].mean(axis=1)[:, 2] < 0.5  # cut a cap: a border to keep
    tv, tf = tnative.decimate(verts, faces[keep], 300, aggressiveness=5.0)
    jv, jf = jnative.decimate(verts, faces[keep], 300, aggressiveness=5.0)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


@pytest.mark.parametrize("iters,lam", [(1, 0.5), (10, 0.5), (5, 0.3)])
def test_laplacian_smooth_bit_equal(jax_lib, iters, lam):
    verts, faces = _noisy_sphere(iters)
    out = tnative.laplacian_smooth(verts, faces, iters, lam)
    np.testing.assert_array_equal(out, jnative.laplacian_smooth(verts, faces, iters, lam))
    assert out.std() < verts.std()


def test_knn3_and_face_components_bit_equal(jax_lib):
    rng = np.random.default_rng(3)
    pts = np.concatenate([rng.normal(size=(3000, 3)), rng.normal(scale=0.01, size=(500, 3)) + 2.0]).astype(np.float32)
    np.testing.assert_array_equal(tnative.knn3_mean_sq_dist(pts), jnative.knn3_mean_sq_dist(pts, prefer_native=True))
    v1, f1 = icosphere(2)
    faces = np.concatenate([f1, f1 + len(v1), f1[:40] + 2 * len(v1)])
    labels = tnative.face_components(faces, 3 * len(v1))
    np.testing.assert_array_equal(labels, jnative.face_components(faces, 3 * len(v1)))
    assert len(np.unique(labels)) == 3


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.decimate(*icosphere(1), 10)
