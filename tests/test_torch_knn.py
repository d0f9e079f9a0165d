"""The port's brute-force KNN against the JAX package's (ops/knn.py), and
sugar.compute_density on the small sphere of tests/test_reference_knobs.py.

Both packages take squared distances through |q|^2 - 2 q.p + |p|^2. The JAX
package expands raw coordinates, which cancels far from the origin; the port
expands them relative to the centroid. So the tolerance against the JAX
package is stated per cloud in ulps of its largest |q|^2: near the origin
(|q|^2 < 2) atol 1e-6, at z = 4 (|q|^2 up to 21, where an ulp is 1.9e-6)
atol 2e-5. Against exact float64 distances the port holds 1e-6 at both.
Indices are compared only where the distances of a row are separated by
more than twice the tolerance (torch.topk orders ties its own way)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.mesh.primitives import uv_sphere
from gaustar_tpu.models import sugar as jsugar
from gaustar_tpu.ops import knn as jknn
from gaustar_tpu_torch.models import sugar as tsugar
from gaustar_tpu_torch.ops import knn as tknn
from port_helpers import port_sugar

# (name, centre along z, atol)
CLOUDS = [("origin", 0.0, 1e-6), ("z4", 4.0, 2e-5)]
N_POINTS = 2500  # not a multiple of the 1024 chunk
N_QUERY = 1100


def _cloud(z, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(scale=0.3, size=(n, 3)) + np.array([0.0, 0.0, z])).astype(np.float32)


def _separated(d, tol):
    """[Q, k] bool: entries whose distance lies more than 2 tol from both
    neighbours in its sorted row (its rank is then unambiguous). The last
    column's right neighbour lies outside the row, so it never counts."""
    gap = np.diff(d, axis=1) > 2 * tol
    left = np.concatenate([np.ones((len(d), 1), bool), gap], axis=1)
    right = np.concatenate([gap, np.zeros((len(d), 1), bool)], axis=1)
    return left & right


@pytest.mark.parametrize("name,z,tol", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_knn_sq_dists_and_dist2_avg3_match_jax(name, z, tol):
    pts = _cloud(z, N_POINTS, seed=1)
    ref = np.asarray(jknn.knn_sq_dists(jnp.asarray(pts), k=3))
    got = tknn.knn_sq_dists(torch.as_tensor(pts), k=3).numpy()
    assert got.shape == (N_POINTS, 3) and (got >= 0).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)
    np.testing.assert_allclose(tknn.dist2_avg3(torch.as_tensor(pts)).numpy(),
                               np.asarray(jknn.dist2_avg3(jnp.asarray(pts))), rtol=0, atol=tol)


@pytest.mark.parametrize("name,z,tol", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_knn_points_matches_jax(name, z, tol):
    ref_pts, query = _cloud(z, N_POINTS, seed=2), _cloud(z, N_QUERY, seed=3)
    jd, ji = jknn.knn_points(jnp.asarray(query), jnp.asarray(ref_pts), k=16)
    td, ti = tknn.knn_points(torch.as_tensor(query), torch.as_tensor(ref_pts), 16)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert td.shape == (N_QUERY, 16) and ti.dtype == torch.int64
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=tol)
    sep = _separated(jd, tol)
    assert sep.mean() > 0.5  # the comparison covers most entries
    np.testing.assert_array_equal(ti.numpy()[sep], ji[sep])


def _exact_sq_dists(pts, k):
    p = pts.astype(np.float64)
    d = ((p[:, None] - p[None]) ** 2).sum(-1)
    d.sort(axis=1)
    return d[:, 1:k + 1]


@pytest.mark.parametrize("name,z,tol", CLOUDS, ids=[c[0] for c in CLOUDS])
def test_knn_sq_dists_against_exact_distances(name, z, tol):
    """The port within 1e-6 of float64 distances wherever the cloud sits;
    the JAX package's raw expansion misses them by up to its tolerance at
    z = 4 (it is printed, not held)."""
    pts = _cloud(z, 1500, seed=5)
    exact = _exact_sq_dists(pts, 3)
    got = tknn.knn_sq_dists(torch.as_tensor(pts), k=3).numpy()
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    jax_err = float(np.abs(np.asarray(jknn.knn_sq_dists(jnp.asarray(pts), k=3)) - exact).max())
    assert jax_err <= tol
    print(f"{name}: the JAX package's largest error {jax_err:.3e}")


def test_knn_excludes_the_point_itself():
    """The k + 1 smallest with the first dropped: on a grid of spacing 0.1
    near the origin, every interior point's 3 nearest lie at 0.01."""
    g = np.stack(np.meshgrid(*[np.arange(6) * 0.1] * 3, indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    d = tknn.knn_sq_dists(torch.as_tensor(g), k=3).numpy()
    interior = ((g > 0.05) & (g < 0.45)).all(axis=1)
    np.testing.assert_allclose(d[interior], 0.01, rtol=1e-4)


@pytest.mark.parametrize("thickness,rtol", [(1e-3, 1e-5), (1e-6, 2e-4)], ids=["thick", "default_thickness"])
def test_compute_density_matches_jax(thickness, rtol):
    """The small sphere of test_reference_knobs (uv_sphere(7, 10), 6
    gaussians a face) with seeded opacities and scales: densities at the
    centres and about 1 cm off them (0 where the normal offset dwarfs the
    thickness). The inverse thickness multiplies the packages' ulp-level
    differences of the centres (about 2.4e-7 at z = 3), so the tolerance
    grows with it: rtol 1e-5 at 1 mm, 2e-4 at the default 1e-6."""
    verts, faces = uv_sphere(7, 10, radius=0.5, center=(0.0, 0.0, 3.0))
    jp, jc = jsugar.init_sugar(verts, faces, thickness=thickness)
    rng = np.random.default_rng(4)
    jp = jp.__class__(**{**{k: getattr(jp, k) for k in jp.__dataclass_fields__},
                         "densities": jnp.asarray(rng.normal(size=jp.densities.shape), jnp.float32),
                         "scales": jp.scales + jnp.asarray(rng.normal(scale=0.3, size=jp.scales.shape), jnp.float32)})
    tp, tc = port_sugar(jp, jc)
    centers = np.asarray(jsugar.gaussian_centers(jp, jc))
    x = np.concatenate([centers[::5], centers[::7] + rng.normal(scale=0.01, size=centers[::7].shape)]).astype(np.float32)
    ref = np.asarray(jsugar.compute_density(jp, jc, jnp.asarray(x), k=16))
    got = tsugar.compute_density(tp, tc, torch.as_tensor(x), k=16).numpy()
    assert (ref[: len(centers[::5])] > 0).all()
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-7)
