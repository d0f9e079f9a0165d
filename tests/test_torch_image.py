"""The port's small helpers of the topology event against the JAX package:
image ops (ops/image.py), the fusion orbit cameras, the dc colour, face
components and the detection's host geometry, on seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu import cameras as jcameras
from gaustar_tpu.mesh import topology as jtopology
from gaustar_tpu.ops import image as jimage
from gaustar_tpu.ops import sh as jsh
from gaustar_tpu.tools import geometry as jgeo
from gaustar_tpu_torch import cameras as tcameras
from gaustar_tpu_torch.mesh import topology as ttopology
from gaustar_tpu_torch.mesh.primitives import icosphere, uv_sphere
from gaustar_tpu_torch.ops import image as timage
from gaustar_tpu_torch.ops import sh as tsh
from gaustar_tpu_torch.tools import geometry as tgeo

TOL = 1e-6  # float32 box sums and bilinear weights, taken in the same order


def _depth(seed=0, h=37, w=53):
    """A depth map with foreground (< 10), background (10.5) and edges."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    d = 3.0 + 0.02 * xx + 0.01 * yy + rng.normal(scale=0.01, size=(h, w))
    d = np.where((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (h / 3) ** 2, d, 10.5)
    return d.astype(np.float32)


@pytest.mark.parametrize("k", [3, 5])
def test_box_blur_matches_jax(k):
    x = np.random.default_rng(1).normal(size=(29, 41)).astype(np.float32)
    got = timage.box_blur(torch.as_tensor(x), k).numpy()
    np.testing.assert_allclose(got, np.asarray(jimage.box_blur(jnp.asarray(x), k)), atol=TOL)


@pytest.mark.parametrize("background", [True, False], ids=["with_background", "all_background"])
def test_depth_edge_matches_jax(background):
    d = _depth() if background else np.full((20, 30), 10.5, np.float32)
    got = timage.depth_edge(torch.as_tensor(d), 3).numpy()
    np.testing.assert_allclose(got, np.asarray(jimage.depth_edge(jnp.asarray(d), 3)), atol=TOL)


@pytest.mark.parametrize("kind", ["nearest", "bilinear"])
def test_queries_match_jax(kind):
    img = _depth(2)
    rng = np.random.default_rng(3)
    # inside, on the borders, half-pixel ties and outside
    rc = np.concatenate([rng.uniform(-3, 60, size=(500, 2)), [[0, 0], [36, 52], [2.5, 7.5], [-0.5, 3.0]]])
    rc = rc.astype(np.float32)
    tq = {"nearest": timage.query_nearest, "bilinear": timage.query_bilinear}[kind]
    jq = {"nearest": jimage.query_nearest, "bilinear": jimage.query_bilinear}[kind]
    tv, tin = tq(torch.as_tensor(img), torch.as_tensor(rc))
    jv, jin = jq(jnp.asarray(img), jnp.asarray(rc))
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=TOL)


def test_orbit_cameras_match_jax():
    center = np.array([0.1, -0.2, 4.0])
    tc = tcameras.orbit_cameras(center, 3.0, 160, 96, 150.0, device="cpu")
    jc = jcameras.orbit_cameras(center, 3.0, 160, 96, 150.0)
    assert len(tc) == len(jc) == 60  # 12 azimuths x 5 elevations
    for t, j in zip(tc, jc):
        for name in ("R", "T", "fx", "fy", "cx", "cy", "view", "full_proj"):
            np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)), err_msg=name)
        assert (t.width, t.height) == (j.width, j.height)
        # -R @ T: a float32 product whose sums each framework orders its own way
        np.testing.assert_allclose(t.camera_center.numpy(), np.asarray(j.camera_center), rtol=1e-6)


def test_sh_to_rgb_dc_matches_jax():
    sh = np.random.default_rng(4).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(tsh.sh_to_rgb_dc(torch.as_tensor(sh)).numpy(),
                                  np.asarray(jsh.sh_to_rgb_dc(jnp.asarray(sh))))


def test_face_connected_components_match_jax():
    v1, f1 = icosphere(1)
    v2, f2 = uv_sphere(5, 7)
    faces = np.concatenate([f1, f2 + len(v1), f1[:7] + len(v1) + len(v2)])
    np.testing.assert_array_equal(ttopology.face_connected_components(faces),
                                  jtopology.face_connected_components(faces))


def test_detection_geometry_matches_jax():
    verts, faces = icosphere(2, radius=0.6)
    verts = verts.astype(np.float64)
    topo = ttopology.build_topology(faces, len(verts))
    rng = np.random.default_rng(5)
    value = rng.uniform(size=(len(verts), 3))
    valid = rng.uniform(size=len(verts)) < 0.3
    args = (topo.vert_adj, topo.vert_adj_count, valid, value)
    np.testing.assert_array_equal(tgeo.mesh_vert_propagate(*args, max_ite=5), jgeo.mesh_vert_propagate(*args, max_ite=5))
    tc, tv = tgeo.build_voxel_from_pc(verts, value, 0.1)
    jc, jv = jgeo.build_voxel_from_pc(verts, value, 0.1)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tgeo.interpolate_in_voxel(verts, tc, tv, 0.1), jgeo.interpolate_in_voxel(verts, jc, jv, 0.1))


def test_propagation_on_pole_adjacency_matches_jax():
    """Twenty rounds over a uv-sphere's padded adjacency (its poles have 40
    neighbours, most rows a few): the rounds' filled rows and sums equal."""
    verts, faces = uv_sphere(31, 40, radius=0.6)
    topo = ttopology.build_topology(faces, len(verts))
    assert topo.vert_adj.shape[1] == 40
    rng = np.random.default_rng(6)
    value = rng.uniform(size=(len(verts), 3))
    valid = rng.uniform(size=len(verts)) < 0.05
    args = (topo.vert_adj, topo.vert_adj_count, valid, value)
    got = tgeo.mesh_vert_propagate(*args, max_ite=20)
    np.testing.assert_array_equal(got, jgeo.mesh_vert_propagate(*args, max_ite=20))
    assert not np.array_equal(got, value)
