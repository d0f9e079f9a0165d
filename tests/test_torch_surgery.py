"""The port's mesh surgery (mesh/surgery.py, train/mesh_update.py's
update_mesh_with_fusion) against the JAX package's on identical numpy
inputs: exactly equal results. The cases are those of
tests/test_surgery_fuzz.py and tests/test_mesh_update.py."""

import dataclasses

import numpy as np
import pytest

from gaustar_tpu.mesh import surgery as jsurgery
from gaustar_tpu.models import sugar as jsugar
from gaustar_tpu.train import mesh_update as jmu
from gaustar_tpu_torch import bridge
from gaustar_tpu_torch.mesh import surgery as tsurgery
from gaustar_tpu_torch.mesh.primitives import icosphere
from gaustar_tpu_torch.train import mesh_update as tmu


def _meshes(mod, base, fusion):
    return (mod.Mesh(base[0].copy(), base[1].copy(), None if base[2] is None else base[2].copy()),
            mod.Mesh(fusion[0].copy(), fusion[1].copy(), None if fusion[2] is None else fusion[2].copy()))


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if hasattr(w, "verts"):
            for name in ("verts", "faces", "face_colors"):
                a, b = getattr(g, name), getattr(w, name)
                if b is None:
                    assert a is None
                else:
                    np.testing.assert_array_equal(a, b, err_msg=f"{k}.{name}")
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=k)


def _fuzz_scene(seed):
    """test_surgery_fuzz's scene: a sphere, and a fusion mesh bumped toward a
    random direction, with detection weights and salt-and-pepper noise."""
    rng = np.random.default_rng(seed)
    bv, bf = icosphere(3, radius=1.0)
    fv, ff = icosphere(3, radius=1.0)
    d = rng.normal(size=3)
    d /= np.linalg.norm(d)
    w = np.clip(fv @ d, 0.0, None) ** 2
    fv = fv * (1.0 + 0.35 * w[:, None])
    cen = bv[bf].mean(axis=1)
    delta = (cen @ d > rng.uniform(0.3, 0.7)).astype(np.float64)
    noise = rng.random(len(bf)) < 0.02
    delta = np.where(noise, 1.0 - delta, delta)
    colors = rng.uniform(size=(len(bf), 3))
    return ((bv.astype(np.float64), bf.astype(np.int64), colors), (fv.astype(np.float64), ff.astype(np.int64), None),
            delta)


@pytest.mark.parametrize("seed", range(8))
def test_update_mesh_topo_fuzz_equals_jax(seed):
    base, fusion, delta = _fuzz_scene(seed)
    kw = dict(delta_threshold=0.6, cc_face_threshold=20, outlier_face_threshold=10, boundary_pad=0.15, aabb_pad=0.05)
    _assert_same(tsurgery.update_mesh_topo(*_meshes(tsurgery, base, fusion), delta, **kw),
                 jsurgery.update_mesh_topo(*_meshes(jsurgery, base, fusion), delta, **kw))


@pytest.mark.parametrize("case", ["none_flagged", "all_flagged", "cut_and_connect"])
def test_update_mesh_topo_cases_equal_jax(case):
    v1, f1 = icosphere(2, radius=1.0)
    base = (v1.astype(np.float64), f1.astype(np.int64), None)
    fusion, kw = base, {}
    if case == "none_flagged":
        delta = np.zeros(len(f1))
    elif case == "all_flagged":
        delta, kw = np.ones(len(f1)), dict(cc_face_threshold=10, outlier_face_threshold=5)
    else:  # tests/test_mesh_update.py::test_surgery_cut_and_connect
        v2, f2 = icosphere(3, radius=1.0)
        fusion = (v2.astype(np.float64), f2.astype(np.int64), None)
        delta = (v1[f1].mean(axis=1)[:, 1] > 0.75).astype(np.float64)
        kw = dict(delta_threshold=0.6, cc_face_threshold=5, outlier_face_threshold=5, aabb_pad=0.05,
                  force_watertight=False, boundary_pad=0.3)
    got = tsurgery.update_mesh_topo(*_meshes(tsurgery, base, fusion), delta, **kw)
    _assert_same(got, jsurgery.update_mesh_topo(*_meshes(jsurgery, base, fusion), delta, **kw))
    if case == "cut_and_connect":
        assert got["cc_update_num"] >= 1 and not got["track_face_mask"].all()


def test_fill_holes_equals_jax():
    v, f = icosphere(1)
    meshes = []
    for mod in (tsurgery, jsurgery):
        m = mod.Mesh(v.astype(np.float64), f.astype(np.int64), np.ones((len(f), 3)))
        m.update_faces(~np.isin(np.arange(len(f)), [0, 5, 6, 40]))  # holes of several sizes
        mod.fill_holes(m)
        meshes.append(m)
    assert len(meshes[0].faces) > len(f) - 4  # something was filled
    _assert_same({"m": meshes[0]}, {"m": meshes[1]})


def test_update_mesh_with_fusion_equals_jax():
    """The five-padding driver on one SuGaR model: the JAX package's params,
    carried into the port, and one fusion mesh, a cap bumped outward."""
    rng = np.random.default_rng(3)
    v1, f1 = icosphere(2, radius=1.0)
    jp, jc = jsugar.init_sugar(v1, f1, vertex_colors=rng.uniform(size=(len(v1), 3)).astype(np.float32))
    tp = bridge.sugar_params_from_numpy({f.name: np.array(getattr(jp, f.name)) for f in dataclasses.fields(jp)},
                                        "cpu")
    tc = bridge.sugar_config_from_numpy(
        dict(faces=np.array(jc.faces), bary=np.array(jc.bary), thickness=np.array(jc.thickness),
             n_gaussians_per_face=jc.n_gaussians_per_face, sh_levels=jc.sh_levels, min_scale=jc.min_scale,
             max_scale=jc.max_scale), "cpu")
    v2, f2 = icosphere(3, radius=1.0)
    v2 = v2 * (1.0 + 0.3 * np.clip(v2[:, 1] - 0.6, 0.0, None))[:, None]
    fusion = (v2.astype(np.float64), f2.astype(np.int64), rng.uniform(size=(len(f2), 3)))
    delta = (v1[f1].mean(axis=1)[:, 1] > 0.7).astype(np.float64)
    kw = dict(cc_face_threshold=5, outlier_face_threshold=5, force_watertight=False, boundary_pad=0.3)
    got = tmu.update_mesh_with_fusion(tp, tc, tsurgery.Mesh(*(a.copy() for a in fusion)), delta, **kw)
    want = jmu.update_mesh_with_fusion(jp, jc, jsurgery.Mesh(*(a.copy() for a in fusion)), delta, **kw)
    assert got["cc_update_num"] >= 1
    _assert_same(got, want)
    _assert_same({"color_mesh": tmu.get_color_mesh(tp, tc)}, {"color_mesh": jmu.get_color_mesh(jp, jc)})


@pytest.mark.parametrize("threshold", [None, 30], ids=["relative", "absolute"])
def test_outlier_cc_mask_equals_jax(threshold):
    """Components of many sizes (spheres, a strip, single faces): the same
    faces kept, though the port labels components its own way."""
    v1, f1 = icosphere(2)
    v2, f2 = icosphere(1)
    parts, n = [], 0
    for f, nv in ((f1, len(v1)), (f2, len(v2)), (f1[:40], len(v1)), (f2[:3], len(v2)), (f1[:1], len(v1))):
        parts.append(f + n)
        n += nv
    faces = np.concatenate(parts)[np.random.default_rng(9).permutation(sum(len(p) for p in parts))]
    got = tsurgery.get_outlier_cc_mask(faces, threshold)
    np.testing.assert_array_equal(got, jsurgery.get_outlier_cc_mask(faces, threshold))
    assert 0 < got.sum() < len(faces)


def _torn_mesh(mod, seed, torn=0.33):
    """A sphere with a share `torn` of its faces removed and 40 random
    triangles over 30 of its vertices (some degenerate): boundaries with
    non-manifold vertices, tails into short cycles and holes of every size."""
    rng = np.random.default_rng(seed)
    v, f = icosphere(2)
    soup = rng.integers(0, 30, size=(40, 3))
    faces = np.concatenate([f[rng.uniform(size=len(f)) > torn], soup]).astype(np.int64)
    return mod.Mesh(v.astype(np.float64), faces, rng.uniform(size=(len(faces), 3)))


@pytest.mark.parametrize("max_loop", [4, 6])
@pytest.mark.parametrize("seed", range(6))
def test_hole_repair_on_torn_meshes_equals_jax(seed, max_loop):
    t, j = _torn_mesh(tsurgery, seed), _torn_mesh(jsurgery, seed)
    np.testing.assert_array_equal(t.boundary_edges_directed(), j.boundary_edges_directed())
    tsurgery.fill_holes(t, max_loop=max_loop)
    jsurgery.fill_holes(j, max_loop=max_loop)
    assert len(t.faces) > len(_torn_mesh(tsurgery, seed).faces)  # something was filled
    _assert_same({"filled": t}, {"filled": j})
    # Fewer faces torn: separate holes, some small enough to merge.
    t, j = _torn_mesh(tsurgery, seed, 0.08), _torn_mesh(jsurgery, seed, 0.08)
    tsurgery.merge_vert_around_holes(t, max_hole_vert_num=max_loop + 4)
    jsurgery.merge_vert_around_holes(j, max_hole_vert_num=max_loop + 4)
    assert not np.array_equal(t.verts, _torn_mesh(tsurgery, seed, 0.08).verts)  # something was merged
    t.update_faces(t.nondegenerate_faces())
    j.update_faces(j.nondegenerate_faces())
    t.remove_unreferenced_vertices()
    j.remove_unreferenced_vertices()
    _assert_same({"merged": t}, {"merged": j})
