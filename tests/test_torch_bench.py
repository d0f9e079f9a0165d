"""The port's bench entry points (gaustar_tpu_torch/bench.py and
bench_scaling.py) against the JAX repository's bench.py and
bench_scaling.py, on the CPU at small widths:

  - the bench scene: bench.py:build_scene (loaded by AST without its
    import-time jit-cache switch, tests/port_examples.py, with W, H, N_LAT
    and N_LON set small) against utils/synthetic.reference_scene at the
    same widths;
  - three bench steps at B = 1 and at B = 4, the cameras cycling, against
    bench.py's own one_step (compute_losses / compute_losses_multi,
    make_sugar_optimizer, optax.apply_updates) on the JAX blend with
    RasterConfig(impl="jax", max_per_tile=4096): losses at rtol 1e-3 and
    each parameter group within 2 x the sum of its learning rates
    (tests/test_torch_refine.py);
  - bench.main's JSON line and --detail record;
  - bench_scaling on 1 and 2 gloo ranks with --small."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.ops.rasterizer import RasterConfig as JaxRasterConfig
from gaustar_tpu.train import refine as jrefine
from gaustar_tpu.train.optimizer import OptimizationParams as JOptimizationParams
from gaustar_tpu.train.optimizer import make_sugar_optimizer
from gaustar_tpu_torch import bench, bench_scaling
from gaustar_tpu_torch.train.optimizer import OptimizationParams, make_lr_fn
from gaustar_tpu_torch.utils.synthetic import reference_scene
from port_examples import jax_cache_options, load_script, nested_function
from port_helpers import one_thread  # noqa: F401  (autouse)

# 128x96 at bench.py's focal 1600 sees a 0.27 x 0.2 m patch of the sphere:
# about 1,200 pairs a camera on uv_sphere(25, 30) (8,640 gaussians).
W, H, LAT, LON = 128, 96, 25, 30
STEPS = 3
JAX_RCFG = JaxRasterConfig(max_pairs=1 << 14, max_per_tile=4096, impl="jax")
TINY = ["--device", "cpu", "--width", "64", "--height", "48", "--lat", "9", "--lon", "12"]


@pytest.fixture(scope="module")
def script():
    return load_script("bench.py", W=W, H=H, N_LAT=LAT, N_LON=LON)


@pytest.fixture(scope="module")
def jax_scene(script):
    params, config, data, _ = script["build_scene"]()
    return params, config, data


@pytest.fixture(scope="module")
def port_scene():
    return reference_scene("cpu", w=W, h=H, n_lat=LAT, n_lon=LON)


def _close(got, ref, rtol=1e-6, atol=0.0, name=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64), rtol=rtol, atol=atol,
                               err_msg=name)


def test_loading_bench_changes_no_jax_config():
    before = jax_cache_options()
    assert callable(load_script("bench.py")["build_scene"])
    assert jax_cache_options() == before


def test_reference_scene_equals_build_scene(jax_scene, port_scene):
    jp, jc, jd = jax_scene
    tp, tc, td, _ = port_scene
    for name, leaf in tp.named():
        _close(leaf.detach().numpy(), getattr(jp, name), atol=1e-7, name=name)
    np.testing.assert_array_equal(tc.faces.numpy(), np.asarray(jc.faces))
    _close(tc.bary.numpy(), jc.bary, name="bary")
    _close(tc.thickness.numpy(), jc.thickness, name="thickness")
    for k in ("R", "T", "fx", "fy", "cx", "cy"):
        _close(getattr(td.cameras, k).numpy(), getattr(jd.cameras, k), atol=1e-7, name=k)
    assert (td.cameras.width, td.cameras.height) == (jd.cameras.width, jd.cameras.height) == (W, H)
    np.testing.assert_array_equal(td.gt_images.numpy(), np.asarray(jd.gt_images))
    np.testing.assert_array_equal(td.gt_depths.numpy(), np.asarray(jd.gt_depths))
    for k in ("margins", "edges", "adj_faces"):
        np.testing.assert_array_equal(getattr(td, k).numpy(), np.asarray(getattr(jd, k)), err_msg=k)
    for k in ("ref_edge_len", "ref_area", "face_edge_ref", "face_edge_w"):
        _close(getattr(td, k).numpy(), getattr(jd, k), name=k)
    for got, ref in zip(td.adj_gather, jd.adj_gather):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("batch", [1, 2, 4])
def test_step_cameras_cycle_as_bench_py(batch):
    for it in range(6):
        ref = jnp.mod(it, 4) if batch == 1 else jnp.mod(it * batch + jnp.arange(batch), 4)
        assert np.array_equal(np.asarray(bench.step_cameras(it, batch)), np.asarray(ref))


def _jax_steps(script, scene, batch):
    """STEPS of bench.py's one_step on the JAX scene: (params, losses)."""
    params, config, data = scene
    optimizer = make_sugar_optimizer(JOptimizationParams(), 1.0)
    one_step = nested_function(
        script, "main", "one_step", batch=batch, config=config, data=data, raster_cfg=JAX_RCFG,
        cfg=jrefine.RefineConfig(num_iterations=2000, loose_bind_from=10**9, do_sh_warmup=False),
        optimizer=optimizer, uw=jnp.zeros((params.scales.shape[0],), jnp.float32),
        pre=params.sh_dc[:, 0, :] * 0.0, compute_losses=jrefine.compute_losses, jax=jax, jnp=jnp)
    step = jax.jit(one_step)
    opt_state = optimizer.init(params)
    losses = []
    for it in range(STEPS):
        params, opt_state, loss = step(params, opt_state, jnp.int32(it))
        losses.append(float(loss))
    return params, losses


@pytest.mark.parametrize("batch", [1, 4], ids=["B1", "B4"])
def test_bench_steps_match_bench_py(script, jax_scene, port_scene, batch):
    jp, jlosses = _jax_steps(script, jax_scene, batch)
    tp, step = bench.make_step(*port_scene, batch)
    tlosses, pairs = [], []
    for it in range(STEPS):
        loss, loss_dict = step(it)
        tlosses.append(float(loss))
        pairs.append(loss_dict["num_pairs"])
    assert 0 < max(pairs) <= JAX_RCFG.max_pairs
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-3)
    # Adam at eps 1e-15 moves a parameter by about lr a step in the sign of
    # its gradient, float noise included: two correct runs differ by at most
    # 2 x the sum of the group's learning rates.
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    lr_sum = {k: sum(lr_fn(c)[k] for c in range(STEPS)) for k in lr_fn(0)}
    for name, p in tp.named():
        diff = np.abs(p.detach().numpy() - np.asarray(getattr(jp, name))).max()
        assert diff <= 2 * lr_sum[name] * (1 + 1e-5), f"{name}: {diff} > 2 * {lr_sum[name]}"
    moved = np.abs(tp.points.detach().numpy() - port_scene[0].points.detach().numpy()).max()
    assert moved > 0  # the bench's copy trained; the scene's params are untouched
    np.testing.assert_array_equal(port_scene[0].points.detach().numpy(), np.asarray(jax_scene[0].points))


@pytest.mark.parametrize("batch", [1, 4])
def test_main_prints_the_result_line(batch, tmp_path, capsys):
    path = tmp_path / "detail.json"
    out = bench.main(TINY + ["--batch", str(batch), "--steps", "2", "--detail", str(path)])
    printed = capsys.readouterr()
    line = json.loads(printed.out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"metric", "value", "unit", "batch", "ms_per_camera", "device"}
    assert line["device"] == "cpu" and line["unit"] == "Mpix/s" and line["batch"] == batch
    step_s = line["ms_per_camera"] * batch / 1e3
    assert line["value"] == pytest.approx(64 * 48 * batch / step_s / 1e6, rel=1e-9)
    assert "n_gauss=1152" in printed.err and "largest num_pairs" in printed.err
    stages = json.loads(path.read_text())
    for k in ("preprocess_binning_s", "render_fwd_s", "render_fwdbwd_s", "blend_fwd_est_s"):
        assert np.isfinite(stages[k]), k
    assert stages["blend_fwd_est_s"] == pytest.approx(stages["render_fwd_s"] - stages["preprocess_binning_s"])


@pytest.mark.parametrize("module", [bench, bench_scaling], ids=["bench", "bench_scaling"])
def test_entry_points_refuse_to_run_without_a_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])


@pytest.fixture(scope="module")
def scaling():
    return bench_scaling.run("cpu", small=True, max_ranks=2)


def test_scaling_record_shape(scaling):
    assert {"metric", "value", "unit", "detail", "cards", "device", "n_cores"} <= set(scaling)
    assert scaling["unit"] == "efficiency" and scaling["device"] == "cpu"
    assert list(scaling["detail"]) == ["1", "2"]
    assert scaling["detail"]["1"]["backend"] is None and scaling["detail"]["2"]["backend"] == "gloo"
    assert "note" not in scaling
    json.loads(json.dumps(scaling))


def test_scaling_efficiency_is_t1_over_t2(scaling):
    d = scaling["detail"]
    assert d["1"]["efficiency"] == 1.0
    assert d["2"]["efficiency"] == d["1"]["step_s"] / d["2"]["step_s"]
    headline = "2" if scaling["n_cores"] >= 2 else "1"
    assert scaling["value"] == d[headline]["efficiency"]
    assert d["2"].get("oversubscribed", False) == (scaling["n_cores"] < 2)


def test_scaling_ranks_agree_on_a_finite_loss(scaling):
    a, b = scaling["detail"]["2"]["losses"]
    assert np.isfinite(a) and a == b
    assert np.isfinite(scaling["detail"]["1"]["losses"][0])
