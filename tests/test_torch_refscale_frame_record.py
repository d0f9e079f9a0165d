"""refscale.frame's record around its stages (the stages themselves are
held against the JAX script in test_torch_refscale_frame.py): the native
library and the kernels are built before the first timed segment, the
camera batch reaches the refine and the re-refine, and the steady rate
counts every camera of a batch."""

import types

import numpy as np
import pytest
import torch

from gaustar_tpu_torch.refscale import common, frame
from gaustar_tpu_torch.train import mesh_update, topo_detect
from gaustar_tpu_torch.utils import synthetic

W, H = 64, 48


@pytest.fixture(scope="module")
def scene():
    return synthetic.reference_scene("cpu", w=W, h=H, n_lat=9, n_lon=12)


def _run(scene, monkeypatch, batch, cc_update_num):
    params, config, data, raster_cfg = scene
    calls = []

    def fake_train(params, config, data, raster_cfg, cfg, iters, rng, batch=1, label="refine", log=print):
        calls.append(("train", label, iters, batch))
        segs = [{"ms_per_iter": ms} for ms in (40.0, 30.0, 30.0, 25.0)]
        return params, {"segments": segs}

    n_faces = config.faces.shape[0]
    monkeypatch.setattr(common, "build_libraries", lambda dev: calls.append(("build", dev.type)) or 1.5)
    monkeypatch.setattr(frame, "train_frame", fake_train)
    monkeypatch.setattr(topo_detect, "detect_topo_err", lambda *a, **k: np.full(n_faces, 0.9, np.float32))
    monkeypatch.setattr(topo_detect, "last_telemetry", types.SimpleNamespace(observed_fraction=0.5))
    monkeypatch.setattr(mesh_update, "extract_mesh_fusion",
                        lambda *a, **k: types.SimpleNamespace(faces=np.zeros((7, 3), np.int32)))
    monkeypatch.setattr(mesh_update, "last_fusion", {"views": 3, "blocks": 2})
    update = {"cc_update_num": cc_update_num,
              "updated_mesh": types.SimpleNamespace(faces=np.zeros((11, 3), np.int32))}
    monkeypatch.setattr(mesh_update, "update_mesh_with_fusion", lambda *a, **k: update)
    monkeypatch.setattr(frame, "re_refine_inputs", lambda update, data, dev: (params, config, data))
    out = frame.run(params, config, data, raster_cfg, 200, batch=batch, log=lambda m: None)
    return out["report"], calls


@pytest.mark.parametrize("batch", [1, 4])
def test_builds_first_and_counts_the_batch(scene, monkeypatch, batch):
    report, calls = _run(scene, monkeypatch, batch, cc_update_num=2)
    assert calls == [("build", "cpu"), ("train", "refine", 200, batch), ("train", "re_refine", 100, batch)]
    assert report["build_s"] == 1.5 and report["camera_batch"] == batch
    assert report["steady_ms_per_iter"] == 25.0
    assert report["steady_mpix_s"] == pytest.approx(W * H * batch / 0.025 / 1e6)
    assert report["detect_flagged_faces"] == scene[1].faces.shape[0]
    assert report["cc_update_num"] == 2 and report["updated_faces"] == 11 and report["fusion_views"] == 6


def test_no_update_no_re_refine(scene, monkeypatch):
    report, calls = _run(scene, monkeypatch, 4, cc_update_num=0)
    assert [c[1] for c in calls if c[0] == "train"] == ["refine"]
    assert "updated_faces" not in report and "re_refine" not in report


def test_build_libraries_builds_native_on_the_cpu(monkeypatch):
    from gaustar_tpu_torch import native
    from gaustar_tpu_torch.ops import _build

    built = []
    monkeypatch.setattr(native, "build", lambda: built.append("native"))
    monkeypatch.setattr(_build, "build", lambda names: built.append(tuple(names)))
    common.build_libraries(torch.device("cpu"))
    assert built == ["native"]
    common.build_libraries(torch.device("cuda", 0))
    assert built == ["native", "native", ("blend_fwd", "blend_bwd", "pixel_loss")]  # the refine step's kernels
