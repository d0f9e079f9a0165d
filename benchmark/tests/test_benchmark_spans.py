"""benchmark/spans.py: attribution on a hand-built Chrome trace, and the
span metrics in a traced run of a cell on a small scene on the CPU, with
the program's recorder and without it (as at a commit that lacks it)."""

from __future__ import annotations

import json

import pytest

from benchmark import harness, spans
from benchmark.tests.small import CELLS, small_config

MAIN, AUTOGRAD = 11, 22
SPAN_METRICS = set(spans.LAYERS) | {"pairs_per_render"}


def _span(index, name, tid, a, b, parent):
    return {"ph": "X", "cat": spans.SPAN_CAT, "name": name, "pid": 1, "tid": tid, "ts": a, "dur": b - a,
            "args": {"index": index, "parent": parent, "step": 4}}


def _launch(corr, tid, t, name="cudaLaunchKernel", dur=1.0):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": tid, "ts": t, "dur": dur,
            "args": {"correlation": corr}}


def _device(corr, a, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": f"k{corr}", "pid": 0, "tid": 7, "ts": a, "dur": dur,
            "args": {"correlation": corr}}


def hand_built_trace() -> dict:
    """One step, times in microseconds: the main thread's layer spans, the
    backward blend on the autograd thread, a backward launch on that thread
    in no span of its own, a launch after the step, a kernel whose launch
    the trace lacks, a copy and a fill."""
    ev = [
        _span(0, "refine.step", MAIN, 0, 100_000, -1),
        _span(1, "refine.geometry", MAIN, 1_000, 10_000, 0),
        _span(2, "render.colour", MAIN, 10_000, 12_000, 0),
        _span(3, "render.rasterize", MAIN, 12_000, 30_000, 0),
        _span(4, "render.blend_fwd", MAIN, 20_000, 25_000, 3),
        _span(5, "loss.pixel", MAIN, 30_000, 45_000, 0),
        _span(6, "loss.mesh", MAIN, 45_000, 50_000, 0),
        _span(7, "refine.backward", MAIN, 50_000, 80_000, 0),
        _span(8, "render.blend_bwd", AUTOGRAD, 60_000, 70_000, -1),
        _span(9, "refine.adam", MAIN, 80_000, 99_000, 0),
    ]
    launches = [  # correlation, thread, launch start, device start, device ms, category
        (1, MAIN, 2_000, 2_100, 1.0, "kernel"),  # geometry
        (2, MAIN, 3_000, 3_200, 0.5, "gpu_memcpy"),  # geometry's copy
        (3, MAIN, 11_000, 11_100, 0.25, "kernel"),  # colour
        (4, MAIN, 13_000, 13_100, 2.0, "kernel"),  # rasterize itself
        (5, MAIN, 21_000, 21_100, 3.0, "kernel"),  # blend forward
        (6, MAIN, 31_000, 31_100, 4.0, "kernel"),  # pixel losses
        (7, MAIN, 46_000, 46_100, 0.75, "gpu_memset"),  # mesh losses' fill
        (8, AUTOGRAD, 61_000, 61_100, 5.0, "kernel"),  # blend backward, its span on the autograd thread
        (9, AUTOGRAD, 72_000, 72_100, 6.0, "kernel"),  # autograd thread, no span of its own: refine.backward
        (10, MAIN, 81_000, 81_100, 1.5, "kernel"),  # Adam
        (11, MAIN, 99_500, 99_600, 0.125, "kernel"),  # refine.step itself
        (12, MAIN, 100_500, 100_600, 0.5, "kernel"),  # after the step: no span
    ]
    for corr, tid, t, a, ms, cat in launches:
        ev.append(_launch(corr, tid, t, "cudaMemcpyAsync" if cat == "gpu_memcpy" else "cudaLaunchKernel"))
        ev.append(_device(corr, a, 1e3 * ms, cat))
    ev.append(_device(99, 101_500, 250.0))  # its launch is not in the trace: no span
    ev.append(_launch(13, MAIN, 99_100))  # a launch whose kernel the profiler lost
    ev.append(_launch(None, MAIN, 14_000, "cudaStreamSynchronize", dur=500.0))  # a sync in rasterize
    ev.append(_launch(None, AUTOGRAD, 73_000, "cudaStreamSynchronize"))  # a sync in the backward
    for e in ev:
        if e["args"].get("correlation") is None:
            e["args"].pop("correlation", None)
    return {"traceEvents": ev, "programRecord": {"main_thread": MAIN, "counts": {"pairs": 3000, "renders": 2}}}


def test_attribution_of_a_hand_built_trace():
    m = spans.attribute(hand_built_trace(), steps=1)
    assert m["device_ms"] == pytest.approx({
        "geometry_device_ms": 1.0 + 0.5 + 0.25, "raster_fwd_device_ms": 2.0 + 3.0, "pixel_loss_device_ms": 4.0,
        "mesh_loss_device_ms": 0.75, "backward_device_ms": 5.0 + 6.0, "adam_device_ms": 1.5}, abs=1e-12)
    assert m["outside_device_ms"] == pytest.approx(0.5 + 0.25)
    assert m["total_device_ms"] == pytest.approx(sum(m["device_ms"].values()) + 0.125 + 0.75)
    assert m["self_device_ms"]["refine.backward"] == pytest.approx(6.0)
    assert m["self_device_ms"]["render.blend_bwd"] == pytest.approx(5.0)
    assert m["self_device_ms"][spans.NO_SPAN] == pytest.approx(0.75)
    assert m["by_span"]["render.rasterize"] == [1.0, 1.0]
    assert m["by_span"]["refine.backward"] == [1.0, 1.0]  # the autograd thread's sync and launch
    assert m["by_span"]["render.blend_bwd"] == [0.0, 1.0]
    assert m["by_span"][spans.NO_SPAN] == [0.0, 2.0]
    assert m["pairs_per_render"] == 1500.0
    assert m["lost_kernels"] == 1
    # the window: the step's start to the last device event's end
    assert m["window_s"] == pytest.approx(101.75e-3)
    # each gap goes to the main thread's innermost span at its middle
    assert dict(m["idle_by_span"]) == pytest.approx({
        "refine.geometry": 1e-6 * (2_100 + 100 + 7_400), "render.rasterize": 1e-6 * (1_750 + 6_000 + 7_000),
        "loss.pixel": 11e-3, "refine.backward": 1e-6 * (14_250 + 6_000 + 3_000), "refine.adam": 17e-3,
        spans.NO_SPAN: 1e-6 * (875 + 400)}, abs=1e-12)
    busy = 1e-3 * (1.0 + 0.5 + 0.25 + 2.0 + 3.0 + 4.0 + 0.75 + 5.0 + 6.0 + 1.5 + 0.125 + 0.5 + 0.25)
    assert sum(v for _, v in m["idle_by_span"]) == pytest.approx(m["window_s"] - busy)


def test_a_trace_without_spans_reads_nothing():
    doc = hand_built_trace()
    doc["traceEvents"] = [e for e in doc["traceEvents"] if e.get("cat") != spans.SPAN_CAT]
    assert spans.attribute(doc, steps=1) is None


def _traced(cell, capsys):
    out = harness.run_cell(cell, 2**31 + 9, 0.3, True, device="cpu", config=small_config(CELLS[cell]))
    harness.emit(out)
    stdout = capsys.readouterr().out
    assert json.loads(stdout.strip().splitlines()[-1]) == json.loads(json.dumps(out))
    return out, stdout


def test_traced_cpu_run_reports_the_span_metrics(capsys):
    out, stdout = _traced("refine.sphere160.b1", capsys)
    assert out["correct"] is True
    metrics = {name.split(".")[0]: m for name, m in out["metrics"].items()}  # the cell's split names
    assert SPAN_METRICS <= set(metrics)
    assert all(metrics[k]["value"] > 0 for k in SPAN_METRICS)
    assert metrics["pairs_per_render"]["unit"] == "pairs/render"
    lines = {ln.split(":")[0]: ln for ln in stdout.splitlines() if ln.startswith("# ")}
    for head in ("# spans", "# device ms a step by innermost span", "# syncs and launches by span (a step, [syncs, kernels])",
                 "# idle by span (s of the "):
        assert any(k.startswith(head) for k in lines), head
    idle = next(ln for ln in stdout.splitlines() if ln.startswith("# idle by span"))
    assert "refine.backward" in idle and "loss.pixel" in idle


def test_a_program_without_the_recorder_reads_no_span_metric(capsys, monkeypatch):
    from gaustar_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recording")
    out, stdout = _traced("refine.body160.b4", capsys)
    assert out["correct"] is True
    assert not SPAN_METRICS & set(out["metrics"])
    assert "kernel_launches_per_iter" in out["metrics"]
    assert "# spans" not in stdout
