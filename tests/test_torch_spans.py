"""The program's spans and counters (utils/profiling): nothing is recorded
while recording is off; spans nest with their parents and steps, on the
main thread and on another (the autograd engine's on a card); the refine
step records each of its layers; the counters, which the blend kernels'
launches are two keys of; the Chrome trace of `profiling.trace` with the
spans in it; and, on a card, the spans and the kernels on one timeline.
JAX is not imported: the card test runs with

    python -m pytest --noconftest -m gpu tests/test_torch_spans.py -q
"""

from __future__ import annotations

import json
import os
import threading

import pytest
import torch

from gaustar_tpu_torch.ops import blend_cuda
from gaustar_tpu_torch.train import refine
from gaustar_tpu_torch.train.optimizer import OptimizationParams, adam_init, make_lr_fn
from gaustar_tpu_torch.utils import profiling
from gaustar_tpu_torch.utils.synthetic import synthetic_frame

LAYER_SPANS = {"refine.step", "refine.geometry", "render.colour", "render.rasterize", "render.preprocess",
               "render.binning", "render.gather", "render.blend_fwd", "loss.pixel", "loss.mesh",
               "refine.backward", "render.blend_bwd", "render.gather_bwd", "loss.pixel_bwd", "refine.adam"}
RASTER_CHILDREN = {"render.preprocess", "render.binning", "render.gather", "render.blend_fwd"}


@profiling.span("decorated")
def _decorated(x, scale=1.0):
    return x * scale


def test_spans_while_off_record_nothing():
    assert profiling.span("a") is profiling.span("a")  # one object a name, no new one a call
    assert profiling.span("refine.step", step=3) is profiling.span("refine.step")
    with profiling.span("a"):
        assert _decorated(2.0, scale=3.0) == 6.0
    outer = profiling.span("before")
    outer.__enter__()  # opened before the recording: its close is not recorded
    with profiling.recording() as rec:
        outer.__exit__(None, None, None)
        with profiling.span("inside"):
            pass
    with profiling.span("after"):
        _decorated(1.0)
    assert [s.name for s in rec.spans] == ["inside"]
    with pytest.raises(RuntimeError, match="already open"):
        with profiling.recording():
            with profiling.recording():
                pass


def test_spans_nest_with_parents_and_steps_on_two_threads():
    def autograd_thread():
        with profiling.span("render.blend_bwd"):
            with profiling.span("inner"):
                pass

    with profiling.recording() as rec:
        with profiling.span("refine.step", step=7):
            with profiling.span("loss.pixel"):
                assert _decorated(2.0) == 2.0
            with profiling.span("refine.backward"):
                t = threading.Thread(target=autograd_thread)
                t.start()
                t.join(timeout=30)
                assert not t.is_alive()
        with profiling.span("between"):
            pass
        with profiling.span("refine.step", step=8):
            with profiling.span("refine.adam"):
                pass
    assert rec.end_ns is not None and rec.main_thread == threading.get_native_id()
    by = {s.name: (i, s) for i, s in enumerate(rec.spans)}
    names = [s.name for s in rec.spans]
    assert names == ["refine.step", "loss.pixel", "decorated", "refine.backward", "render.blend_bwd", "inner",
                     "between", "refine.step", "refine.adam"]
    steps = [s.step for s in rec.spans]
    assert steps == [7, 7, 7, 7, 7, 7, None, 8, 8]
    parents = [s.parent for s in rec.spans]
    assert parents == [-1, 0, 1, 0, -1, 4, -1, -1, 7]
    other = by["render.blend_bwd"][1].thread
    assert other != rec.main_thread and by["inner"][1].thread == other
    assert all(s.thread == rec.main_thread for s in rec.spans if s.name not in ("render.blend_bwd", "inner"))
    for i, s in enumerate(rec.spans):
        assert s.start_ns <= s.end_ns
        if s.parent != -1:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
    bwd = by["refine.backward"][1]
    assert bwd.start_ns <= by["render.blend_bwd"][1].start_ns <= by["render.blend_bwd"][1].end_ns <= bwd.end_ns


@pytest.mark.parametrize("batch", [1, 2])
def test_refine_step_records_each_layer(batch):
    params, config, data, _, rcfg = synthetic_frame(n_cams=2, w=32, h=32, subdiv=1, device="cpu")
    opt = adam_init(params)
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    cfg = refine.RefineConfig(num_iterations=10, loose_bind_from=10**9, do_sh_warmup=False)
    cam = 0 if batch == 1 else [0, 1]
    profiling.reset_counts()
    with profiling.recording() as rec:
        loss, aux = refine.train_step(params, opt, lr_fn, config, data, cam, 5, cfg, rcfg, 2)
    assert torch.isfinite(loss)
    names = [s.name for s in rec.spans]
    assert set(names) == LAYER_SPANS
    assert names.count("refine.step") == 1 and names.count("refine.geometry") == 1  # shared by the batch
    for name in ("render.rasterize", "render.colour", "loss.pixel", "render.blend_fwd", "render.blend_bwd",
                 "render.gather_bwd", "loss.pixel_bwd"):
        assert names.count(name) == batch, name
    assert names.count("loss.mesh") == batch  # once a camera's loss stack
    assert all(s.step == 5 for s in rec.spans)
    for s in rec.spans:
        parent = rec.spans[s.parent].name if s.parent != -1 else None
        if s.name in RASTER_CHILDREN:
            assert parent == "render.rasterize", s
        if s.name in ("render.blend_bwd", "render.gather_bwd", "loss.pixel_bwd"):
            # the CPU's autograd engine runs the backward on the calling thread
            assert parent == "refine.backward" and s.thread == rec.main_thread
    assert rec.counts["renders"] == batch
    assert rec.counts["pairs"] >= aux["num_pairs"] > 0
    assert profiling.counts("pairs", "renders") == {"pairs": rec.counts["pairs"], "renders": batch}
    assert "blend_fwd" not in rec.counts  # the plain blends launch no kernel


def test_counters_hold_the_blend_launches():
    profiling.reset_counts()
    assert profiling.counts("blend_fwd", "blend_bwd") == {"blend_fwd": 0, "blend_bwd": 0}
    profiling.count("blend_fwd")
    profiling.count("blend_fwd")
    with profiling.recording() as rec:
        profiling.count("blend_bwd")
        profiling.count("pairs", 40)
    assert profiling.counts("blend_fwd", "blend_bwd") == {"blend_fwd": 2, "blend_bwd": 1}
    assert profiling.COUNTS["pairs"] == 40
    assert rec.counts == {"blend_bwd": 1, "pairs": 40}
    profiling.reset_counts()
    assert profiling.COUNTS == {}
    # one counter system: the launch sites count into profiling.COUNTS (the
    # card tests read the launches there)
    assert not hasattr(blend_cuda, "LAUNCHES") and not hasattr(blend_cuda, "reset_launch_counts")


def test_trace_writes_the_spans_into_the_chrome_trace(tmp_path):
    x = torch.arange(64.0)
    with profiling.trace(str(tmp_path)) as tr:
        with profiling.span("layer", step=1):
            float(x.sum())
        profiling.count("renders")
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    spans = [e for e in doc["traceEvents"] if e.get("cat") == profiling.SPAN_CAT]
    assert [(e["name"], e["args"]) for e in spans] == [("layer", {"index": 0, "parent": -1, "step": 1})]
    assert doc["programRecord"] == {"main_thread": spans[0]["tid"], "counts": {"renders": 1}}
    assert [s.name for s in tr.record.spans] == ["layer"]
    op = next(e for e in doc["traceEvents"] if e.get("name") == "aten::sum")
    assert op["tid"] == spans[0]["tid"] and op["pid"] == spans[0]["pid"] == os.getpid()
    assert spans[0]["ts"] <= op["ts"] and op["ts"] + op["dur"] <= spans[0]["ts"] + spans[0]["dur"]


def test_span_events_take_the_trace_s_thread_ids():
    """With CUDA activity alone the trace names a host thread by kineto's
    id, the low 32 bits of its pthread id as a signed int with the sign
    dropped; with host operations, by its native id."""
    rec = profiling.Record()
    rec.spans = [profiling.SpanEvent("refine.step", 100, 5_000, 9_000, -1, 1),
                 profiling.SpanEvent("render.blend_bwd", 200, 6_000, 7_000, -1, 1),
                 profiling.SpanEvent("other", 300, 6_500, 6_600, -1, 1)]
    rec.main_thread = 100
    rec.idents = {100: 0x7F00_DF13_C700, 200: 0x7F00_2AC0_0AC0, 300: 0x7F00_0000_1234}
    runtime = [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": t, "ts": 1.0, "dur": 1.0}
               for t in (2**32 - 0xDF13_C700, 0x2AC0_0AC0)]
    events, main = profiling.span_events(rec, {"baseTimeNanoseconds": 1_000, "traceEvents": runtime})
    assert main == 2**32 - 0xDF13_C700
    assert [e["tid"] for e in events] == [main, 0x2AC0_0AC0, 300]  # no runtime call on 300: its native id
    assert [(e["ts"], e["dur"]) for e in events] == [(4.0, 4.0), (5.0, 1.0), (5.5, 0.1)]
    host = [dict(e, tid=n) for e, n in zip(runtime, (100, 200))]
    events, main = profiling.span_events(rec, {"traceEvents": host})
    assert main == 100 and [e["tid"] for e in events] == [100, 200, 300]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the blend kernels and the CUDA trace have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_spans_and_kernels_share_one_timeline_on_the_card(cuda, tmp_path):
    """One refine step traced with CUDA activity alone, as the benchmark
    traces it: every kernel's launch lies inside the refine.step span, each
    blend kernel's inside its blend span (the backward's on the autograd
    engine's thread), and back-to-back spans split a run of launches
    exactly."""
    from gaustar_tpu_torch.ops import _build

    _build.build(["blend_fwd", "blend_bwd"])
    params, config, data, _, rcfg = synthetic_frame(n_cams=2, w=64, h=64, subdiv=2, device="cuda")
    opt = adam_init(params)
    lr_fn = make_lr_fn(OptimizationParams(), 1.0)
    cfg = refine.RefineConfig(num_iterations=10, loose_bind_from=10**9, do_sh_warmup=False)
    refine.train_step(params, opt, lr_fn, config, data, 0, 1, cfg, rcfg, 2)
    x = torch.ones(1 << 20, device=cuda)
    torch.cuda.synchronize()
    with profiling.trace(str(tmp_path), host_ops=False):
        refine.train_step(params, opt, lr_fn, config, data, 1, 2, cfg, rcfg, 2)
        with profiling.span("a"):
            for _ in range(3):
                x.mul_(1.0001)
        with profiling.span("b"):
            for _ in range(2):
                x.add_(1.0)
    with open(tmp_path / "trace.json") as f:
        doc = json.load(f)
    ev = doc["traceEvents"]
    spans = [e for e in ev if e.get("cat") == profiling.SPAN_CAT]
    launch = {e["args"]["correlation"]: e for e in ev
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}
    kernels = [(e, launch[e["args"]["correlation"]]) for e in ev if e.get("cat") == "kernel"]
    main = doc["programRecord"]["main_thread"]

    def holds(span, call):
        return span["tid"] == call["tid"] and span["ts"] <= call["ts"] <= span["ts"] + span["dur"]

    def where(span, call):
        return f"span {span['name']} on {span['tid']} at {span['ts']}+{span['dur']}, launch on {call['tid']} at {call['ts']}"

    def named(name):
        return [s for s in spans if s["name"] == name]

    step = named("refine.step")
    assert len(step) == 1 and step[0]["tid"] == main
    bwd = named("render.blend_bwd")
    assert len(bwd) == 1 and bwd[0]["tid"] != main  # the autograd engine's thread
    seen = {"fwd": 0, "bwd": 0, "a": 0, "b": 0}
    for k, call in kernels:
        if "blend_test_kernel" in k["name"] or "blend_chain_kernel" in k["name"]:
            assert holds(named("render.blend_fwd")[0], call), where(named("render.blend_fwd")[0], call)
            seen["fwd"] += 1
        elif "blend_scan_kernel" in k["name"] or "blend_grad_kernel" in k["name"]:
            assert holds(bwd[0], call), where(bwd[0], call)
            seen["bwd"] += 1
        in_step = call["tid"] == main and holds(step[0], call)
        in_bwd = any(holds(s, call) for s in named("render.blend_bwd") + named("render.gather_bwd"))
        in_ab = [n for n in ("a", "b") if holds(named(n)[0], call)]
        assert in_step or in_bwd or call["tid"] != main or in_ab, k["name"]
        for n in in_ab:
            seen[n] += 1
            assert ("mul" if n == "a" else "add") in k["name"].lower(), (n, k["name"])
    assert seen == {"fwd": 2, "bwd": 2, "a": 3, "b": 2}
