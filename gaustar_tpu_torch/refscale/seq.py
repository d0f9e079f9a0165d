"""Two reference-scale frames through run_sequence (counterpart of
examples/refscale_seq.py).

    python -m gaustar_tpu_torch.refscale.seq [--iters 2000] [--cams 40] [--out PATH]

scenes.write_sequence_dataset writes the two-frame dataset in the
reference's layout to a temporary directory (the 100,000-face sphere, 40
ring cameras at 1600x1024, analytic depth, JPEG frames through the port's
codec; frame 1 grows an 8 cm dent), then the port's run_sequence drives
it: frame-0 refine, the flow warp to frame 1, frame-1 refine with detection
at half, the topology event where the model loose-bound (fusion decimated to
150,000 faces, detection, surgery, the half-budget re-refine), the exports.
Each call of run_sequence's stage entry points (refine_frame,
extract_mesh_fusion, update_mesh_with_fusion, detect_topo_err,
warp_mesh_using_flow) is timed with the card synchronised; each frame's
own stage seconds come from run_sequence. The record, with each
detection's telemetry and unbind decision, whether each frame updated and
wrote its checkpoint and the GT bytes resident on the card, goes to
build/refscale/seq.json (`--out`), with each mid-refine detection's pair
demand beside the refine's (common.pair_demand).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import tempfile

import torch

from gaustar_tpu_torch.refscale import common, scenes
from gaustar_tpu_torch.tools import warp_mesh
from gaustar_tpu_torch.train import mesh_update, refine, sequence, topo_detect
from gaustar_tpu_torch.utils.general import resolve_device
from gaustar_tpu_torch.utils.synthetic import REF_H, REF_W

STAGES = ((refine, "refine_frame"), (mesh_update, "extract_mesh_fusion"), (mesh_update, "update_mesh_with_fusion"),
          (topo_detect, "detect_topo_err"), (warp_mesh, "warp_mesh_using_flow"))


@contextlib.contextmanager
def timed_stages(dev: torch.device, stages: list):
    """Within the block, every call of a STAGES entry point appends
    {"stage", "wall_s"} to `stages` (the card synchronised on both ends),
    a fusion also its "views" (renders); the entry points are restored on
    exit."""
    originals = [(mod, name, getattr(mod, name)) for mod, name in STAGES]

    def timed(name, fn):
        def call(*args, **kwargs):
            out, wall = common.clocked(dev, lambda: fn(*args, **kwargs))
            stages.append({"stage": name, "wall_s": wall})
            if name == "extract_mesh_fusion":
                stages[-1]["views"] = mesh_update.last_fusion["views"] * mesh_update.last_fusion["blocks"]
            return out
        return call

    for mod, name, fn in originals:
        setattr(mod, name, timed(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in originals:
            setattr(mod, name, fn)


def run(root: str, iters: int, n_cams: int, device="cuda", log=print) -> dict:
    """The two frames under `root` (data/ and work/), with the reference's
    settings (refscale_seq.py:159-165). Returns the record."""
    dev = resolve_device(device)
    data_root, work_root = os.path.join(root, "data"), os.path.join(root, "work")
    w, h = REF_W, REF_H
    n_faces, build_s = common.clocked(dev, lambda: scenes.write_sequence_dataset(data_root, n_cams, device=dev))
    log(f"dataset: 2 frames x {n_cams} cameras at {w}x{h}, {n_faces} faces, written in {build_s:.1f} s")
    seq = sequence.SequenceConfig(
        data_root=data_root, work_root=work_root, frame_0=0, frame_end=2, refinement_iterations=iters,
        sh_reg=True, force_watertight=False, fusion_simplify_face_num=150_000)
    stages = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    decisions = []  # each detection's telemetry and each unbind decision

    def on_log(entry):
        if "unbind_changed" in entry or "detect/flagged_faces" in entry:
            decisions.append(entry)

    with timed_stages(dev, stages):
        (_, _, frames), wall = common.clocked(dev, lambda: sequence.run_sequence(seq, device=dev, log_fn=on_log))
    for s in stages:
        log(f"[stage] {s['stage']}: {s['wall_s']:.2f} s")
    report = {"n_faces_init": n_faces, "n_cams": n_cams, "resolution": [w, h], "iterations": iters, "frames": 2,
              "dataset_build_s": build_s, "stages": stages, "sequence_wall_s": wall,
              "frame_seconds": [f["seconds"] for f in frames], "cc_update_num": [f["cc_update_num"] for f in frames],
              "warp": [f["warp"] for f in frames], "detection_and_unbind": decisions,
              "pair_demand": common.pair_demand(decisions),
              # GT images (RGB) and depths in float32, as FrameData holds them on the card.
              "gt_resident_bytes": n_cams * w * h * (3 + 1) * 4}
    for fi in range(2):
        fdir = os.path.join(work_root, f"{fi:04d}")
        report[f"frame{fi}_updated"] = os.path.exists(os.path.join(fdir, "updated_mesh.obj"))
        report[f"frame{fi}_ckpt"] = os.path.exists(os.path.join(fdir, f"{iters}.npz"))
    if dev.type == "cuda":
        report["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=2000, help="refine iterations a frame")
    ap.add_argument("--cams", type=int, default=40)
    ap.add_argument("--out", default=common.default_out("seq"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory(prefix="gaustar_refseq_") as root:
        report = run(root, args.iters, args.cams, device=dev)
    common.write_report(args.out, {**report, **common.device_record(dev)})


if __name__ == "__main__":
    main()
