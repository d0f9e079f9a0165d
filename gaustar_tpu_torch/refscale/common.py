"""What the reference-scale entry points share: timing with the card
synchronised, detection's pair demand, and where and how a record is
written."""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

from gaustar_tpu_torch.utils.general import cpu_model

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def clocked(dev: torch.device, fn):
    """(fn(), its wall seconds), the card synchronised on both ends."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def build_libraries(dev: torch.device) -> float:
    """Build what a frame's stages load at first use, so that no timed
    stage holds a compiler: the native mesh library (g++; fusion decimates
    with it) and, on a card, the refine step's kernels (nvcc). Returns the wall
    seconds (about 0 when both are built already)."""
    from gaustar_tpu_torch import native
    from gaustar_tpu_torch.ops import _build

    t0 = time.perf_counter()
    native.build()
    if dev.type == "cuda":
        _build.build(_build.STEP_KERNELS)
    return time.perf_counter() - t0


def default_out(name: str) -> str:
    """build/refscale/<name>.json in the repository's checkout."""
    return os.path.join(REPO_ROOT, "build", "refscale", f"{name}.json")


def device_record(dev: torch.device) -> dict:
    """The device a record was taken on: the card's name and, from
    nvidia-smi, its name and power limit; and the host's CPU model, since
    a host-bound step's time moves with the host."""
    if dev.type != "cuda":
        return {"device": str(dev), "host_cpu": cpu_model()}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi[dev.index or 0], "host_cpu": cpu_model()}


def write_report(path: str, report: dict):
    """Write the record as JSON and print its path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"record: {path}", flush=True)


def pair_demand(decisions: list[dict]) -> list[dict]:
    """Per mid-refine detection in a run's log entries: its two renders'
    largest pair demand over the cameras, and the refine's largest demand of
    one render before it (from the unbind decision that follows the
    detection's telemetry)."""
    out = []
    for tel, dec in zip(decisions, decisions[1:]):
        if "detect/max_pairs" in tel and "unbind_changed" in dec:
            out.append({"iteration": dec["iteration"], "detect_max_pairs": tel["detect/max_pairs"],
                        "detect_max_pairs_solid": tel["detect/max_pairs_solid"],
                        "refine_max_pairs": dec["refine_max_pairs"],
                        "solid_over_refine": tel["detect/max_pairs_solid"] / max(dec["refine_max_pairs"], 1)})
    return out
