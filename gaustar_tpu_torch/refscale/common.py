"""What the reference-scale entry points share: timing with the card
synchronised, and where and how a record is written."""

from __future__ import annotations

import json
import os
import subprocess
import time

import torch

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


def default_out(name: str) -> str:
    """build/refscale/<name>.json in the repository's checkout."""
    return os.path.join(REPO_ROOT, "build", "refscale", f"{name}.json")


def device_record(dev: torch.device) -> dict:
    """The device a record was taken on: the card's name and, from
    nvidia-smi, its name and power limit."""
    if dev.type != "cuda":
        return {"device": str(dev)}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    return {"device": torch.cuda.get_device_name(dev), "nvidia_smi": smi[dev.index or 0]}


def write_report(path: str, report: dict):
    """Write the record as JSON and print its path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"record: {path}", flush=True)
