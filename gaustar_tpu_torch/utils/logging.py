"""Scalar metrics logging (a copy of gaustar_tpu/utils/logging.py).

The reference logs training scalars to TensorBoard in the vanilla-3DGS trainer
(gaussian_splatting/train.py:170-209: SummaryWriter with add_scalar for loss
components, iter_time, total_points) and to the console every 50 iterations in
the refine trainer (refine.py:159). Here the design is an append-only JSONL
event stream (one tagged scalar dict per step): mergeable across runs,
greppable and convertible; `to_csv` pivots it for spreadsheet/pandas use and
`summarize` reduces it for quick console inspection. No TensorBoard
dependency.
"""

from __future__ import annotations

import json
import math
import os
import time
from collections import defaultdict
from typing import IO, Iterable


class MetricLogger:
    """Append-only JSONL scalar logger.

    Each `log(step, **scalars)` writes one line: {"step": s, "t": unix_time,
    **scalars}. Non-finite values are stored as strings ("nan"/"inf") so the
    stream stays valid JSON and divergence remains visible.
    """

    def __init__(self, path: str, *, run_meta: dict | None = None, flush_every: int = 1):
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = path
        self._f: IO[str] = open(path, "a")
        self._n = 0
        self.flush_every = max(1, flush_every)
        # Every logger instance opens a new run: appending a re-run of the same
        # frame into an existing file would otherwise interleave duplicate steps
        # indistinguishably. to_csv/summarize read only the LATEST run by
        # default (split on run_meta events).
        self._write({"event": "run_meta", "t": time.time(), **(run_meta or {})})

    def _write(self, obj: dict):
        self._f.write(json.dumps(obj) + "\n")
        self._n += 1
        if self._n % self.flush_every == 0:
            self._f.flush()

    @staticmethod
    def _scalar(v):
        try:
            f = float(v)
        except (TypeError, ValueError):
            return str(v)
        if math.isnan(f):
            return "nan"
        if math.isinf(f):
            return "inf" if f > 0 else "-inf"
        return f

    def log(self, step: int, **scalars):
        self._write(
            {"step": int(step), "t": time.time(), **{k: self._scalar(v) for k, v in scalars.items()}}
        )

    def as_log_fn(self):
        """Adapter for refine_frame/run_sequence's `log_fn(entry_dict)` hook."""

        def fn(entry: dict):
            step = int(entry.get("iteration", entry.get("step", 0)))
            self.log(step, **{k: v for k, v in entry.items() if k not in ("iteration", "step")})

        return fn

    def close(self):
        self._f.flush()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_events(path: str, latest_run_only: bool = False) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    if latest_run_only:
        last_meta = None
        for i, e in enumerate(out):
            if e.get("event") == "run_meta":
                last_meta = i
        if last_meta is not None:
            out = out[last_meta:]
    return out


def _is_num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def to_csv(
    path: str, csv_path: str, tags: Iterable[str] | None = None, latest_run_only: bool = True
) -> list[str]:
    """Pivot the JSONL stream into a step-indexed CSV. Returns the column order.

    By default only the LATEST run (events after the last run_meta) is used, so
    re-running a frame into the same directory doesn't silently merge runs."""
    events = [e for e in read_events(path, latest_run_only=latest_run_only) if "step" in e]
    if tags is None:
        keys: set[str] = set()
        for e in events:
            keys |= {k for k, v in e.items() if k not in ("step", "t") and _is_num(v)}
        tags = sorted(keys)
    tags = list(tags)
    with open(csv_path, "w") as f:
        f.write(",".join(["step"] + tags) + "\n")
        for e in events:
            row = [str(e["step"])] + ["" if not _is_num(e.get(t)) else repr(e[t]) for t in tags]
            f.write(",".join(row) + "\n")
    return tags


def summarize(path: str, latest_run_only: bool = True) -> dict[str, dict]:
    """Per-tag {count, first, last, min, max} over the LATEST run (console TLDR)."""
    stats: dict[str, dict] = defaultdict(lambda: {"count": 0})
    for e in read_events(path, latest_run_only=latest_run_only):
        if "step" not in e:
            continue
        for k, v in e.items():
            if k in ("step", "t") or not _is_num(v):
                continue
            s = stats[k]
            if s["count"] == 0:
                s.update(first=v, min=v, max=v)
            s["count"] += 1
            s["last"] = v
            s["min"] = min(s["min"], v)
            s["max"] = max(s["max"], v)
    return dict(stats)
