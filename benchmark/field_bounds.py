"""The yardstick of the hash encoding's roofline: the operations and bytes
the encoding of the traced steps' points needs, counted by the benchmark's
own indexing (benchmark/reference/field_step.py) from the arguments of each
captured hash_encode call, over the device time of the field.encode span.

Bytes: at each level the distinct table rows the call's points touch, each
read once (F floats of 4 bytes), plus each point's 3 coordinates (12 bytes).
The features written are not counted, so that a kernel which fuses the
encoding with the MLP still reads at most 100%. Operations: a point and
level, 8 corners x (2 weight multiplies + F multiply-adds).
"""

from __future__ import annotations

import torch

from benchmark import bounds, field_spans
from benchmark.reference.field_step import corner_rows, level_resolutions

# The program function whose arguments are one encoding: (tables [L, T, F],
# pts01 [N, 3], the field's configuration).
ENCODE_CAPTURE = ("gaustar_tpu_torch.models.neural_field", "hash_encode")


def distinct_rows(pts01: torch.Tensor, res: int, table_size: int, dense: bool) -> int:
    """The distinct table rows the points' cell corners read at one level."""
    return int(torch.unique(corner_rows(pts01, res, table_size, dense)[0]).numel())


@torch.no_grad()
def encode_counts(tables_shape, pts01: torch.Tensor, cfg) -> dict:
    """{"ops", "bytes", "rows": [distinct rows a level]} of one encoding of
    pts01 [N, 3] into tables of shape [L, T, F] at the configuration `cfg`
    (n_levels, base_res, max_res, table_size; dense_coarse where it has it)."""
    n_levels, table_size, n_feat = (int(x) for x in tables_shape)
    res = level_resolutions(n_levels, cfg.base_res, cfg.max_res)
    dense = [getattr(cfg, "dense_coarse", False) and (r + 1) ** 3 <= table_size for r in res]
    rows = [distinct_rows(pts01, r, table_size, d) for r, d in zip(res, dense)]
    n = pts01.shape[0]
    return {"ops": n * n_levels * 8 * (2 + 2 * n_feat), "bytes": 4 * n_feat * sum(rows) + 12 * n, "rows": rows}


def encode_calls(trace) -> list:
    """encode_counts of every hash_encode call the traced window captured
    (memoized on the trace)."""
    if "encode_counts" not in trace.memo:
        trace.memo["encode_counts"] = [encode_counts(args[0].shape, args[1], args[2])
                                       for args, _ in trace.captures.get(ENCODE_CAPTURE, [])]
    return trace.memo["encode_counts"]


def roofline(run) -> float | None:
    """The encoding's share of its roofline: the traced steps' summed bound
    time a step over field.encode's device time a step; None where nothing
    was read (no encoding captured, no span, a card with no peak)."""
    peak = bounds.PEAKS.get(run.device_kind)
    calls = encode_calls(run.trace)
    if peak is None or not calls:
        return None
    encode_ms = field_spans.device_ms(run, "field_encode_device_ms")
    if not encode_ms:
        return None
    bound_s = sum(bounds.bound_s(c["ops"], c["bytes"], peak) for c in calls) / run.trace.steps
    return 100.0 * bound_s / (1e-3 * encode_ms)
