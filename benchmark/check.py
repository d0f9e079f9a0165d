"""The comparison that decides `correct`: the program's first steps against
the plain reference's, on the same inputs and cameras.

Three numbers, each against the limit in benchmark/limits/<cell>.json:

  loss_gap    |loss_p - loss_r| / |loss_r| of the first step (the later
              steps' losses are logged, not compared: after the first step
              the area isometry term, an L1 of areas that start at their
              reference, takes the sign of round-off, and sound runs read
              gaps of 1e-6 to 1.4e-4 there from seed to seed);
  grad_gap    over the parameter groups (leaves), the largest gap between the
              norm of the first step's gradient as the program's optimizer
              got it (Adam's first moment after one step over 1 - beta1) and
              the reference's, over the larger of the reference's norm of
              that leaf and of the median leaf;
  change_gap  the same of the norm of each leaf's change over the check
              steps, over the leaves whose reference gradient is at least a
              thousandth of the median leaf's (a leaf the step never reads,
              such as the loose-bind deltas before loose binding, moves by
              round-off alone).
"""

from __future__ import annotations

import statistics

import torch

B1 = 0.9  # Adam's beta1: the first moment after one step is (1 - B1) g
MOVED = 1e-3  # a leaf moves if its reference gradient is this share of the median leaf's


def norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def change_norms(after: dict, before: dict) -> dict:
    return {k: float(torch.linalg.vector_norm((after[k].detach() - before[k]).double())) for k in before}


def worst_leaf(prog: dict, ref: dict, leaves) -> float:
    """max over `leaves` of |prog - ref| / max(ref, median of ref over `leaves`)."""
    med = statistics.median(ref[k] for k in leaves)
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300) for k in leaves), default=0.0)


def gaps(prog: dict, ref: dict) -> dict:
    """The three numbers from readings {"losses": [...], "grad": {leaf: norm},
    "change": {leaf: norm}} of the program and of the reference."""
    loss = abs(prog["losses"][0] - ref["losses"][0]) / max(abs(ref["losses"][0]), 1e-300)
    leaves = sorted(ref["grad"])
    med = statistics.median(ref["grad"][k] for k in leaves)
    moved = [k for k in leaves if ref["grad"][k] >= MOVED * med]
    return {
        "loss_gap": loss,
        "grad_gap": worst_leaf(prog["grad"], ref["grad"], leaves),
        "change_gap": worst_leaf(prog["change"], ref["change"], moved),
        "unmoved_leaves": [k for k in leaves if k not in moved],
    }


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): correct where every number is
    finite and within its limit."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in ("loss_gap", "grad_gap", "change_gap")}
    ok = all(c["value"] == c["value"] and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def program_readings(program, schedule_steps) -> dict:
    """Drive the program through the check steps (the window's own call and
    cameras): every loss, the first gradient's norms from Adam's state after
    step one, and each leaf's change over the steps."""
    before = {k: v.detach().clone() for k, v in program.leaves().items()}
    losses, grad = [], None
    for i, cams in enumerate(schedule_steps):
        losses.append(float(program.step(cams, i + 1)))
        if i == 0:
            grad = {k: v / (1.0 - B1) for k, v in norms(program.first_moments()).items()}
    change = change_norms(program.leaves(), before)
    return {"losses": losses, "grad": grad, "change": change}


def reference_readings(reference, schedule_steps) -> dict:
    """The same readings of the plain reference."""
    before = {k: v.detach().clone() for k, v in reference.leaves.items()}
    losses, grad = [], None
    for i, cams in enumerate(schedule_steps):
        loss, grads = reference.step(cams)
        losses.append(loss)
        if i == 0:
            grad = norms(grads)
    return {"losses": losses, "grad": grad, "change": change_norms(reference.leaves, before)}
