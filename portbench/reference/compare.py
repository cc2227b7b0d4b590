"""The numbers that decide `correct`, and their limits.

Training: each step's loss as a relative gap; the first gradient and the
parameters' change after the compared steps by the worst leaf, as the gap
between the program's norm and the reference's, over the reference's norm
of that leaf or of the median leaf, whichever is larger. Leaves whose
reference gradient is under a thousandth of the median leaf's move under
Adam by round-off alone and are left out of the change.

Serving: the largest absolute gap between a served rating and the
reference's, over the sample.

limits/<cell>.json holds each number's limit for one cell, with the
readings it was set from (PERF.md).
"""

from __future__ import annotations

import json
import os
import statistics

LIMITS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "limits")
TINY_GRADIENT = 1e-3     # share of the median leaf's gradient norm


def limits(cell: str) -> dict:
    with open(os.path.join(LIMITS, f"{cell}.json")) as f:
        return {k: v["limit"] for k, v in json.load(f).items()}


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(prog: dict, ref: dict, names=None) -> float:
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf ‖ref‖)."""
    pn, rn = _norms(prog), _norms(ref)
    names = list(rn) if names is None else list(names)
    med = statistics.median(rn[k] for k in rn)
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


def worst_leaves(prog: dict, ref: dict, ref_first_grad: dict, k: int = 3) -> list:
    """[[name, gap, reference gradient norm / median leaf's]] of the `k`
    leaves with the largest gap (worst_leaf_gap's measure), largest first."""
    pn, rn, gn = _norms(prog), _norms(ref), _norms(ref_first_grad)
    med, gmed = statistics.median(rn.values()), statistics.median(gn.values())
    gaps = sorted(((abs(pn[n] - rn[n]) / max(rn[n], med, 1e-30), n) for n in rn),
                  reverse=True)[:k]
    return [[n, g, gn[n] / max(gmed, 1e-30)] for g, n in gaps]


def moving_leaves(ref_first_grad: dict) -> list:
    rn = _norms(ref_first_grad)
    med = statistics.median(rn.values())
    return [k for k, v in rn.items() if v >= TINY_GRADIENT * med]


def train_numbers(prog_losses, prog_first_grad, prog_change, ref) -> dict:
    """The three compared numbers of a training cell; `ref` a TrainTrace."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30)
                   for a, b in zip(prog_losses, ref.losses))
    return {"loss_gap": loss_gap,
            "grad_gap": worst_leaf_gap(prog_first_grad, ref.first_grad),
            "change_gap": worst_leaf_gap(prog_change, ref.change,
                                         moving_leaves(ref.first_grad))}


def serve_numbers(prog_preds, ref_preds) -> dict:
    import numpy as np
    gap = np.abs(np.asarray(prog_preds, np.float64) - np.asarray(ref_preds, np.float64))
    return {"answer_gap": float(gap.max()) if gap.size else float("inf")}


def judge(numbers: dict, cell: str):
    """(correct, [(name, value, limit)]): every number at or under its limit;
    a number that is not finite fails."""
    lim = limits(cell)
    rows = [(k, v, lim[k]) for k, v in numbers.items()]
    ok = all(v == v and v <= l for _, v, l in rows)
    return ok, rows
