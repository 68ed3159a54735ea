"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference computes from the same
inputs and weights, each compared with a limit of its own from the cell's
file. ``details`` gives what the limits were chosen from: the leaves and
rows behind each number."""

from __future__ import annotations

import statistics

import numpy as np

# a leaf whose reference gradient is under this share of the median leaf's
# is nought to rounding (a key's bias under softmax): Adam moves it by
# round-off alone, so its change is not compared
STILL_LEAF = 1e-3


def _gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def leaf_gaps(prog: dict, ref: dict) -> tuple[dict, dict]:
    """Per leaf: the gap of the first gradient's norms over the larger of
    that leaf's reference norm and the median leaf's; and, over the leaves
    the reference's gradient moves, the same for the norm of the change."""
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = {n: _gap(prog["grad_norms"][n], g, g_med) for n, g in g_ref.items()}
    moving = [n for n, g in g_ref.items() if g >= STILL_LEAF * g_med]
    c_med = statistics.median(ref["change_norms"][n] for n in moving)
    change = {n: _gap(prog["change_norms"][n], ref["change_norms"][n], c_med) for n in moving}
    return grad, change


def element_gaps(prog: dict, ref: dict) -> dict[str, float]:
    """Per leaf: the norm of the first gradient's difference, element by
    element, over the larger of that leaf's reference norm and the median
    leaf's (where both sides kept the whole gradient, ``grads``)."""
    import torch

    g_med = statistics.median(ref["grad_norms"].values())
    return {n: float(torch.linalg.vector_norm(prog["grads"][n].float() - g.float())) / max(ref["grad_norms"][n], g_med)
            for n, g in ref["grads"].items()}


def train_numbers(prog: dict, ref: dict) -> dict[str, float]:
    """``loss_gap``: the worst of the first steps' relative loss gaps;
    ``grad_gap`` and ``change_gap``: the worst leaf's (:func:`leaf_gaps`);
    ``grad_gap_median``: the median leaf's gradient gap, steadier from seed
    to seed than the worst leaf's (a different small leaf on nearly every
    seed); where both sides kept the whole first gradient, ``grad_diff``,
    the worst leaf's :func:`element_gaps`: rounding that the norms average
    away shows element by element."""
    grad, change = leaf_gaps(prog, ref)
    out = {"loss_gap": max(_gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"])),
           "grad_gap": max(grad.values()), "change_gap": max(change.values()),
           "grad_gap_median": statistics.median(grad.values())}
    if "grads" in prog and "grads" in ref:
        out["grad_diff"] = max(element_gaps(prog, ref).values())
    return out


def train_details(prog: dict, ref: dict) -> dict:
    grad, change = leaf_gaps(prog, ref)
    worst = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:3]  # noqa: E731
    out = {"loss_gaps": [_gap(p, r, 0.0) for p, r in zip(prog["losses"], ref["losses"])],
           "grad_worst": worst(grad), "change_worst": worst(change), "change_median": statistics.median(change.values()),
           "leaves": len(grad), "moving": len(change)}
    if "grads" in prog and "grads" in ref:
        diff = element_gaps(prog, ref)
        out.update(diff_worst=worst(diff), diff_median=statistics.median(diff.values()))
    return out


def _rows(prog: list[tuple], ref: list[tuple]) -> list[np.ndarray]:
    """Per call, the L2 distance of each served feature row (video, then
    text) from the reference's row for the same input (unit vectors)."""
    return [np.concatenate([np.linalg.norm(p - r, axis=-1) for p, r in zip(pc, rc)]) for pc, rc in zip(prog, ref)]


def feature_numbers(prog: list[tuple], ref: list[tuple]) -> dict[str, float]:
    """``feature_gap``: over the calls, the largest root mean square of a
    call's row distances; one altered answer lifts its call's, and it is
    steadier than the single widest row."""
    return {"feature_gap": max(float(np.sqrt(np.mean(d ** 2))) for d in _rows(prog, ref))}


def feature_details(prog: list[tuple], ref: list[tuple]) -> dict:
    rows = np.concatenate(_rows(prog, ref))
    towers = {}
    for i, name in enumerate(("video", "text")):
        d = np.concatenate([np.linalg.norm(p[i] - r[i], axis=-1) for p, r in zip(prog, ref)])
        towers[f"{name}_rms"], towers[f"{name}_max"] = float(np.sqrt(np.mean(d ** 2))), float(d.max())
    return {"row_max": float(rows.max()), "row_median": float(np.median(rows)),
            "row_rms": float(np.sqrt(np.mean(rows ** 2))), "rows": int(rows.size), **towers}
