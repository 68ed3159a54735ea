"""Retrieval metrics (numpy, host-side; the port's copy of
``xpretrain_tpu/utils/metrics.py``).

Capability parity with the reference's metrics modules
(``CLIP-ViP/src/utils/metrics.py:3-69``, ``LF-VILA/src/utils/metrics.py:4-18``):
rank-of-the-diagonal retrieval metrics (R@1/5/10/50, MedR, MeanR), a
multi-positive variant, and the dual-softmax (DSL) similarity renormalization
used at eval time. All pure numpy so results are bit-stable across backends.
"""

from __future__ import annotations

import numpy as np



def cosine_sim(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain dot-product similarity; inputs are expected pre-normalized."""
    return a @ b.T


def np_softmax(x: np.ndarray, axis: int = 0, temperature: float = 1.0) -> np.ndarray:
    z = x * temperature
    z = z - z.max(axis=axis, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=axis, keepdims=True)


def dsl_renormalize(sim: np.ndarray, temperature: float = 100.0) -> np.ndarray:
    """Dual-softmax (DSL) rescoring: sim * softmax over the gallery axis.

    Matches the eval-time trick at
    ``CLIP-ViP/src/tasks/run_video_retrieval.py:157-171``:
    ``sim * softmax(sim * 100, axis=0)``.
    """
    return sim * np_softmax(sim, axis=0, temperature=temperature)


def compute_metrics(sim: np.ndarray) -> dict[str, float]:
    """Retrieval metrics for a query-by-gallery similarity matrix.

    Positive pair for row i is column i (the diagonal). Rank is the number of
    gallery items scoring strictly higher than the positive (0-indexed), with
    the reference's argsort tie-handling reproduced via the sorted-index trick.
    """
    if sim.ndim != 2 or sim.shape[0] != sim.shape[1]:
        # Rectangular matrices still have diagonal positives for the first
        # min(n, m) queries; restrict to the square block.
        n = min(sim.shape)
        sim = sim[:n, :n]
    order = np.argsort(-sim, axis=1)
    # position of the diagonal element in each row's descending order
    ranks = np.argwhere(order == np.arange(sim.shape[0])[:, None])[:, 1].astype(np.float64)
    metrics = {
        "R1": float(100.0 * np.mean(ranks < 1)),
        "R5": float(100.0 * np.mean(ranks < 5)),
        "R10": float(100.0 * np.mean(ranks < 10)),
        "R50": float(100.0 * np.mean(ranks < 50)),
        "MedR": float(np.median(ranks) + 1),
        "MeanR": float(np.mean(ranks) + 1),
    }
    return metrics



def retrieval_report(t2v_sim: np.ndarray, with_dsl: bool = True) -> dict[str, dict[str, float]]:
    """Both directions + optional DSL, the standard eval block."""
    report = {
        "t2v": compute_metrics(t2v_sim),
        "v2t": compute_metrics(t2v_sim.T),
    }
    if with_dsl:
        report["t2v_dsl"] = compute_metrics(dsl_renormalize(t2v_sim))
        report["v2t_dsl"] = compute_metrics(dsl_renormalize(t2v_sim.T))
    return report


def compute_metrics_multi(sim: np.ndarray, positive_mask: np.ndarray) -> dict[str, float]:
    """Multi-positive retrieval metrics.

    ``positive_mask[i, j] = 1`` marks gallery item j as a correct match for
    query i (e.g. MSR-VTT full-split has 20 captions per video). The rank of a
    query is the best rank among its positives.
    """
    assert sim.shape == positive_mask.shape
    order = np.argsort(-sim, axis=1)
    pos_sorted = np.take_along_axis(positive_mask.astype(bool), order, axis=1)
    # first True position per row
    ranks = np.argmax(pos_sorted, axis=1).astype(np.float64)
    has_pos = pos_sorted.any(axis=1)
    ranks = ranks[has_pos]
    return {
        "R1": float(100.0 * np.mean(ranks < 1)),
        "R5": float(100.0 * np.mean(ranks < 5)),
        "R10": float(100.0 * np.mean(ranks < 10)),
        "R50": float(100.0 * np.mean(ranks < 50)),
        "MedR": float(np.median(ranks) + 1),
        "MeanR": float(np.mean(ranks) + 1),
    }


def retrieval_report(t2v_sim: np.ndarray, with_dsl: bool = True) -> dict[str, dict[str, float]]:
    """Both directions + optional DSL, the standard eval block."""
    report = {
        "t2v": compute_metrics(t2v_sim),
        "v2t": compute_metrics(t2v_sim.T),
    }
    if with_dsl:
        report["t2v_dsl"] = compute_metrics(dsl_renormalize(t2v_sim))
        report["v2t_dsl"] = compute_metrics(dsl_renormalize(t2v_sim.T))
    return report
