"""Retrieval and multiple-choice evaluation (the port's copy of
``xpretrain_tpu/train/evaluate.py``).

Mirrors the reference eval loop (``CLIP-ViP/src/tasks/run_video_retrieval.py:122-203``):
per-batch forward -> cross-rank feature gather -> trim sampler padding ->
similarity matrix -> R@K raw + DSL. In a data-parallel group each rank
forwards its block of every eval batch (``SequentialEvalLoader``) and
:func:`host_rows` gathers the features and ids of every rank in rank order,
which is the global row order, so every rank computes the same report; the
callers write it from rank 0. The metric block is numpy.
"""

from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np

from xpretrain_tpu_torch.parallel.mesh import host_rows, is_main_process
from xpretrain_tpu_torch.utils.logging import LOGGER
from xpretrain_tpu_torch.utils.metrics import retrieval_report


def evaluate_multichoice_by_similarity(
    eval_step: Callable,
    params: Any,
    loader,
    valid_len: int | None = None,
) -> dict[str, float]:
    """MSR-VTT-MC style eval: a retrieval model scores N candidate texts per
    video; prediction = argmax similarity (ref ``hd-vila/src/tasks/
    run_msrvtt_mc.py:145-316``, eval logic ``dataset_video_mc.py:174-194``).

    Batches must carry ``video`` (or the model's visual inputs), text inputs
    shaped [B, n_choice, L] flattened by the caller's collator to
    [B*n_choice, L], plus ``labels`` [B]. In a group the predictions and
    labels of every rank are gathered before the ``valid_len`` trim."""
    correct, total = 0, 0
    for batch in loader:
        labels = np.asarray(batch.pop("labels"))
        out = eval_step(params, batch)
        vis = np.asarray(out["vis_features"], dtype=np.float32)  # [B, D]
        txt = np.asarray(out["text_features"], dtype=np.float32)  # [B*n_choice, D]
        n_choice = txt.shape[0] // vis.shape[0]
        sims = np.einsum(
            "bd,bcd->bc", vis, txt.reshape(vis.shape[0], n_choice, -1)
        )
        pred, labels = host_rows(sims.argmax(-1)), host_rows(labels)
        n = len(labels) if valid_len is None else min(len(labels), valid_len - total)
        correct += int((pred[:n] == labels[:n]).sum())
        total += n
    acc = correct / max(total, 1)
    LOGGER.info("multi-choice accuracy: %.4f (%d samples)", acc, total)
    return {"accuracy": acc, "n": total}


def evaluate_retrieval(
    eval_step: Callable,
    params: Any,
    loader,
    valid_len: int | None = None,
    save_feats_path: str | None = None,
) -> dict[str, dict[str, float]]:
    """Run retrieval eval; ``loader`` yields device-ready batches.

    Returns the metric report plus a ``perf`` block with wall time and
    clips/sec (the reference logs wall-clock at ``run_pretrain.py:186``).
    ``save_feats_path`` dumps the gathered features as .npz (the reference's
    ``save_feat`` option, ``run_video_retrieval.py:233``).
    """
    vis_chunks, text_chunks, id_chunks = [], [], []
    start = time.time()
    n_clips = 0
    for batch in loader:
        out = eval_step(params, batch)
        vis_chunks.append(host_rows(np.asarray(out["vis_features"], dtype=np.float32)))
        text_chunks.append(host_rows(np.asarray(out["text_features"], dtype=np.float32)))
        if "ids" in batch:
            id_chunks.append(host_rows(batch["ids"]))
        n_clips += vis_chunks[-1].shape[0]
    wall = time.time() - start
    vis = np.concatenate(vis_chunks)
    text = np.concatenate(text_chunks)
    ids = np.concatenate(id_chunks) if id_chunks else None
    if valid_len is not None:
        vis, text = vis[:valid_len], text[:valid_len]
        ids = ids[:valid_len] if ids is not None else None
    if save_feats_path is not None and is_main_process():
        extra = {"ids": ids} if ids is not None else {}
        np.savez(save_feats_path, vis_features=vis, text_features=text, **extra)
    sim_t2v = text @ vis.T
    report = retrieval_report(sim_t2v)
    report["perf"] = {"wall_s": wall, "clips_per_s": n_clips / max(wall, 1e-9)}
    LOGGER.info(
        "retrieval eval: t2v R1=%.2f R5=%.2f R10=%.2f (DSL R1=%.2f) | %.1f clips/s",
        report["t2v"]["R1"],
        report["t2v"]["R5"],
        report["t2v"]["R10"],
        report["t2v_dsl"]["R1"],
        report["perf"]["clips_per_s"],
    )
    return report
