"""The model-FLOP counts of ``work/`` against ``torch.utils.flop_counter``
on the plain reference at a small size: the GEMMs exactly; the attention by
its pattern, counted entry by entry (the counter sees a dense product
where a pattern applies)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference import clipvip_b32 as clip_ref
from benchmark.reference import lfvila_stage1 as lf_ref
from benchmark.reference.plain import Precision
from benchmark.tests import tiny
from benchmark.traffic.batches import pool
from benchmark.weights import make_weights
from benchmark.work import clipvip_b32 as clip_work
from benchmark.work import lfvila_stage1 as lf_work


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def test_clipvip_gemms_match_the_flop_counter():
    wl, cfg = tiny.clipvip("clipvip_b32.train_graphed")
    B = wl["params"]["batch"]
    batch = {k: torch.from_numpy(v) for k, v in pool(wl["params"], 5, "cpu")[0].items()}
    p = make_weights(clip_ref.leaves(cfg), 5, "cpu")

    def forward():
        v, t = clip_ref.features(p, cfg, batch, Precision())
        return v @ t.T

    total = _counted(forward)
    M, N, L, S, D, _ = clip_work.vision_shapes(cfg)
    seq = wl["params"]["seq"]
    dense_attention = (4 * B * S * S * D * cfg["vision"]["num_hidden_layers"]
                       + 4 * B * seq * seq * cfg["text"]["hidden_size"] * cfg["text"]["num_hidden_layers"])
    assert total - dense_attention == clip_work.forward_flops(cfg, B, seq)["gemm"]


def test_clipvip_attention_counts_its_pattern():
    wl, cfg = tiny.clipvip("clipvip_b32.train_graphed")
    M, N, L, S, _, _ = clip_work.vision_shapes(cfg)
    assert int(clip_ref.proxy_allowed(M, N, L, "cpu").sum()) == clip_work.proxy_scores(cfg)
    seq = wl["params"]["seq"]
    assert int(torch.ones(seq, seq).tril().sum()) == clip_work.text_scores(cfg, seq)
    full = tiny.load("configs", "clipvip_b32")
    assert clip_work.proxy_scores(full) == 4 * 592 + 12 * 49 * 53  # the B/32 pattern: 588 patches over 53 keys


def test_lfvila_counts_match_the_flop_counter():
    """Swin3D attends window by window and BERT over every position, so the
    counter's products are the patterns' too: the whole forward agrees."""
    wl, cfg = tiny.lfvila("lfvila_stage1.index")
    params = wl["params"]
    batch = {k: torch.from_numpy(v) for k, v in pool(params, 5, "cpu")[0].items()}
    p = make_weights(lf_ref.leaves(cfg, "serve"), 5, "cpu")
    total = _counted(lambda: lf_ref.features(p, cfg, batch, Precision()))
    parts = lf_work.forward_flops(cfg, "serve", params["batch"], params["sentences"], params["seq"])
    assert total == parts["gemm"] + parts["attention"]


def test_lfvila_window_pattern_is_one_window_of_clipped_tokens():
    cfg = tiny.load("configs", "lfvila_stage1")
    stages = lf_work.swin_stages(cfg)
    assert [s["window"] for s in stages] == [(2, 3, 5), (4, 3, 5), (8, 3, 5), (16, 3, 5), (16, 3, 5), (32, 3, 5)]
    assert [s["dims"] for s in stages][-1] == (32, 3, 5)
    assert len(lf_work.op_bounds(cfg, "serve", 8)["xpt::window_attention_fwd"]) == 6
    assert lf_work.op_bounds(cfg, "train", 16) == {}
