"""Port parity: the staged BERT encoder (``xpretrain_tpu_torch/models/bert.py``)
against the flax modules of ``xpretrain_tpu/models/bert.py``, loaded from the
same params through ``load_jax_params``. fp32 on the CPU."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from xpretrain_tpu.models import bert as jbert  # noqa: E402
from xpretrain_tpu_torch.models import bert  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params  # noqa: E402

ATOL = 2e-5
B, S = 3, 12
TINY = dict(hidden_size=32, num_hidden_layers=5, num_attention_heads=4, intermediate_size=48,
            vocab_size=100, type_vocab_size=4, stage_bounds=(2, 4))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 100, size=(B, S))
    mask = (np.arange(S)[None] < np.array([[S], [7], [3]])).astype(np.int64)
    types = rng.integers(0, 4, size=(B, S))
    return ids, mask, types


@pytest.fixture(scope="module", params=[0, 4], ids=["dense", "window4"])
def pair(request):
    """(flax model, noisy params, port model): the whole tiny encoder with its
    pooler, built once per attention layout."""
    kw = dict(TINY, attention_window=request.param)
    flax_model = jbert.StagedBertModel(jbert.BertConfig(**kw), with_pooler=True)
    ids, mask, types = _inputs()
    params = jax.jit(lambda key: flax_model.init(
        key, ids, mask, types, method=lambda m, *a: m.pool(m(*a))))(jax.random.PRNGKey(0))["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32), params
    )
    port = bert.StagedBertModel(bert.BertConfig(**kw), with_pooler=True)
    load_jax_params(port, {"params": params})
    return flax_model, params, port.eval()


@pytest.mark.parametrize("stage", [0, 1, 2, None])
def test_staged_forward_matches(pair, stage):
    """Each stage alone (from the embeddings), and all layers, with padding."""
    flax_model, params, port = pair
    ids, mask, types = _inputs(2)
    want = flax_model.apply({"params": params}, ids, mask, types, stage=stage)
    with torch.no_grad():
        got = port(torch.from_numpy(ids), torch.from_numpy(mask), torch.from_numpy(types), stage=stage)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_inputs_embeds_and_pooler_match(pair):
    """Stage 1 over already-embedded sequences (LF-VILA's paragraph stage),
    then the pooler."""
    flax_model, params, port = pair
    _, mask, _ = _inputs(3)
    embeds = np.random.default_rng(4).normal(size=(B, S, TINY["hidden_size"])).astype(np.float32)
    want_hidden, want_pooled = flax_model.apply(
        {"params": params}, embeds, mask,
        method=lambda m, e, a: (lambda h: (h, m.pool(h)))(m(inputs_embeds=e, attention_mask=a, stage=1)),
    )
    with torch.no_grad():
        hidden = port(inputs_embeds=torch.from_numpy(embeds), attention_mask=torch.from_numpy(mask), stage=1)
        pooled = port.pool(hidden)
    np.testing.assert_allclose(hidden.numpy(), np.asarray(want_hidden), atol=ATOL, rtol=0)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(want_pooled), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seq_len,window", [(12, 4), (13, 4), (70, 16), (5, 8)])
def test_block_local_mask_matches(seq_len, window):
    np.testing.assert_array_equal(bert._block_local_mask(seq_len, window).numpy(),
                                  np.asarray(jbert._block_local_mask(seq_len, window)))


def test_configs_and_stage_ranges_match():
    for name in ("bert_base", "bert_large"):
        got = dataclasses.asdict(getattr(bert.BertConfig, name)(stage_bounds=(8, 12)))
        assert got == dataclasses.asdict(getattr(jbert.BertConfig, name)(stage_bounds=(8, 12)))
    large = bert.BertConfig.bert_large(stage_bounds=(8, 12))
    assert [large.stage_range(s) for s in range(3)] == [(0, 8), (8, 12), (12, 24)]


def test_partial_build_and_pooler_guard():
    """A model built up to stage 1 runs stages 0 and 1 and refuses stage 2;
    one built without its pooler refuses ``pool``."""
    port = bert.StagedBertModel(bert.BertConfig(**TINY), num_layers=4).eval()
    assert [n for n, _ in port.encoder.named_children()] == [f"layer_{i}" for i in range(4)]
    ids, mask, _ = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        port(ids, mask, stage=1)
        with pytest.raises(ValueError, match="only the first 4"):
            port(ids, mask, stage=2)
        with pytest.raises(ValueError, match="pooler"):
            port.pool(port(ids, mask, stage=0))


def test_dropout_draws_from_its_generator_in_training_only():
    port = bert.StagedBertModel(bert.BertConfig(**TINY))
    ids, mask, _ = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        port.eval()
        a, b = port(ids, mask), port(ids, mask)
        torch.testing.assert_close(a, b, atol=0, rtol=0)
        port.train()
        c = port(ids, mask, generator=torch.Generator().manual_seed(0))
        d = port(ids, mask, generator=torch.Generator().manual_seed(0))
        e = port(ids, mask, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(c, d, atol=0, rtol=0)
    assert (c - a).abs().max() > 1e-3 and (c - e).abs().max() > 1e-3
