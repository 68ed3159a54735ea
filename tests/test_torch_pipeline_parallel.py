"""Port parity: the GPipe pipeline (``xpretrain_tpu_torch/parallel/pipeline.py``)
against the JAX package's (``tests/test_pipeline_parallel.py``'s tiny BERT),
in one process: the stacked leaves, the ``ValueError``s, and a pipe of one
stage at 1, 2 and 4 microbatches against JAX's pipelined and sequential
encoders from the same weights (converted through the port's BERT table),
fp32 on the CPU at JAX's bars (2e-5 forward, 3e-5 gradients). The pipes of
4 stages, and of 2 with a data axis of 2, run in
``tests/test_torch_seq_pipe_expert.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xpretrain_tpu.models.bert import BertConfig as JaxBertConfig  # noqa: E402
from xpretrain_tpu.models.bert import StagedBertEncoder as JaxEncoder  # noqa: E402
from xpretrain_tpu.models.common import expand_padding_mask as jax_expand  # noqa: E402
from xpretrain_tpu.parallel.mesh import create_mesh  # noqa: E402
from xpretrain_tpu.parallel import pipeline as jpipe  # noqa: E402
from xpretrain_tpu_torch.models.bert import BertConfig, BertLayer, StagedBertEncoder  # noqa: E402
from xpretrain_tpu_torch.models.common import expand_padding_mask  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import LINEAR, key_rules, load_jax_params  # noqa: E402
from xpretrain_tpu_torch.parallel.mesh import DataMesh  # noqa: E402
from xpretrain_tpu_torch.parallel.pipeline import (  # noqa: E402
    make_pipeline,
    pipeline_param_shardings,
    pipelined_bert_encoder,
    stack_layer_params,
    stacked_bert_params_from_flax,
    unstack_layer_params,
)

TINY = dict(vocab_size=500, hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CFG, JCFG = BertConfig(**TINY), JaxBertConfig(**TINY)
L = TINY["num_hidden_layers"]


@pytest.fixture(scope="module")
def setup():
    """JAX's encoder, its params, a batch [8, 10, 32] with a padding mask, a
    regression target, and the port's encoder on the same weights."""
    enc = JaxEncoder(JCFG)
    hidden = np.array(jax.random.normal(jax.random.PRNGKey(1), (8, 10, 32)), np.float32)
    params = jax.jit(lambda key: enc.init(key, hidden, None))(jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    pad = np.ones((8, 10), np.int32)
    pad[:, -3:] = 0
    pad[0, 2:] = 0
    target = np.array(jax.random.normal(jax.random.PRNGKey(3), hidden.shape), np.float32)
    port = load_jax_params(StagedBertEncoder(CFG), params).eval()
    return enc, params, hidden, pad, target, port


def _layer_paths():
    """{stacked leaf name: (flax path within a layer, transform)}."""
    return dict(key_rules(BertLayer(CFG)))


def test_stack_unstack_roundtrip_matches_jax(setup):
    _, params, _, _, _, port = setup
    stacked = stacked_bert_params_from_flax(params, CFG)
    want = jpipe.stack_layer_params(params, L)
    for name, (path, kind) in _layer_paths().items():
        leaf = want
        for p in path:
            leaf = leaf[p]
        leaf = np.asarray(leaf)
        np.testing.assert_array_equal(stacked[name].numpy(), np.swapaxes(leaf, -1, -2) if kind == LINEAR else leaf)
    back = unstack_layer_params(stacked, L)
    state = port.state_dict()
    assert sorted(back) == sorted(state)
    for key, value in state.items():
        assert torch.equal(back[key], value), key
    assert sorted(stack_layer_params(state, L)) == sorted(stacked)


def _pipe_mesh(size: int) -> DataMesh:
    """A mesh object of ``size`` stages, for the checks made before any
    communication."""
    return DataMesh(rank=0, world_size=1, device=torch.device("cpu"), backend="gloo", model_size=size,
                    model_axis="pipe")


def test_indivisible_layers_raise():
    with pytest.raises(ValueError, match="6 layers not divisible by pipe=4"):
        make_pipeline(lambda p, h, m: h, n_layers=6, mesh=_pipe_mesh(4))


def test_indivisible_batch_raises(setup):
    stage = pipeline_param_shardings(stacked_bert_params_from_flax(setup[1], CFG), _pipe_mesh(4))
    assert all(t.shape[0] == 1 for t in stage.values())
    run = pipelined_bert_encoder(CFG, _pipe_mesh(4))
    with pytest.raises(ValueError, match="batch 6 not divisible by microbatches 4"):
        run(stage, torch.zeros(6, 10, CFG.hidden_size), None)


def test_dropout_inside_the_pipeline_raises():
    with pytest.raises(ValueError, match="out of scope"):
        pipelined_bert_encoder(BertConfig(**{**TINY, "hidden_dropout_prob": 0.1}), None, deterministic=False)


@pytest.mark.parametrize("n_micro", [1, 2, 4])
@pytest.mark.parametrize("with_mask", [False, True])
def test_pipe_of_one_matches_jax(setup, n_micro, with_mask):
    """Forward against JAX's pipeline on a 1-device pipe and its sequential
    encoder; the stacked gradients of a mean-squared loss against JAX's
    sequential gradients."""
    enc, params, hidden, pad, target, _ = setup
    jmask = jax_expand(jnp.asarray(pad)) if with_mask else None
    jrun = jpipe.pipelined_bert_encoder(JCFG, create_mesh((1,), ("pipe",), devices=jax.devices()[:1]),
                                        n_microbatches=n_micro)
    want_pipe = np.asarray(jax.jit(jrun)(jpipe.stack_layer_params(params, L), hidden, jmask))

    def seq_loss(p):
        out = enc.apply({"params": p}, hidden, jmask)
        return jnp.mean((out - target) ** 2), out

    (want_loss, want_seq), want_g = jax.jit(jax.value_and_grad(seq_loss, has_aux=True))(params)
    np.testing.assert_allclose(want_pipe, np.asarray(want_seq), atol=2e-5)

    stacked = {k: v.requires_grad_(True) for k, v in stacked_bert_params_from_flax(params, CFG).items()}
    run = pipelined_bert_encoder(CFG, None, n_microbatches=n_micro)
    mask = expand_padding_mask(torch.from_numpy(pad)) if with_mask else None
    x = torch.from_numpy(hidden).requires_grad_(True)
    got = run(pipeline_param_shardings(stacked, None), x, mask)
    np.testing.assert_allclose(got.detach().numpy(), want_pipe, atol=2e-5, rtol=0)
    loss = ((got - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, (path, kind) in _layer_paths().items():
        for i in range(L):
            leaf = want_g[f"layer_{i}"]
            for p in path:
                leaf = leaf[p]
            leaf = np.asarray(leaf)
            np.testing.assert_allclose(stacked[name].grad[i].numpy(), leaf.T if kind == LINEAR else leaf,
                                       atol=3e-5, rtol=0, err_msg=f"layer_{i}.{name}")
    assert x.grad is not None and float(x.grad.abs().max()) > 0


def test_pipe_of_one_equals_the_port_encoder(setup):
    """At one stage and M microbatches the pipeline runs the encoder's
    layers on each microbatch: the same numbers as the encoder's whole
    batch, within the parity bar, and the input gradient of the stacked
    path equals the encoder's."""
    _, params, hidden, pad, _, port = setup
    mask = expand_padding_mask(torch.from_numpy(pad))
    x1 = torch.from_numpy(hidden).requires_grad_(True)
    want = port(x1, mask)
    want.sum().backward()
    x2 = torch.from_numpy(hidden).requires_grad_(True)
    got = pipelined_bert_encoder(CFG, None, n_microbatches=2)(stacked_bert_params_from_flax(params, CFG), x2, mask)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(x2.grad.numpy(), x1.grad.numpy(), atol=3e-5, rtol=0)
