"""Port parity: HD-VILA's two-stage transformer, pretraining model, task
heads, one ``GenericTrainer`` step and the e2e-checkpoint loader
(``xpretrain_tpu_torch/models/hd_vila/{modeling,convert}.py``,
``models/pretrained.py:load_hdvila_e2e``, ``cli/run_pretrain_hdvila.py``)
against the JAX package on the CPU, fp32.

Seeded params of the JAX modules' shapes go into the port through
``load_jax_params``; the BERT is the tiny one with dropout 0, so JAX's
training mode (``deterministic=False``) and the port's draw nothing but the
pixel-sampling subset, which the port takes from JAX's draw as
``sample_indices``. Tolerances:
- outputs and losses within 1e-4 of max(1, max|JAX|) (PARITY.md's bar);
- gradients within 1e-4 of each parameter's max|g| (floored at 1e-3 of the
  tree's, as the LF-VILA tests: a key bias's gradient is rounding noise);
- the trainer step's loss and grad norm 1e-4 relative; the parameters after
  the AdamW step within 5e-6, 5% of its learning rate: the first Adam step
  moves each entry by lr * g / (|g| + 1e-6), so an entry whose gradient is
  near 1e-6 carries that gradient's fp32 rounding (up to 1e-4 of its
  tensor's largest entry, the bar above) into the update;
- the loaders: bit-equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hdvila_parity import TOL, jit_apply, random_params  # noqa: E402
from _hdvila_parity import assert_close as _close  # noqa: E402
from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel  # noqa: E402
from xpretrain_tpu_torch.cli.run_video_qa_hdvila import HdVilaQAModel  # noqa: E402
from xpretrain_tpu_torch.models.bert import BertConfig  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila import modeling  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.convert import (  # noqa: E402
    flax_param_paths,
    hdvila_e2e_state_dict,
    hdvila_e2e_torch_to_flax,
    key_rules,
    load_jax_params,
)
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoderConfig  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.modeling import HdVilaModelConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import CONV2D, LINEAR  # noqa: E402
from xpretrain_tpu_torch.models.pretrained import load_hdvila_e2e  # noqa: E402

BERT = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128, stage_bounds=(2,),
            vocab_size=1000, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
B, CLIPS, FRM, L = 2, 2, 3, 10
GRID = (B, CLIPS, 1, 2, 4, 64)  # the tiny encoder's grid at 128x256 middles
SAMPLE = 5  # pixel sampling: 5 of the grid's 8 positions


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _jax_cfgs(stage=1, agg="mean", sample=SAMPLE, frames=FRM, hw=(2, 4)):
    from xpretrain_tpu.models.bert import BertConfig as JaxBert
    from xpretrain_tpu.models.hd_vila.e2e import HdVilaEncoderConfig as JaxEnc
    from xpretrain_tpu.models.hd_vila.modeling import HdVilaModelConfig as JaxModel

    return (JaxEnc.tiny(timesformer_frames=frames, timesformer_hw=hw),
            JaxModel.tiny(stage=stage, bert=JaxBert(**BERT), pixel_random_sampling_size=sample, score_agg_func=agg))


def _port_cfgs(stage=1, agg="mean", sample=SAMPLE, frames=FRM, hw=(2, 4)):
    return (HdVilaEncoderConfig.tiny(timesformer_frames=frames, timesformer_hw=hw),
            HdVilaModelConfig.tiny(stage=stage, bert=BertConfig(**BERT), pixel_random_sampling_size=sample,
                                   score_agg_func=agg))


def _text(rng, shape):
    ids = rng.integers(2, 1000, size=(*shape, L))
    mask = (np.arange(L) < rng.integers(3, L + 1, size=(*shape, 1))).astype(np.int64)
    return ids, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _sample_draw(rng_key, n):
    """JAX's pixel-sampling draw (``modeling.py:102-112``)."""
    import jax
    import jax.numpy as jnp

    return np.array(jnp.sort(jax.random.permutation(rng_key, n)[:SAMPLE]))


# -- the transformer on a grid: stage 1, stage 2 under mean / max / lse ---------


@pytest.fixture(scope="module")
def grid_inputs():
    rng = np.random.default_rng(0)
    grid = rng.normal(size=GRID).astype(np.float32)
    ids, mask = _text(rng, (B,))
    labels = np.where(rng.random((B, L)) < 0.4, rng.integers(2, 1000, size=(B, L)), -100)
    labels[:, 1] = 7  # every row has masked tokens, the negative's included
    return grid, ids, mask, labels, np.array([1, 0])  # ITM: row 1 is a negative pair


@pytest.fixture(scope="module")
def stage2_transformer(grid_inputs):
    """(flax params, the port model) of the stage-2 ``HdVilaForPreTraining``;
    the aggregation changes no parameter."""
    from xpretrain_tpu.models.hd_vila.modeling import HdVilaForPreTraining as JaxPT

    grid, ids, mask, labels, itm = grid_inputs
    params = random_params(JaxPT(_jax_cfgs(2)[1]), grid, ids, mask, mlm_labels=labels, itm_labels=itm)
    return params, load_jax_params(modeling.HdVilaForPreTraining(_port_cfgs(2)[1]), {"params": params})


@pytest.mark.parametrize("agg", ["mean", "max", "lse"])
def test_stage2_transformer_matches_jax(stage2_transformer, grid_inputs, agg):
    """MLM and ITM logits, losses and accuracies, with JAX's pixel-sampling
    draw and an ITM negative whose MLM labels become -100
    (``modeling.py:242-245``), in training mode."""
    import jax

    from xpretrain_tpu.models.hd_vila.modeling import HdVilaForPreTraining as JaxPT

    params, port = stage2_transformer
    grid, ids, mask, labels, itm = grid_inputs
    jax_model = JaxPT(_jax_cfgs(2, agg)[1])
    key = jax.random.PRNGKey(5)
    want = jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a, sample_rng=key, deterministic=False))(
        params, grid, ids, mask, labels, itm)
    port.config = dataclasses.replace(port.config, score_agg_func=agg)
    port.train()
    got = port(*_t(grid, ids, mask), mlm_labels=torch.from_numpy(labels), itm_labels=torch.from_numpy(itm),
               sample_indices=torch.from_numpy(_sample_draw(key, 8)))
    assert set(got) == set(want)
    assert tuple(got["vtoken_output"].shape) == (CLIPS, B, SAMPLE, 64)
    for k in sorted(want):
        _close(got[k], want[k], k)
    # the negative pair's MLM labels are dropped: the loss is that of row 0 alone
    only_pos = np.where(np.arange(B)[:, None] == 0, labels, -100)
    solo = port(*_t(grid, ids, mask), mlm_labels=torch.from_numpy(only_pos),
                sample_indices=torch.from_numpy(_sample_draw(key, 8)))
    _close(solo["mlm_loss"], want["mlm_loss"], "mlm loss of the positive row")


def test_pixel_sampling_draws_from_the_generator_in_training_only(stage2_transformer, grid_inputs):
    """Without indices the subset is a sorted draw of the generator (the
    same seed, the same loss); in eval mode every position stays."""
    params, port = stage2_transformer
    grid, ids, mask, labels, _ = grid_inputs
    port.train()
    runs = [port(*_t(grid, ids, mask), mlm_labels=torch.from_numpy(labels),
                 generator=torch.Generator().manual_seed(s)) for s in (3, 3, 4)]
    assert runs[0]["vtoken_output"].shape[2] == SAMPLE
    assert runs[0]["mlm_loss"].item() == runs[1]["mlm_loss"].item()
    port.eval()
    assert port(*_t(grid, ids, mask))["vtoken_output"].shape[2] == 8
    port.train()


def test_stage1_transformer_tree_is_flax_lazy_tree(grid_inputs):
    """Stage 1 builds the BERT's first stage, ``pooler1``, ``t_proj`` and
    ``v_proj`` alone, as flax's lazy init does; the stage-2 tree does not
    load into it."""
    from xpretrain_tpu.models.hd_vila.modeling import HdVilaForPreTraining as JaxPT

    grid, ids, mask, *_ = grid_inputs
    params = random_params(JaxPT(_jax_cfgs(1)[1]), grid, ids, mask)
    assert set(params) == {"bert_model", "t_proj", "v_proj"}
    assert set(params["bert_model"]) == {"bert", "pooler1"}
    port = load_jax_params(modeling.HdVilaForPreTraining(_port_cfgs(1)[1]), {"params": params})
    want = jit_apply(JaxPT(_jax_cfgs(1)[1]))(params, grid, ids, mask)
    got = port(*_t(grid, ids, mask))
    assert set(got) == set(want) == {"text_features", "vis_features"}
    for k in want:
        _close(got[k], want[k], k)
    with pytest.raises(KeyError):
        load_jax_params(modeling.HdVilaForPreTraining(_port_cfgs(2)[1]), {"params": params})


# -- the four task heads ---------------------------------------------------------

HEADS = ["sequence_classification", "multiple_choice", "regression", "retrieval"]


@pytest.mark.parametrize("head", HEADS)
def test_task_head_matches_jax(grid_inputs, head):
    """Each head at 2 clips under lse (the logits aggregate over clips, the
    text tiled per clip, clip-major); multiple choice at 3 choices."""
    from xpretrain_tpu.models.hd_vila import modeling as jax_modeling

    grid, ids, mask, *_ = grid_inputs
    jax_cfg, port_cfg = _jax_cfgs(2, "lse")[1], _port_cfgs(2, "lse")[1]
    if head == "multiple_choice":
        ids, mask = _text(np.random.default_rng(1), (B, 3))
    jax_model, port = {
        "sequence_classification": (jax_modeling.HdVilaForSequenceClassification(jax_cfg, 5),
                                    modeling.HdVilaForSequenceClassification(port_cfg, 5)),
        "multiple_choice": (jax_modeling.HdVilaForMultipleChoice(jax_cfg),
                            modeling.HdVilaForMultipleChoice(port_cfg)),
        "regression": (jax_modeling.HdVilaForRegression(jax_cfg), modeling.HdVilaForRegression(port_cfg)),
        "retrieval": (jax_modeling.HdVilaForVideoTextRetrieval(jax_cfg),
                      modeling.HdVilaForVideoTextRetrieval(port_cfg)),
    }[head]
    params = random_params(jax_model, grid, ids, mask)
    port = load_jax_params(port, {"params": params}).eval()
    want = jit_apply(jax_model)(params, grid, ids, mask)
    got = port(*_t(grid, ids, mask))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], k)
    assert tuple(got["logits"].shape) == {"sequence_classification": (B, 5), "multiple_choice": (B, 3)}.get(
        head, (B,))


# -- the whole pretraining model: stage 1 with gradients, stage 2 ------------------


def _video(rng, b, clips, h=128, w=256):
    mid = rng.integers(0, 256, size=(b, clips, 3, h, w)).astype(np.uint8)
    oth = rng.integers(0, 256, size=(b, clips, FRM - 1, 3, h // 4, w // 4)).astype(np.uint8)
    return mid, oth


def test_stage2_pretrain_model_matches_jax():
    """Encoder + transformer from uint8 frames (JAX: their 0-255 fp32) at
    stage 2, under lse with pixel sampling and an ITM negative (stage 1:
    ``test_stage1_itc_gradients_match_jax``)."""
    import jax

    from xpretrain_tpu.cli.run_pretrain_hdvila import HdVilaPretrainModel as JaxModel

    stage = 2
    rng = np.random.default_rng(stage)
    mid, oth = _video(rng, B, CLIPS)
    ids, mask = _text(rng, (B,))
    labels = np.where(rng.random((B, L)) < 0.4, rng.integers(2, 1000, size=(B, L)), -100)
    itm = np.array([1, 0])
    kw = dict(mlm_labels=labels, itm_labels=itm)
    jax_model = JaxModel(*_jax_cfgs(stage, "lse"))
    params = random_params(jax_model, mid.astype(np.float32), oth.astype(np.float32), ids, mask, **kw)
    key = jax.random.PRNGKey(2)
    want = jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a, sample_rng=key, deterministic=False, **kw))(
        params, mid.astype(np.float32), oth.astype(np.float32), ids, mask)
    port = load_jax_params(HdVilaPretrainModel(*_port_cfgs(stage, "lse")), {"params": params}).train()
    got = port(*_t(mid, oth, ids, mask), mlm_labels=torch.from_numpy(labels), itm_labels=torch.from_numpy(itm),
               sample_indices=torch.from_numpy(_sample_draw(key, 8)))
    assert set(got) == set(want)
    for k in sorted(want):
        _close(got[k], want[k], k)
    assert float(got["loss"]) > 0


@pytest.fixture(scope="module")
def stage1_step():
    """A stage-1 batch of 8 (the data axis of the 8-device CPU mesh) at one
    clip of 64x128, the JAX model and its params, and JAX's loss and
    gradients there."""
    import jax

    from xpretrain_tpu.cli.run_pretrain_hdvila import HdVilaPretrainModel as JaxModel

    rng = np.random.default_rng(11)
    mid, oth = _video(rng, 8, 1, 64, 128)
    ids, mask = _text(rng, (8,))
    batch = {"img_middle": mid, "img_other": oth, "text_input_ids": ids, "text_input_mask": mask}
    jax_model = JaxModel(*_jax_cfgs(1, hw=(1, 2)))
    params = random_params(jax_model, mid.astype(np.float32), oth.astype(np.float32), ids, mask)

    def loss_fn(p, b):
        out = jax_model.apply({"params": p}, b["img_middle"].astype(np.float32), b["img_other"].astype(np.float32),
                              b["text_input_ids"], b["text_input_mask"], deterministic=False)
        return out["loss"], out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params, batch)
    return batch, jax_model, params, jax.tree_util.tree_map(np.asarray, (out, grads))


def _flax_layout(grad: np.ndarray, kind: str) -> np.ndarray:
    if kind == LINEAR:
        return grad.T
    if kind == CONV2D:
        return grad.transpose(2, 3, 1, 0)  # OIHW -> HWIO
    return grad


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def test_stage1_itc_gradients_match_jax(stage1_step):
    """The whole stage-1 model from uint8 frames (JAX: their 0-255 fp32): the
    ITC features and loss, and every parameter's gradient, the frozen BNs'
    scale, bias, mean and var included (they are params, as in flax)."""
    import jax

    batch, _, params, (want, grads) = stage1_step
    port = load_jax_params(HdVilaPretrainModel(*_port_cfgs(1, hw=(1, 2))), {"params": params}).train()
    out = port(*_t(*batch.values()))
    assert set(out) == set(want) == {"text_features", "vis_features", "itc_loss", "loss"}
    for k in want:
        _close(out[k], want[k], k)
    out["loss"].backward()
    floor = 1e-3 * max(float(np.abs(g).max()) for g in jax.tree_util.tree_leaves(grads))
    rules = key_rules(port)
    assert any(name.endswith(".var") for name in rules)
    for name, p in port.named_parameters():
        path, kind = rules[name]
        want = _leaf(grads, path)
        assert p.grad is not None, name
        top = max(float(np.abs(want).max()), floor)
        np.testing.assert_allclose(_flax_layout(p.grad.numpy(), kind), want, atol=TOL * top, rtol=0, err_msg=name)


def test_generic_trainer_step_matches_jax(stage1_step, tmp_path):
    """The slice as a whole: JAX's ``GenericTrainer`` and the port's each take
    one stage-1 step of ``HdVilaPretrainModel`` on the same 0-255 batch (the
    port's uint8, JAX's fp32): loss, grad norm and every updated parameter."""
    import jax

    from xpretrain_tpu.config import ConfigDict as JaxConfigDict
    from xpretrain_tpu.parallel.mesh import shard_host_batch
    from xpretrain_tpu.parallel.train_step import TrainState as JaxState
    from xpretrain_tpu.train.generic_trainer import GenericTrainer as JaxTrainer
    from xpretrain_tpu_torch.config import ConfigDict
    from xpretrain_tpu_torch.parallel.train_step import TrainState
    from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer

    batch, jax_model, params, *_ = stage1_step
    opt = dict(learning_rate=1e-4, decay="constant", warmup_ratio=0.0, weight_decay=0.01, grad_norm=5.0,
               num_train_steps=10, seed=0)

    def jax_apply(p, b, r):
        return jax_model.apply({"params": p}, b["img_middle"].astype(np.float32), b["img_other"].astype(np.float32),
                               b["text_input_ids"], b["text_input_mask"], deterministic=False, rngs={"dropout": r})

    jt = JaxTrainer(JaxConfigDict(output_dir=str(tmp_path / "jax"), **opt), jax_apply, params, iter(()),
                    metric_keys=("itc_loss",))
    with jt.mesh:
        state, jm = jt.train_step(JaxState.create(jt.init_params, jt.tx), shard_host_batch(batch, jt.mesh),
                                  jax.random.PRNGKey(0))
    new_params = jax.tree_util.tree_map(np.asarray, state.params)

    port = load_jax_params(HdVilaPretrainModel(*_port_cfgs(1, hw=(1, 2))), {"params": params})
    trainer = GenericTrainer(ConfigDict(output_dir=str(tmp_path / "port"), **opt), port,
                             lambda m, b, g: m(b["img_middle"], b["img_other"], b["text_input_ids"],
                                               b["text_input_mask"], generator=g),
                             iter(()), metric_keys=("itc_loss",), param_paths=flax_param_paths(port), device="cpu")
    _, pm = trainer.train_step(TrainState(step=0, model=port, optimizer=trainer.optimizer),
                               {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    np.testing.assert_allclose(pm["loss"].item(), float(jm["loss"]), rtol=TOL)
    np.testing.assert_allclose(pm["grad_norm"].item(), float(jm["grad_norm"]), rtol=TOL)
    rules = key_rules(port)
    for name, p in port.named_parameters():
        path, kind = rules[name]
        np.testing.assert_allclose(_flax_layout(p.detach().numpy(), kind), _leaf(new_params, path), atol=5e-6,
                                   rtol=0, err_msg=name)


# -- the e2e checkpoint: the writer and load_hdvila_e2e ---------------------------


@pytest.fixture(scope="module")
def e2e_checkpoint(tmp_path_factory):
    """A reference-layout HDVILA state dict of a seeded stage-2 tiny model
    (written by ``hdvila_e2e_state_dict``), saved as a .pt, and the model."""
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import init_hdvila_weights

    model = init_hdvila_weights(HdVilaPretrainModel(*_port_cfgs(2)), torch.Generator().manual_seed(3))
    path = str(tmp_path_factory.mktemp("e2e") / "hdvila_e2e.pt")
    sd = hdvila_e2e_state_dict(model)
    torch.save(sd, path)
    return path, sd, model


def test_e2e_state_dict_is_the_reference_layout(e2e_checkpoint):
    """The writer's keys are the reference's (the JAX converter maps every
    one), and its converted tree is the model's own, leaf for leaf."""
    from xpretrain_tpu.models.hd_vila.convert import hdvila_e2e_torch_to_flax as jax_convert

    path, sd, model = e2e_checkpoint
    assert "cnn.layer1.0.conv1.weight" in sd and "cnn_low.layer3.0.downsample.1.running_var" in sd
    assert "transformer.bert.visual_embeddings.token_type_embeddings.weight" in sd
    assert "transformer.cls.predictions.decoder.weight" in sd and "timesformer.blocks.0.temporal_fc.weight" in sd
    tree = hdvila_e2e_torch_to_flax(sd)
    want = jax_convert(sd)
    import jax

    flat_got = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want) == len(list(model.parameters()))
    for path_, value in flat_got:
        np.testing.assert_array_equal(value, flat_want[path_])
    reloaded = load_jax_params(HdVilaPretrainModel(*_port_cfgs(2)), tree)
    for (name, a), b in zip(model.named_parameters(), reloaded.parameters()):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("kind", ["pretrain", "qa_head"])
def test_load_hdvila_e2e_matches_jax(e2e_checkpoint, kind):
    """``load_hdvila_e2e`` merges the checkpoint as JAX's does: into a
    stage-2 pretraining model, and into a QA model, whose ``head`` takes the
    pretraining transformer's ``bert_model`` while its classifier keeps its
    init."""
    from xpretrain_tpu.cli.run_pretrain_hdvila import HdVilaPretrainModel as JaxModel
    from xpretrain_tpu.cli.run_video_qa_hdvila import HdVilaQAModel as JaxQA
    from xpretrain_tpu.models.pretrained import load_hdvila_e2e as jax_load

    path, sd, _ = e2e_checkpoint
    rng = np.random.default_rng(4)
    mid, oth = _video(rng, 1, 1)
    ids, mask = _text(rng, (1,))
    if kind == "pretrain":
        jax_model, port = JaxModel(*_jax_cfgs(2)), HdVilaPretrainModel(*_port_cfgs(2))
        init = random_params(jax_model, mid.astype(np.float32), oth.astype(np.float32), ids, mask,
                             mlm_labels=np.full((1, L), -100), itm_labels=np.ones(1, np.int64), seed=9)
    else:
        jax_model, port = JaxQA(*_jax_cfgs(2), "mc"), HdVilaQAModel(*_port_cfgs(2), "mc")
        ids, mask = _text(rng, (1, 3))
        init = random_params(jax_model, mid.astype(np.float32), oth.astype(np.float32), ids, mask, seed=9)
    merged = jax_load(init, path)
    load_hdvila_e2e(load_jax_params(port, {"params": init}), path)
    want = load_jax_params(type(port)(*_port_cfgs(2), *(["mc"] if kind == "qa_head" else [])), {"params": merged})
    for (name, a), b in zip(port.named_parameters(), want.parameters()):
        assert torch.equal(a, b), name
    if kind == "qa_head":
        word = "transformer.bert.embeddings.word_embeddings.weight"
        assert torch.equal(port.head.bert_model.bert.embeddings.word_embeddings.weight, torch.from_numpy(
            np.asarray(sd[word])))
        np.testing.assert_array_equal(port.head.classifier.layers_0.weight.detach().numpy(),
                                      init["head"]["classifier"]["layers_0"]["kernel"].T)
