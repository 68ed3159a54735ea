"""Port parity: LF-VILA pretraining (``xpretrain_tpu_torch/models/lf_vila/
pretrain.py``), its MLM head and video-token positions, Swin3D remat, the
stage-2 optimizer labels and the pretraining runner
(``xpretrain_tpu_torch/cli/run_pretrain_lfvila.py``).

Each stage's tiny model is held against the JAX package's ``LfVilaPretrain``
from the same (noisy) flax params, carried over by ``load_jax_params``, fp32
on the CPU with dropout off: outputs and losses within 5e-5, gradients within
5e-5 of each leaf's max|g| (floored at 1e-3 of the tree's). Stage 1's MTC clips are drawn from ``mtc_rng``
with JAX's own recipe and handed to the port as ``mtc_indices``: torch's
generator draws other clips. The flax params and the JAX results are built
once for the module.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_pretrain_lfvila  # noqa: E402
from xpretrain_tpu_torch.models.bert import BertConfig, BertMLMHead  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila import swin3d  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import (  # noqa: E402
    CONV3D,
    LINEAR,
    flax_param_paths,
    key_rules,
    load_jax_params,
)
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig, LfVilaPretrain, VideoTokenPos  # noqa: E402
from xpretrain_tpu_torch.optim import optimizer as opt  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 5e-5
B, M, L = 4, 4, 8  # clips (VTM rolls the first half), sentences per paragraph, tokens per sentence
FRAMES = (8, 96, 160)  # the tiny Swin3D's final map is 2x3: one token per frame after MaxPool(2,3)
TINY_KW = dict(sample_frame=FRAMES[0], final_num_patches=1)
# the stage-2 preset's freeze list for the tiny BERT (stage 1 ends at layer 4)
FROZEN = ["video_encoder", "sent_embedding", "text_encoder/embeddings", "layer_0/", "layer_1/", "layer_2/",
          "layer_3/"]
TINY_CONFIG = {  # the tiny model through the runner
    "video_encoder": {"embed_dim": 32, "depths": [1, 1, 2, 1, 1, 1], "num_heads": [2, 2, 4, 4, 4, 4]},
    "bert": "tiny", "num_local_layers": 2, "stage1_layers": 4, "sample_frame": 8, "sample_clip": 4,
    "final_num_patches": 1,
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(B, 3, *FRAMES)).astype(np.float32)
    ids = rng.integers(1, 1000, size=(B, M, L))
    mask = (np.arange(L)[None, None] < rng.integers(2, L + 1, size=(B, M, 1))).astype(np.int64)
    labels = np.where(rng.random((B, M * L)) < 0.3, rng.integers(1, 1000, size=(B, M * L)), -100)
    return video, ids, mask, labels


def _jax_mtc_indices(rng, b, m, num_key=2, num_value=2):
    """The clips JAX's ``mtc_loss`` draws from ``rng`` (its ``perms`` recipe)."""
    import jax

    k_key, k_value, k_other = jax.random.split(rng, 3)

    def perms(key, count):
        return jax.vmap(lambda kk: jax.random.permutation(kk, m))(jax.random.split(key, b))[:, :count]

    return tuple(np.asarray(x) for x in (perms(k_key, num_key), perms(k_value, num_value), perms(k_other, 1)[:, 0]))


def _noisy(params, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32),
                                  params)


def _flax_layout(grad: np.ndarray, kind: str) -> np.ndarray:
    if kind == LINEAR:
        return grad.T
    if kind == CONV3D:
        return grad.transpose(2, 3, 4, 1, 0)
    return grad


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


@pytest.fixture(scope="module", params=[1, 2], ids=["stage1", "stage2"])
def stage(request):
    """(stage, flax params, port model loaded from them, JAX outputs, JAX
    gradients, MTC indices) of the tiny model."""
    import jax

    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig
    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaPretrain as JaxPretrain

    st = request.param
    jax_model = JaxPretrain(JaxConfig.tiny(stage=st, **TINY_KW))
    video, ids, mask, labels = _inputs()
    mtc_rng = jax.random.PRNGKey(7)
    kwargs = {"mtc_rng": mtc_rng} if st == 1 else {"mlm_labels": labels}
    init_kwargs = {"mtc_rng": mtc_rng} if st == 1 else {"mlm_labels": labels[:2]}
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), video[:2], ids[:2], mask[:2], **init_kwargs)["params"]
    params = _noisy(params, seed=st)

    def loss_fn(p):
        out = jax_model.apply({"params": p}, video, ids, mask, **kwargs)
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = LfVilaPretrain(LfVilaConfig.tiny(stage=st, **TINY_KW))
    load_jax_params(port, {"params": params})
    indices = _jax_mtc_indices(mtc_rng, B, M) if st == 1 else None
    return st, params, port.eval(), {k: np.asarray(v) for k, v in out.items()}, grads, indices


def _port_run(port, indices, seed=0):
    video, ids, mask, labels = (torch.from_numpy(a) for a in _inputs(seed))
    port.zero_grad()
    out = port(video, ids, mask, mlm_labels=labels if port.config.stage == 2 else None, mtc_indices=indices)
    out["loss"].backward()
    return out


def test_forward_and_gradients_match_jax(stage):
    st, params, port, want, grads, indices = stage
    got = _port_run(port, indices)
    keys = (["video_local_feat", "text_local_feat", "video_global_feat", "text_global_feat", "ct_global_loss",
             "ct_time_loss", "loss"] if st == 1 else
            ["mlm_logits", "vtm_logits", "mlm_loss", "mlm_acc", "vtm_loss", "vtm_acc", "loss"])
    assert set(got) == set(want)
    for key in keys:
        np.testing.assert_allclose(got[key].detach().numpy(), want[key], atol=ATOL, rtol=0, err_msg=key)
    assert float(got["loss"].detach()) > 0 and (st == 2 or float(got["ct_time_loss"].detach()) > 0)
    _assert_grads_match(port, grads)


def _assert_grads_match(port, grads):
    """Each parameter's gradient within 5e-5 of its flax leaf's max|g|, that
    max floored at 1e-3 of the whole tree's (a key bias's gradient is zero
    but for rounding: softmax ignores a shift along the keys); a parameter
    the forward never reaches (the unused local branch) has no gradient in
    torch and zeros in JAX."""
    import jax

    rules = key_rules(port)
    floor = 1e-3 * max(float(np.abs(np.asarray(g)).max()) for g in jax.tree_util.tree_leaves(grads))
    for name, p in port.named_parameters():
        path, kind = rules[name]
        g = _leaf(grads, path)
        if p.grad is None:
            assert not g.any(), name
            continue
        top = max(np.abs(g).max(), floor)
        np.testing.assert_allclose(_flax_layout(p.grad.numpy(), kind), g, atol=ATOL * top, rtol=0, err_msg=name)


def test_stage_trees_differ_as_flax_builds_them(stage):
    """The load is total both ways for each stage: the other stage's model
    takes no stage tree, and each model holds exactly its stage's modules."""
    st, params, port, *_ = stage
    other = LfVilaPretrain(LfVilaConfig.tiny(stage=3 - st, **TINY_KW))
    with pytest.raises(KeyError):
        load_jax_params(other, {"params": params})
    tops = set(params)
    assert {name.split(".")[0] for name, _ in port.named_parameters()} == tops
    stage1_only = {"video_local_proj", "text_local_proj", "video_global_proj", "text_global_proj"}
    stage2_only = {"cls", "seq_relationship", "video_token_pos"}
    assert tops & (stage2_only if st == 1 else stage1_only) == set()
    assert ("pooler" in params["text_encoder"]) == (st == 2)
    assert f"layer_{port.config.bert.num_hidden_layers - 1}" in params["text_encoder"]["encoder"] or st == 1
    extra = dict(params, seq_relationship={"bias": np.zeros(2, np.float32), "kernel": np.zeros((256, 2))})
    if st == 1:
        with pytest.raises(KeyError, match="seq_relationship"):
            load_jax_params(LfVilaPretrain(LfVilaConfig.tiny(stage=1, **TINY_KW)), {"params": extra})


def test_losses_without_their_inputs(stage):
    """Stage 1 without indices draws its MTC clips from the generator (the
    same seed, the same loss) and, with neither, reports a zero MTC loss, as
    JAX does without ``mtc_rng``; stage 2 without MLM labels reports zero MLM
    loss and accuracy, and its loss is the VTM loss."""
    st, _, port, *_ = stage
    video, ids, mask, _ = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        seeded = [port(video, ids, mask, generator=torch.Generator().manual_seed(3)) for _ in range(2)]
        bare = port(video, ids, mask)
    if st == 1:
        a, b = (out["ct_time_loss"] for out in seeded)
        assert torch.isfinite(a) and float(a) > 0 and float(a) == float(b)
        assert float(bare["ct_time_loss"]) == 0.0 and float(bare["loss"]) == float(bare["ct_global_loss"])
    else:
        assert float(bare["mlm_loss"]) == float(bare["mlm_acc"]) == 0.0
        assert float(bare["loss"]) == float(bare["vtm_loss"]) > 0


def test_stage2_param_labels_match_jax(stage):
    """Frozen and no-decay labels under the stage-2 preset's
    ``frozen_patterns`` and ``NO_DECAY_LFVILA``, by flax path: the port's label
    of each parameter is JAX's label of its leaf."""
    from xpretrain_tpu import optim as jax_optim

    st, params, port, *_ = stage
    with open(os.path.join(REPO, "xpretrain_tpu_torch/configs/lfvila_pretrain_stage2.json")) as f:
        frozen = json.load(f)["frozen_patterns"]
    want = jax_optim.param_group_labels(params, no_decay_patterns=jax_optim.NO_DECAY_LFVILA, frozen_patterns=frozen)
    paths = flax_param_paths(port)
    got = opt.param_group_labels(dict(port.named_parameters()), no_decay_patterns=opt.NO_DECAY_LFVILA,
                                 frozen_patterns=frozen, paths=paths)
    for name, label in got.items():
        assert label == _leaf(want, paths[name].split("/")), name
    if st == 2:
        assert got["video_encoder.patch_embed.proj.weight"] == "frozen"
        # the preset freezes BERT-large's layers 0-11, every layer of the tiny BERT
        assert got["text_encoder.encoder.layer_5.output_dense.weight"] == "frozen"
        assert got["text_encoder.pooler.dense.weight"] == "base_decay"
        assert got["video_token_pos.s_pos_embed"] == "base_no_decay"
        assert got["cls.decoder.weight"] == "base_decay"


def test_mlm_head_and_video_token_pos_match_jax():
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.bert import BertConfig as JaxBert
    from xpretrain_tpu.models.bert import BertMLMHead as JaxHead
    from xpretrain_tpu.models.lf_vila.pretrain import VideoTokenPos as JaxPos

    rng = np.random.default_rng(11)
    kw = dict(hidden_size=64, intermediate_size=96, num_attention_heads=4, vocab_size=300)
    hidden = rng.normal(size=(3, 7, 64)).astype(np.float32)
    tokens = rng.normal(size=(2, 5, 6, 64)).astype(np.float32)
    cases = [(JaxHead(JaxBert(**kw)), BertMLMHead(BertConfig(**kw)), hidden),
             (JaxPos(6, 5, 64), VideoTokenPos(6, 5, 64), tokens)]
    for jax_mod, port, x in cases:
        params = _noisy(jax_mod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], seed=12)
        load_jax_params(port, {"params": params})
        want = np.asarray(jax_mod.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = port(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0, err_msg=type(port).__name__)


# -- Swin3D remat ------------------------------------------------------------


def _swin_train_grads(remat: bool, policy=None):
    # the local branch computed, so that every parameter has a gradient
    cfg = swin3d.Swin3DConfig.tiny(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.3, remat=remat,
                                   remat_policy=policy, faithful_local_branch=False)
    torch.manual_seed(0)
    model = swin3d.SwinTransformer3D(cfg).train()
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, *FRAMES)).astype(np.float32))
    weight = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 8, 2, 3, 256)).astype(np.float32))
    g, l = model(x, torch.Generator().manual_seed(9))
    loss = (g * weight).sum() + (l * weight).sum() * 0.5
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.fixture(scope="module")
def swin_reference():
    return _swin_train_grads(remat=False)


@pytest.mark.parametrize("policy", [None, "dots_saveable", "dots_with_no_batch_dims_saveable"],
                         ids=["full", "dots_saveable", "dots_with_no_batch_dims_saveable"])
def test_remat_gives_the_gradients_of_no_remat(swin_reference, policy):
    """In training, with dropout, attention dropout and drop-path: the
    recompute draws the forward's masks, so loss and gradients are those of
    the model without remat."""
    loss, grads = _swin_train_grads(remat=True, policy=policy)
    want_loss, want = swin_reference
    torch.testing.assert_close(loss, want_loss, atol=0, rtol=0)
    assert set(grads) == set(want)
    for name, g in grads.items():
        torch.testing.assert_close(g, want[name], atol=1e-6, rtol=1e-5, msg=name)


def test_remat_recomputes_and_selective_policy_saves_matmuls(monkeypatch):
    """Full remat runs each block's forward twice in a training step; the
    policies hand a selective-checkpoint context to ``checkpoint``."""
    calls = []
    block_forward = swin3d.SwinBlock3D.forward
    monkeypatch.setattr(swin3d.SwinBlock3D, "forward", lambda self, *a: calls.append(1) or block_forward(self, *a))
    _swin_train_grads(remat=True)
    n_blocks = sum(swin3d.Swin3DConfig.tiny().depths)
    assert len(calls) == 2 * n_blocks
    ops = swin3d.REMAT_POLICIES
    assert set(ops["dots_with_no_batch_dims_saveable"]) < set(ops["dots_saveable"])
    assert torch.ops.aten.bmm.default in ops["dots_saveable"]
    assert swin3d.remat_context_fn("dots_saveable") is not None and swin3d.remat_context_fn(None) is None


def test_remat_policy_is_ignored_without_remat_and_unknown_raises():
    tiny = swin3d.Swin3DConfig.tiny
    assert swin3d.SwinTransformer3D(tiny(remat_policy="no_such_policy")).remat_context_fn is None
    with pytest.raises(ValueError, match="remat_policy"):
        swin3d.SwinTransformer3D(tiny(remat=True, remat_policy="no_such_policy"))


# -- presets and the runner --------------------------------------------------


@pytest.mark.parametrize("stage_no", [1, 2])
def test_json_preset_is_the_yaml_preset(stage_no):
    """The card's machine has no PyYAML: the port's JSON copies of the two
    pretraining presets hold the YAML's values."""
    from xpretrain_tpu.config import load_config_file

    presets = os.path.join(REPO, "xpretrain_tpu/configs/presets")
    yaml_cfg = load_config_file(os.path.join(presets, f"lfvila_pretrain_stage{stage_no}.yaml"))
    with open(os.path.join(REPO, f"xpretrain_tpu_torch/configs/lfvila_pretrain_stage{stage_no}.json")) as f:
        assert json.load(f) == json.loads(json.dumps(dict(yaml_cfg)))


def _runner_args(tmp_path, stage_no, steps, *extra):
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(TINY_CONFIG))
    return ["--config", str(config), "--stage", str(stage_no), "--dummy_data", "1", "--input_hw", "96", "160",
            "--num_train_steps", str(steps), "--train_batch_size", "2", "--log_steps", "1", "--save_steps", "1",
            "--bf16", "0", "--device", "cpu", "--output_dir", str(tmp_path / "out"), "--max_txt_len", "8",
            *(["--frozen_patterns", *FROZEN] if stage_no == 2 else []), *extra]


def _scalars(out_dir):
    with open(out_dir / "log" / "scalars.jsonl") as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("stage_no", [1, 2])
def test_runner_trains_and_resumes(tmp_path, stage_no):
    """2 steps of the tiny model on synthetic u8 frames: finite losses and
    the stage's metrics; stage 2 leaves every frozen parameter as initialized
    and moves the others (but for the local branch, which the faithful
    Swin3D never runs); a second run on the same directory resumes at step 2
    and takes the third step only."""
    state = run_pretrain_lfvila.main(_runner_args(tmp_path, stage_no, 2))
    rows = _scalars(tmp_path / "out")
    by_tag = {}
    for r in rows:
        by_tag.setdefault(r["tag"], []).append(r["value"])
    metrics = ["train/loss", "train/grad_norm"] + (
        ["train/ct_global_loss", "train/ct_time_loss"] if stage_no == 1 else
        ["train/mlm_loss", "train/vtm_loss", "train/mlm_acc", "train/vtm_acc"])
    for tag in metrics:
        assert len(by_tag[tag]) == 2 and all(np.isfinite(by_tag[tag])), tag
    model = state.model
    fresh = LfVilaPretrain(model.config).init_weights(torch.Generator().manual_seed(42))
    labels = opt.param_group_labels(dict(model.named_parameters()), no_decay_patterns=opt.NO_DECAY_LFVILA,
                                    frozen_patterns=FROZEN if stage_no == 2 else (), paths=flax_param_paths(model))
    start = dict(fresh.named_parameters())
    for name, p in model.named_parameters():
        if "local_feat_proj" in name or "norm_local" in name:
            continue  # no gradient: only weight decay moves them
        assert torch.equal(p, start[name]) == (labels[name] == "frozen"), name
    assert (stage_no == 2) == any(lb == "frozen" for lb in labels.values())

    state = run_pretrain_lfvila.main(_runner_args(tmp_path, stage_no, 3))
    assert state.step == 3
    steps = [r["step"] for r in _scalars(tmp_path / "out") if r["tag"] == "train/loss"]
    assert steps == [1, 2, 3]


def test_runner_feeds_uint8_frames_by_default(tmp_path, monkeypatch):
    """``device_ingest`` defaults to 1 in this runner (the shared parser's
    default is 0); the loader ships u8 frames, fp32 with ``--device_ingest 0``."""
    loaders = []
    build = run_pretrain_lfvila.build_loader
    monkeypatch.setattr(run_pretrain_lfvila, "build_loader", lambda *a: loaders.append(build(*a)) or loaders[-1])
    for extra in ((), ("--device_ingest", "0")):
        run_pretrain_lfvila.main(_runner_args(tmp_path, 1, 0, *extra))
    assert [next(it)["video_frames"].dtype for it in loaders] == [np.uint8, np.float32]


@pytest.mark.parametrize("flag", run_pretrain_lfvila.WEIGHT_FLAGS)
def test_runner_raises_on_checkpoint_flags(tmp_path, flag):
    """Each weight flag loads its torch checkpoint
    (``tests/test_torch_pretrained_loading.py``); a file that is not there
    raises instead of leaving the random init."""
    with pytest.raises(FileNotFoundError, match="w.pt"):
        run_pretrain_lfvila.main(_runner_args(tmp_path, 1, 0, f"--{flag}", "w.pt"))


@pytest.mark.parametrize("stage_no", [1, 2])
def test_runner_steps_per_call_2_equals_steps_per_call_1(tmp_path, stage_no):
    """``GenericTrainer`` at ``--steps_per_call 2`` against 1, 4 steps of the
    tiny model: step s draws its MTC clips and dropout from seed + s in both,
    so parameters, moments and logged losses are bit-identical."""
    runs = {}
    for k in (1, 2):
        out = tmp_path / f"k{k}"
        out.mkdir()
        runs[k] = run_pretrain_lfvila.main(_runner_args(out, stage_no, 4, "--steps_per_call", str(k)))
    a, b = runs[1], runs[2]
    assert a.step == b.step == 4 and a.optimizer.count == b.optimizer.count == 4
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for moment in ("mu", "nu"):
        for m, n in zip(getattr(a.optimizer, moment), getattr(b.optimizer, moment)):
            assert torch.equal(m, n)
    losses = [[r["value"] for r in _scalars(tmp_path / f"k{k}" / "out") if r["tag"] == "train/loss"] for k in (1, 2)]
    assert losses[0] == losses[1] and len(losses[0]) == 4 and len(set(losses[0])) == 4
