"""Port parity: the LF-VILA downstream heads (``LfVilaQAMultichoice``,
``LfVilaQAClassification``, ``LfVilaVideoClassification`` in
``xpretrain_tpu_torch/models/lf_vila/tasks.py``) and their tasks in the runner
(``xpretrain_tpu_torch/cli/run_tasks_lfvila.py --task qa_mc|qa_cls|video_cls``).

Each tiny head is held against the JAX head from the same (noisy) flax params
(``load_jax_params``), fp32 on the CPU with dropout off: outputs and losses
within 5e-5, gradients within 5e-5 of each leaf's max|g| (floored at 1e-3 of
the tree's). The window-kernel gate is on, so its plain version runs here;
with the launch stood in for, an eval forward counts one launch per gated
block. The flax params and JAX results are built once per head.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _xpt_ops import xpt_ops_on_cpu  # noqa: E402

from xpretrain_tpu_torch.cli import run_tasks_lfvila  # noqa: E402
from xpretrain_tpu_torch.config import ConfigDict  # noqa: E402
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila import swin3d  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.tasks import (  # noqa: E402
    LfVilaQAClassification,
    LfVilaQAMultichoice,
    LfVilaRetrieval,
    LfVilaVideoClassification,
)
from xpretrain_tpu_torch.ops import window_attention as wa  # noqa: E402
from test_torch_lfvila_pretrain import _assert_grads_match, _noisy  # noqa: E402

ATOL = 5e-5
B, N_CHOICE, M, L = 2, 3, 2, 8
FRAMES = (8, 96, 160)  # one token per frame after MaxPool(2,3) on the tiny Swin3D
NUM_LABELS = {"qa_cls": 5, "video_cls": 7}
WINDOW_BLOCKS = 3  # tiny Swin3D: stages 3-5, one block each, windows of >= 240 tokens unclipped
TINY_CONFIG = {
    "video_encoder": {"embed_dim": 32, "depths": [1, 1, 2, 1, 1, 1], "num_heads": [2, 2, 4, 4, 4, 4],
                      "use_pallas_attention": True},
    "bert": "tiny", "num_local_layers": 2, "stage1_layers": 4, "sample_frame": 8, "final_num_patches": 1,
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _config(cls):
    from xpretrain_tpu.models.lf_vila.swin3d import Swin3DConfig as JaxSwin

    kw = dict(sample_frame=FRAMES[0], final_num_patches=1)
    if cls is LfVilaConfig:
        return LfVilaConfig.tiny(video=swin3d.Swin3DConfig.tiny(use_pallas_attention=True), **kw)
    return cls.tiny(video=JaxSwin.tiny(use_pallas_attention=True), **kw)


def _inputs(head, seed=0):
    """The head's positional inputs and its label keyword arguments (numpy)."""
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(B, 3, *FRAMES)).astype(np.float32)
    if head == "video_cls":
        return (video,), {"labels": rng.integers(0, NUM_LABELS[head], size=B)}
    shape = (B, N_CHOICE, M, L) if head == "qa_mc" else (B, M, L)
    ids = rng.integers(1, 1000, size=shape)
    mask = (np.arange(L) < rng.integers(2, L + 1, size=shape[:-1] + (1,))).astype(np.int64)
    if head == "qa_cls":
        return (video, ids, mask), {"labels": rng.integers(0, NUM_LABELS[head], size=B)}
    span = rng.integers(0, 2, size=(B, FRAMES[0]))
    weights = rng.uniform(0.5, 2.0, size=(B, FRAMES[0])).astype(np.float32)
    return (video, ids, mask), {"labels": rng.integers(0, N_CHOICE, size=B), "span_labels": span,
                                "span_label_weights": weights}


def _port_head(head):
    cfg = _config(LfVilaConfig)
    if head == "qa_mc":
        return LfVilaQAMultichoice(cfg)
    if head == "qa_cls":
        return LfVilaQAClassification(cfg, num_labels=NUM_LABELS[head])
    return LfVilaVideoClassification(cfg, num_labels=NUM_LABELS[head])


def _total(out):
    return out["loss"] + out.get("span_loss", 0.0)


@pytest.fixture(scope="module", params=["qa_mc", "qa_cls", "video_cls"])
def head(request):
    """(head, flax params, port head loaded from them, JAX outputs, JAX gradients)."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.lf_vila import tasks as jax_tasks
    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig

    name = request.param
    cfg = _config(JaxConfig)
    if name == "qa_mc":
        jax_head = jax_tasks.LfVilaQAMultichoice(cfg)
    elif name == "qa_cls":
        jax_head = jax_tasks.LfVilaQAClassification(cfg, num_labels=NUM_LABELS[name])
    else:
        jax_head = jax_tasks.LfVilaVideoClassification(cfg, num_labels=NUM_LABELS[name])
    args, kwargs = _inputs(name)
    args, kwargs = [jnp.asarray(a) for a in args], {k: jnp.asarray(v) for k, v in kwargs.items()}
    params = jax.jit(jax_head.init)(jax.random.PRNGKey(0), *args, **kwargs)["params"]
    params = _noisy(params, seed=3)

    def loss_fn(p):
        out = jax_head.apply({"params": p}, *args, **kwargs)
        return _total(out), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    port = _port_head(name)
    load_jax_params(port, {"params": params})
    return name, params, port.eval(), {k: np.asarray(v) for k, v in out.items()}, grads


def test_head_matches_jax(head):
    name, _, port, want, grads = head
    args, kwargs = _inputs(name)
    port.zero_grad()
    got = port(*(torch.from_numpy(a) for a in args), **{k: torch.from_numpy(v) for k, v in kwargs.items()})
    _total(got).backward()
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].detach().numpy(), value, atol=ATOL, rtol=0, err_msg=key)
    _assert_grads_match(port, grads)


def test_head_load_is_total(head):
    """The head holds exactly the flax tree: the QA heads reach BERT stage 2
    and its pooler (retrieval's model has neither, and takes no QA tree);
    video classification has no text encoder; an extra leaf raises."""
    name, params, port, *_ = head
    assert {n.split(".")[0] for n, _ in port.named_parameters()} == set(params)
    if name == "video_cls":
        assert "text_encoder" not in params
    else:
        assert "pooler" in params["text_encoder"] and "layer_5" in params["text_encoder"]["encoder"]
        with pytest.raises(KeyError, match="no port parameter"):
            load_jax_params(LfVilaRetrieval(_config(LfVilaConfig)), {"params": params})
    extra = dict(params, classifier=dict(params["classifier"], scale=np.ones(3, np.float32)))
    with pytest.raises(KeyError, match="classifier/scale"):
        load_jax_params(_port_head(name), {"params": extra})


def _fake_launch(q, k, v, bias, mask, out):
    out.copy_(wa.window_attention_plain(q, k, v, bias, mask))


@pytest.fixture()
def _ops_take_cpu_tensors():
    """The kernel branch's wiring runs on CPU tensors, its launch replaced by
    the plain version: the ``xpt::`` ops take the CPU for the test."""
    with xpt_ops_on_cpu():
        yield


def test_eval_forward_goes_through_the_kernel_gate(head, monkeypatch, _ops_take_cpu_tensors):
    """With the launch stood in for by the plain version on CPU tensors: one
    eval forward counts one window launch per gated block (the QA video is
    encoded once for all its choices) and gives the plain path's logits; a
    training step through the gate raises."""
    name, _, port, *_ = head
    args, kwargs = _inputs(name, seed=1)
    tensors = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        want = port(*tensors)["logits"]
    monkeypatch.setattr(swin3d, "window_attention", wa._launch)
    monkeypatch.setattr(wa._kernels, "window_attention_fwd", _fake_launch)
    monkeypatch.setattr(wa.window_attention, "launches", 0)
    with torch.inference_mode():
        got = port(*tensors)["logits"]
    assert wa.window_attention.launches == WINDOW_BLOCKS
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        port(*tensors, **{k: torch.from_numpy(v) for k, v in kwargs.items()})


TASK_ARGS = {
    "qa_mc": ["--task", "qa_mc", "--max_num_subtitle", "2"],
    "qa_cls_actnet": ["--task", "qa_cls", "--num_labels", "5"],
    "qa_cls_violin": ["--task", "qa_cls", "--qa_dataset", "violin", "--max_num_subtitle", "2"],
    "video_cls": ["--task", "video_cls", "--num_labels", "7"],
}


def _runner_args(tmp_path, task, steps, kernel=False):
    config = tmp_path / "tiny.json"
    video = dict(TINY_CONFIG["video_encoder"], use_pallas_attention=kernel)
    config.write_text(json.dumps(dict(TINY_CONFIG, video_encoder=video)))
    return ["--config", str(config), *TASK_ARGS[task], "--dummy_data", "1", "--input_hw", "96", "160",
            "--num_train_steps", str(steps), "--train_batch_size", "2", "--val_batch_size", "4", "--log_steps", "1",
            "--save_steps", "2", "--max_txt_len", "8", "--bf16", "0", "--device", "cpu",
            "--output_dir", str(tmp_path / "out")]


@pytest.mark.parametrize("task", sorted(TASK_ARGS))
def test_runner_task_writes_a_finite_final_report(tmp_path, monkeypatch, task):
    """2 train steps, then the accuracy eval over the (shrunk) synthetic val
    set: the report in ``final_report.json``, finite metrics in the log (the
    span loss in the total of ``qa_mc``)."""
    monkeypatch.setattr(run_tasks_lfvila, "DUMMY_SIZE", 6)
    report = run_tasks_lfvila.main(_runner_args(tmp_path, task, 2))
    out = tmp_path / "out"
    with open(out / "final_report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    assert report["n"] == 6 and 0.0 <= report["accuracy"] <= 1.0 and report["perf"]["clips_per_s"] > 0
    with open(out / "log" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    tags = {r["tag"] for r in rows}
    assert {"train/loss", "train/acc", "train/grad_norm"} <= tags
    assert ("train/span_loss" in tags) == (task == "qa_mc")
    assert all(np.isfinite(r["value"]) for r in rows)
    if task == "qa_mc":
        by = {r["tag"]: r["value"] for r in rows if r["step"] == 2}
        assert by["train/loss"] > by["train/span_loss"] > 0


def test_span_loss_is_optional_and_weighted(tmp_path, monkeypatch):
    """``--use_span_loss 0`` trains on the choice loss alone; the weight
    scales the span term in the total."""
    monkeypatch.setattr(run_tasks_lfvila, "DUMMY_SIZE", 4)
    losses = {}
    for flags in (["--use_span_loss", "0"], ["--span_loss_weight", "0"], ["--span_loss_weight", "3"]):
        out = tmp_path / "_".join(flags)
        run_tasks_lfvila.main(_runner_args(tmp_path, "qa_mc", 1)[:-1] + [str(out)] + flags)
        with open(out / "log" / "scalars.jsonl") as f:
            losses[flags[-1] + flags[0]] = {r["tag"]: r["value"] for r in map(json.loads, f)}
    off, zero, three = losses["0--use_span_loss"], losses["0--span_loss_weight"], losses["3--span_loss_weight"]
    assert "train/span_loss" not in off and off["train/loss"] == pytest.approx(zero["train/loss"], rel=1e-6)
    assert three["train/loss"] == pytest.approx(zero["train/loss"] + 3 * three["train/span_loss"], rel=1e-5)


def test_kernel_config_evaluates_each_task(tmp_path, monkeypatch):
    """The kernel config with no train step, as the card runs it: every
    task's eval takes the gate (plain on the CPU) and reports accuracy."""
    monkeypatch.setattr(run_tasks_lfvila, "DUMMY_SIZE", 4)
    for task in ("qa_mc", "qa_cls_actnet", "video_cls"):
        (tmp_path / task).mkdir()
        report = run_tasks_lfvila.main(_runner_args(tmp_path / task, task, 0, kernel=True))
        assert report["n"] == 4 and 0.0 <= report["accuracy"] <= 1.0


def test_qa_mc_defaults_fit_the_sentence_positions_and_num_options_sets_the_choices(tmp_path, monkeypatch):
    """qa_mc without ``--max_txt_len`` and ``--max_num_subtitle`` takes 50 x
    (2 + 6) tokens, which fits 512 positions; ``--num_options`` sets the
    choices of a synthetic sample. The other tasks keep the shared 70."""
    monkeypatch.setattr(run_tasks_lfvila, "DUMMY_SIZE", 3)
    args = _runner_args(tmp_path, "qa_mc", 1)
    for flag in ("--max_txt_len", "--max_num_subtitle"):
        del args[args.index(flag):args.index(flag) + 2]
    report = run_tasks_lfvila.main(args + ["--num_options", "3"])
    assert report["n"] == 3 and 0.0 <= report["accuracy"] <= 1.0
    with open(tmp_path / "out" / "log" / "args.json") as f:
        saved = json.load(f)
    assert (saved["max_txt_len"], saved["max_num_subtitle"], saved["num_options"]) == (50, 6, 3)
    cfg = ConfigDict(saved)
    _, collate, train_ds, _, _ = run_tasks_lfvila.build_task(
        cfg, run_tasks_lfvila.lfvila_config_from(cfg), build_model_tokenizer("hash", 512), "cpu")
    batch = collate([train_ds[0], train_ds[1]])
    assert batch["text_ids"].shape == (2, 3, 8, 50) and set(batch["labels"]) == {0, 1}
    args = _runner_args(tmp_path, "video_cls", 0)
    del args[args.index("--max_txt_len"):args.index("--max_txt_len") + 2]
    run_tasks_lfvila.main(args)
    with open(tmp_path / "out" / "log" / "args.json") as f:
        assert json.load(f)["max_txt_len"] == 70


def test_a_paragraph_longer_than_the_sentence_positions_raises(tmp_path, monkeypatch):
    """qa_mc at the shared default ``--max_txt_len 70`` with 6 subtitles:
    8 rows x 70 = 560 tokens > 512 sentence positions. flax's ``Embed``
    returns NaN rows there; the port raises, naming the flag."""
    from xpretrain_tpu_torch.models.bert import BertConfig
    from xpretrain_tpu_torch.models.lf_vila.pretrain import SentEmbedding

    emb = SentEmbedding(BertConfig(hidden_size=8, num_attention_heads=2, max_position_embeddings=16))
    emb(torch.zeros(1, 16, 8), torch.zeros(1, 16, dtype=torch.long))
    with pytest.raises(ValueError, match="max_txt_len"):
        emb(torch.zeros(1, 17, 8), torch.zeros(1, 17, dtype=torch.long))
    monkeypatch.setattr(run_tasks_lfvila, "DUMMY_SIZE", 4)
    args = _runner_args(tmp_path, "qa_mc", 0)
    args[args.index("--max_txt_len") + 1] = "70"
    args[args.index("--max_num_subtitle") + 1] = "6"
    with pytest.raises(ValueError, match="max_txt_len"):
        run_tasks_lfvila.main(args)
