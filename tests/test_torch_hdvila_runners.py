"""The port's HD-VILA runners (``xpretrain_tpu_torch/cli/{run_pretrain_hdvila,
run_retrieval_hdvila,run_video_qa_hdvila}.py``) on tiny configs on the CPU:
finite losses, the stage-2 freeze over a stage-1 e2e checkpoint, R@K, the QA
train -> inference round trip; their configs and the stage-2 batch fallback
against the JAX runner's; and, on an NVIDIA card only, the full-width
pretraining models on the card against the CPU.
"""

import dataclasses
import json
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_pretrain_hdvila, run_retrieval_hdvila, run_video_qa_hdvila  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths, hdvila_e2e_state_dict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"resnet_depth": 18, "hidden_size": 64, "timesformer_depth": 1, "timesformer_heads": 4, "bert": "tiny",
        "crop_size": [64, 128], "timesformer_hw": [1, 2], "pixel_random_sampling_size": 0}
COMMON = ["--dummy_data", "1", "--num_frm", "3", "--max_txt_len", "8", "--bf16", "0", "--device", "cpu",
          "--log_steps", "1", "--save_steps", "100"]
# stage 2's freeze list (the preset's, hdvila_pretrain_stage2.json) for the tiny BERT's stage 1 of 2 layers
FROZEN = ["encoder/cnn", "encoder/grid_encoder", "encoder/timesformer", "transformer/t_proj", "transformer/v_proj",
          "bert/embeddings", "pooler1", "layer_0/", "layer_1/"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def small_val(monkeypatch):
    """8 synthetic validation rows instead of 64."""
    monkeypatch.setattr(run_retrieval_hdvila, "DUMMY_VAL_ROWS", 8)
    monkeypatch.setattr(run_video_qa_hdvila, "DUMMY_VAL_ROWS", 8)


def _config(tmp_path, **extra) -> str:
    path = tmp_path / f"tiny_{len(extra)}_{'_'.join(map(str, extra.values()))}.json"
    path.write_text(json.dumps({**TINY, **extra}))
    return str(path)


def _scalars(out_dir) -> dict[str, list[float]]:
    tags: dict[str, list[float]] = {}
    with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
        for row in map(json.loads, f):
            tags.setdefault(row["tag"], []).append(row["value"])
    return tags


# -- configs ------------------------------------------------------------------


@pytest.mark.parametrize("stage", [1, 2])
def test_preset_copies_are_the_jax_presets(stage):
    """The port's JSON presets are the JAX package's, and both runners build
    the same encoder and model configs from them."""
    import jax.numpy as jnp

    from xpretrain_tpu.cli.run_pretrain_hdvila import hdvila_configs_from as jax_configs_from
    from xpretrain_tpu.config import ConfigDict as JaxConfigDict
    from xpretrain_tpu_torch.config import ConfigDict

    name = f"hdvila_pretrain_stage{stage}.json"
    with open(os.path.join(REPO, "xpretrain_tpu_torch", "configs", name)) as f:
        mine = json.load(f)
    with open(os.path.join(REPO, "xpretrain_tpu", "configs", "presets", name)) as f:
        assert mine == json.load(f)
    got = run_pretrain_hdvila.hdvila_configs_from(ConfigDict(mine))
    want = jax_configs_from(JaxConfigDict(mine))
    dtypes = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    for g, w in zip(got, want):
        for field in dataclasses.fields(g):
            a, b = getattr(g, field.name), getattr(w, field.name)
            if field.name == "dtype":
                assert dtypes[a] == b
            elif field.name == "bert":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, field.name
    assert got[1].bert.hidden_size == got[0].hidden_size == 1024 and got[1].stage == stage


FALLBACK_CFGS = [
    dict(stage=2, train_batch_size=16),
    dict(stage=2, train_batch_size=32),
    dict(stage=2, train_batch_size=16, gradient_accumulation_steps=2),
    dict(stage=2, train_batch_size=16, stage2_b16_fallback=0),
    dict(stage=2, train_batch_size=12),
    dict(stage=1, train_batch_size=32),
    dict(stage=2, train_batch_size=8),
]


@pytest.mark.parametrize("backend", ["cpu", "gpu", "cuda", "tpu"])
def test_stage2_batch_fallback_matches_jax(backend):
    """A pure function of (cfg, backend): it rewrites on ``tpu`` only, as
    JAX's (``tests/test_hdvila_runner_fallback.py``)."""
    from xpretrain_tpu.cli.run_pretrain_hdvila import apply_stage2_batch_fallback as jax_fallback

    for cfg in FALLBACK_CFGS:
        got = run_pretrain_hdvila.apply_stage2_batch_fallback(dict(cfg), backend)
        assert got == jax_fallback(dict(cfg), backend), cfg
        assert (got != cfg) == (backend == "tpu" and cfg in FALLBACK_CFGS[:2])


@pytest.mark.parametrize("runner", [run_pretrain_hdvila, run_retrieval_hdvila, run_video_qa_hdvila],
                         ids=["pretrain", "retrieval", "video_qa"])
def test_runners_raise_without_a_card(tmp_path, runner, monkeypatch):
    """``--device cuda`` is the default, and without a card it raises
    instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.main(["--config", _config(tmp_path), "--dummy_data", "1", "--output_dir", str(tmp_path / "out")])


# -- the runners on the CPU ------------------------------------------------------


def test_pretraining_stage1_then_stage2_from_its_e2e_checkpoint(tmp_path):
    """Stage 1 takes 2 steps; its model, written as a reference HDVILA
    checkpoint, starts stage 2 (``--e2e_weights_path``), which takes 2
    steps of MLM + ITM under lse with pixel sampling: every frozen
    parameter is stage 1's, bit for bit, and every other one moved."""
    s1 = run_pretrain_hdvila.main(["--config", _config(tmp_path), *COMMON, "--stage", "1", "--train_n_clips", "2",
                                   "--train_batch_size", "4", "--num_train_steps", "2",
                                   "--output_dir", str(tmp_path / "s1")])
    tags = _scalars(tmp_path / "s1")
    for key in ("loss", "itc_loss", "grad_norm"):
        assert len(tags[f"train/{key}"]) == 2 and all(map(math.isfinite, tags[f"train/{key}"])), key
    assert tags["train/loss"] == tags["train/itc_loss"]
    ckpt = str(tmp_path / "stage1_e2e.pt")
    torch.save(hdvila_e2e_state_dict(s1.model), ckpt)
    stage1 = {k: v.detach().clone() for k, v in s1.model.state_dict().items()}

    cfg2 = _config(tmp_path, pixel_random_sampling_size=1, score_agg_func="lse", timesformer_hw=[1, 2])
    s2 = run_pretrain_hdvila.main(["--config", cfg2, *COMMON, "--stage", "2", "--train_n_clips", "2",
                                   "--train_batch_size", "4", "--num_train_steps", "2", "--e2e_weights_path", ckpt,
                                   "--frozen_patterns", *FROZEN, "--output_dir", str(tmp_path / "s2")])
    tags = _scalars(tmp_path / "s2")
    for key in ("loss", "mlm_loss", "itm_loss", "mlm_acc", "itm_acc", "grad_norm"):
        assert len(tags[f"train/{key}"]) == 2 and all(map(math.isfinite, tags[f"train/{key}"])), key
    paths = flax_param_paths(s2.model)
    # the runner's seeded init (--seed 42), which the stage-2-only modules keep until they train
    fresh = dict(run_pretrain_hdvila.HdVilaPretrainModel(*run_pretrain_hdvila.hdvila_configs_from(
        {**TINY, "stage": 2, "bf16": 0, "num_frm": 3})).init_weights(torch.Generator().manual_seed(42))
        .named_parameters())
    frozen = {n for n, _ in s2.model.named_parameters() if any(p in paths[n] for p in FROZEN)}
    assert frozen == set(stage1)  # the whole stage-1 model, and nothing else
    for name, p in s2.model.named_parameters():
        if name in frozen:
            assert torch.equal(p, stage1[name]), name
        else:
            assert not torch.equal(p, fresh[name]), name


def test_retrieval_runner_trains_evaluates_and_reranks(tmp_path, small_val):
    """ITC fine-tune (2 steps, then R@K), ``--mode eval``, and ``--loss_type
    rank`` (2 steps of the margin loss over rolled negatives; ``num_negs``
    >= the batch raises)."""
    cfg = _config(tmp_path)
    common = ["--config", cfg, *COMMON, "--train_n_clips", "1", "--val_batch_size", "4"]
    report = run_retrieval_hdvila.main([*common, "--train_batch_size", "4", "--num_train_steps", "2",
                                        "--output_dir", str(tmp_path / "itc")])
    assert all(0.0 <= report["t2v"][k] <= 100.0 for k in ("R1", "R5", "R10"))
    assert (tmp_path / "itc" / "final_report.json").exists()
    assert all(map(math.isfinite, _scalars(tmp_path / "itc")["train/loss"]))
    report = run_retrieval_hdvila.main([*common, "--mode", "eval", "--output_dir", str(tmp_path / "eval")])
    assert (tmp_path / "eval" / "eval_report.json").exists() and math.isfinite(report["t2v"]["R1"])
    run_retrieval_hdvila.main([*common, "--loss_type", "rank", "--num_negs", "2", "--train_batch_size", "4",
                               "--num_train_steps", "2", "--output_dir", str(tmp_path / "rank")])
    tags = _scalars(tmp_path / "rank")
    assert len(tags["train/rank_loss"]) == 2 and tags["train/rank_loss"] == tags["train/loss"]
    assert all(0.0 <= v <= 1.2 for v in tags["train/rank_loss"])  # mean(relu(0.2 + neg - pos)), sigmoid scores
    with pytest.raises(ValueError, match="num_negs < batch size"):
        run_retrieval_hdvila.main([*common, "--loss_type", "rank", "--num_negs", "4", "--train_batch_size", "4",
                                   "--num_train_steps", "1", "--output_dir", str(tmp_path / "rank_bad")])


def test_rerank_loss_is_the_margin_over_rolled_captions():
    """The rank loss is ``mean(relu(margin + neg - pos))`` over sigmoid
    fusion scores, the negatives the captions rolled by 1..num_negs."""
    enc, model = run_pretrain_hdvila.hdvila_configs_from({**TINY, "bf16": 0, "num_frm": 3})
    net = run_retrieval_hdvila.HdVilaRerankModel(enc, model, num_negs=2, margin=0.3).init_weights(
        torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    mid = torch.from_numpy(rng.integers(0, 256, size=(3, 1, 3, 64, 128)).astype(np.uint8))
    oth = torch.from_numpy(rng.integers(0, 256, size=(3, 1, 2, 3, 16, 32)).astype(np.uint8))
    ids = torch.from_numpy(rng.integers(2, 1000, size=(3, 6)))
    mask = torch.ones(3, 6, dtype=torch.long)
    out = net(mid, oth, ids, mask, with_rank_loss=True)
    scores = torch.stack([torch.sigmoid(net(mid, oth, torch.roll(ids, s, 0), mask)["logits"].float())
                          for s in range(3)], dim=1)  # [video, 1 + num_negs]
    want = torch.clamp(0.3 + scores[:, 1:] - scores[:, :1], min=0).mean()
    torch.testing.assert_close(out["rank_loss"], want, atol=1e-6, rtol=1e-5)


def test_video_qa_runner_trains_and_infers(tmp_path, small_val):
    """Multiple choice: 2 steps with validation (a best checkpoint), then
    ``--mode inference`` on the run restores its args and that checkpoint;
    open-ended classification and TGIF count train a step each."""
    cfg = _config(tmp_path)
    common = ["--config", cfg, *COMMON, "--train_n_clips", "1", "--train_batch_size", "4", "--val_batch_size", "4"]
    out = str(tmp_path / "mc")
    report = run_video_qa_hdvila.main([*common, "--task_type", "mc", "--num_options", "3", "--num_train_steps", "2",
                                       "--valid_steps", "2", "--inference_n_clips", "2", "--output_dir", out])
    assert 0.0 <= report["accuracy"] <= 1.0 and report["n"] == 8
    assert len(report["qa_results"]) == 8 and report["qa_results"][0]["question_id"] == 1000
    assert all(map(math.isfinite, _scalars(out)["train/loss"]))
    assert os.listdir(os.path.join(out, "best"))
    again = run_video_qa_hdvila.main(["--mode", "inference", "--device", "cpu", "--output_dir", out])
    assert 0.0 <= again["accuracy"] <= 1.0 and (tmp_path / "mc" / "inference_report.json").exists()
    for task, extra in (("open", ["--num_labels", "4"]), ("count", [])):
        report = run_video_qa_hdvila.main([*common, "--task_type", task, *extra, "--num_train_steps", "1",
                                           "--output_dir", str(tmp_path / task)])
        assert 0.0 <= report["accuracy"] <= 1.0
        assert all(map(math.isfinite, _scalars(tmp_path / task)["train/loss"]))


# -- on the card -------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("stage", [1, 2])
def test_full_width_model_on_card_matches_cpu(stage):
    """The stage's pretraining model at the presets' widths (ResNet-50 x 2,
    TimeSformer 4 x 16 heads at 1024, BERT-large), fp32, one clip of
    640x1024 at batch 2: the loss on the card within 1e-5 of the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(REPO, "xpretrain_tpu_torch", "configs", f"hdvila_pretrain_stage{stage}.json")) as f:
        preset = {**json.load(f), "bf16": 0}
    cpu = run_pretrain_hdvila.HdVilaPretrainModel(*run_pretrain_hdvila.hdvila_configs_from(preset)).init_weights(
        torch.Generator().manual_seed(stage)).eval()
    gpu = run_pretrain_hdvila.HdVilaPretrainModel(*run_pretrain_hdvila.hdvila_configs_from(preset),
                                                  device="cuda").eval()
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(stage)
    batch = [rng.integers(0, 256, size=(2, 1, 3, 640, 1024)).astype(np.uint8),
             rng.integers(0, 256, size=(2, 1, 6, 3, 160, 256)).astype(np.uint8),
             rng.integers(2, 30000, size=(2, 20)), np.ones((2, 20), np.int64)]
    labels = np.where(rng.random((2, 20)) < 0.3, rng.integers(2, 30000, size=(2, 20)), -100)
    with torch.no_grad():
        losses = [model(*(torch.from_numpy(a).to(dev) for a in batch),
                        mlm_labels=None if stage == 1 else torch.from_numpy(labels).to(dev))["loss"].item()
                  for model, dev in ((cpu, "cpu"), (gpu, "cuda"))]
    assert abs(losses[0] - losses[1]) <= 1e-5, losses
