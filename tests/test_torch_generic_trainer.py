"""The port's ``GenericTrainer`` (``xpretrain_tpu_torch/train/generic_trainer.py``)
on a one-layer model on the CPU: the step loop with its logging, the eval
callback and best-model tracking, checkpoints, and a resume that equals an
unbroken run."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu.config import ConfigDict  # noqa: E402
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer  # noqa: E402


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    while True:
        x = rng.normal(size=(8, 4)).astype(np.float32)
        yield {"x": x, "y": x @ np.array([1.0, -2.0, 0.5, 3.0], np.float32)}


def _apply(model, batch, generator):
    pred = model(batch["x"])[:, 0]
    return {"loss": ((pred - batch["y"]) ** 2).mean(), "acc": (pred - batch["y"]).abs().lt(0.5).float().mean()}


def _trainer(out_dir, steps, eval_fn=None):
    cfg = ConfigDict(output_dir=str(out_dir), num_train_steps=steps, learning_rate=0.05, decay="constant",
                     log_steps=1, valid_steps=2, save_steps=2, seed=3)
    model = torch.nn.Linear(4, 1)
    with torch.no_grad():
        model.weight.zero_()
        model.bias.zero_()
    return GenericTrainer(cfg, model, _apply, _batches(), eval_fn=eval_fn, metric_keys=("acc",), device="cpu")


def test_train_logs_validates_and_keeps_the_best(tmp_path):
    scores = iter([0.3, 0.7, 0.5])
    trainer = _trainer(tmp_path, 6, eval_fn=lambda model: {"score": next(scores)})
    state = trainer.train()
    assert state.step == 6
    rows = [json.loads(line) for line in open(tmp_path / "log" / "scalars.jsonl")]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    assert len(losses) == 6 and losses[-1] < losses[0]
    assert [r["value"] for r in rows if r["tag"] == "val/score"] == [0.3, 0.7, 0.5]
    assert any(r["tag"] == "train/acc" for r in rows)
    assert (trainer.best.best_step, trainer.best.best_score) == (4, 0.7)
    assert sorted((tmp_path / "ckpt").iterdir())[-1].name == "6.pt"


def test_resume_equals_an_unbroken_run(tmp_path):
    whole = _trainer(tmp_path / "whole", 4).train().model
    _trainer(tmp_path / "cut", 2).train()
    resumed = _trainer(tmp_path / "cut", 4).train()
    assert resumed.step == 4
    for a, b in zip(whole.parameters(), resumed.model.parameters()):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
