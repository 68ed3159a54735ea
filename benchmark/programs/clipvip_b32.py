"""CLIP-ViP B/32 in the port: ``ClipVipTrainer`` built from the MSR-VTT
fine-tune preset, as ``cli/run_retrieval_clipvip.py`` builds it."""

from __future__ import annotations

from benchmark.weights import load_into


def build_trainer(cfg: dict, params: dict, weights: dict, device: str, out_dir: str):
    """The trainer at the cell's batch, its parameters set to ``weights``;
    returns (trainer, state) as ``ClipVipTrainer.train`` starts them."""
    from xpretrain_tpu_torch.parallel.train_step import TrainState
    from xpretrain_tpu_torch.train.trainer import ClipVipTrainer

    preset = {**cfg["preset"], "train_batch_size": params["batch"], "output_dir": out_dir,
              "steps_per_call": params.get("steps_per_call", 1)}
    trainer = ClipVipTrainer(preset, train_loader=None, device=device)
    load_into(trainer.model, weights)
    trainer.optimizer.sync_masters()
    return trainer, TrainState(step=0, model=trainer.model, optimizer=trainer.optimizer)
