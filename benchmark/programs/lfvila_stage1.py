"""LF-VILA stage 1 in the port: ``GenericTrainer`` over ``LfVilaPretrain``
as ``cli/run_pretrain_lfvila.py`` builds it (``--dummy_data 1
--device_ingest 1``, window kernel off), and ``LfVilaTowers`` over
``LfVilaRetrieval`` with the window kernel on (the port's
``configs/lfvila_stage1_window_kernel.json``)."""

from __future__ import annotations

import numpy as np

from benchmark.weights import load_into


def build_trainer(cfg: dict, params: dict, weights: dict, device: str, out_dir: str):
    from xpretrain_tpu_torch.cli.run_pretrain_lfvila import METRIC_KEYS, lfvila_config_from
    from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaPretrain
    from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA
    from xpretrain_tpu_torch.parallel.train_step import TrainState
    from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer

    preset = {**cfg["preset"]["train"], "train_batch_size": params["batch"], "output_dir": out_dir,
              "steps_per_call": params.get("steps_per_call", 1)}
    model_cfg = lfvila_config_from(preset)
    model = LfVilaPretrain(model_cfg, device=device)
    load_into(model, weights)

    def apply_fn(m, batch, generator):  # the runner's stage-1 apply
        return m(batch["video_frames"], batch["text_ids"], batch["attention_mask"], mlm_labels=None,
                 generator=generator)

    trainer = GenericTrainer(preset, model, apply_fn, None, metric_keys=METRIC_KEYS,
                             no_decay_patterns=NO_DECAY_LFVILA, param_paths=flax_param_paths(model), device=device)
    trainer.optimizer.sync_masters()
    return trainer, TrainState(step=0, model=model, optimizer=trainer.optimizer)


def build_towers(cfg: dict, params: dict, weights: dict, device: str):
    from xpretrain_tpu_torch.cli.run_pretrain_lfvila import lfvila_config_from
    from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval
    from xpretrain_tpu_torch.serving.towers import LfVilaTowers

    model = LfVilaRetrieval(lfvila_config_from(cfg["preset"]["serve"]), device=device)
    load_into(model, weights)
    return LfVilaTowers(model, device)


def serve(towers, batch: dict[str, np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    v = towers.encode_video(batch["video_frames"])
    t = towers.encode_text(batch["text_ids"], batch["attention_mask"])
    return v.float().cpu().numpy(), t.float().cpu().numpy()


def lower_precision():
    """The program's own path below the stated bf16: int8 serving (w8a8)."""
    from xpretrain_tpu_torch.ops.quant import int8_serving

    return int8_serving()
