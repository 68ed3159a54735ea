"""HD-VILA stage 1 in the port: ``GenericTrainer`` over
``HdVilaPretrainModel`` as ``cli/run_pretrain_hdvila.py --stage 1
--dummy_data 1`` builds it from the port's
``configs/hdvila_pretrain_stage1.json``. Importing it registers the batch
schema ``hdvila_clips``."""

from __future__ import annotations

from benchmark.traffic import hdvila_clips  # noqa: F401  (registers the schema)
from benchmark.weights import load_into


def build_trainer(cfg: dict, params: dict, weights: dict, device: str, out_dir: str):
    """The trainer at the cell's batch, its parameters set to ``weights``;
    returns (trainer, state) as ``GenericTrainer.train`` starts them."""
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import METRIC_KEYS, HdVilaPretrainModel, hdvila_configs_from
    from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths
    from xpretrain_tpu_torch.parallel.train_step import TrainState
    from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer

    preset = {**cfg["preset"], "train_batch_size": params["batch"], "output_dir": out_dir,
              "steps_per_call": params.get("steps_per_call", 1)}
    enc_cfg, model_cfg = hdvila_configs_from(preset)
    model = HdVilaPretrainModel(enc_cfg, model_cfg, temp=model_cfg.temp, device=device)
    load_into(model, weights)

    def apply_fn(m, batch, generator):  # the runner's stage-1 apply
        return m(batch["img_middle"], batch["img_other"], batch["text_input_ids"], batch["text_input_mask"],
                 mlm_labels=None, itm_labels=None, generator=generator)

    trainer = GenericTrainer(preset, model, apply_fn, None, metric_keys=METRIC_KEYS,
                             param_paths=flax_param_paths(model), device=device)
    trainer.optimizer.sync_masters()
    return trainer, TrainState(step=0, model=model, optimizer=trainer.optimizer)
