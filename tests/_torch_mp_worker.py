"""One rank of the port's data-parallel CPU tests (run as a subprocess).

``python _torch_mp_worker.py <out_dir> <store_file> <scenario>...`` joins the
gloo group that ``RANK`` / ``WORLD_SIZE`` describe through the ``file://``
store, runs each scenario and writes ``<out_dir>/<scenario>_<rank>.json``
(and ``.pt`` files where a scenario keeps tensors). The launching test
(``test_torch_data_parallel.py``) runs it at 1, 2 and 4 ranks and compares
the results. It imports nothing of JAX: the JAX parameters of the CLIP-ViP
case come from ``clipvip_params.npz`` beside ``<out_dir>``, written by the test.

Scenarios:
- ``clipvip``: ``tests/_mp_worker.py``'s tiny CLIP-ViP through
  ``ClipVipTrainer``: global batch 16 over the ranks' loaders, 3 steps of
  NCELearnableTempLoss with ZeRO-2 at min_size 64, then the 22-row eval at
  global batch 8; records each step's ``logit_scale`` metric beside the
  parameter its forward read.
- ``clipvip_bf16``: the same at ``param_dtype`` bf16 (fp32 masters), saving
  a checkpoint at step 2; records its step-3 loss, its final parameters and
  optimizer state, and the per-leaf sizes of each rank's state.
- ``lfvila1`` / ``lfvila2`` / ``hdvila1``: tiny LF-VILA stages 1 and 2
  (explicit MTC clips, dropout off) and HD-VILA stage 1 through
  ``GenericTrainer`` on contiguous blocks of fixed global batches.
- ``units``: the sample-mixing sites against their one-process math on the
  global batch: the VTM roll's exchange, the global MLM mean, the
  contrastive and MTC losses with their averaged gradients, HD-VILA's
  rolled captions, and the per-rank dropout draws.

The model-axis scenarios (``test_torch_model_parallel.py``,
``test_torch_context_parallel.py``) each form their mesh from the group's:
- ``clipvip_tp`` / ``clipvip_zero3`` / ``clipvip_zero3_tp``: the CLIP-ViP
  case at ``--tp 2`` on a (2, 2) mesh, ``--zero3 1`` on (4,) and both on
  (2, 2), JAX's TP step set-up (cosine 1e-3 over 100 steps, weight decay
  0.1, min_size 64), 2 steps; the last saves a checkpoint at step 1. Each
  records its losses, its final (gathered) parameters and its shard sizes.
- ``units_mp``: on a (2, 2) mesh, the rows each rank's loader reads and the
  dropout mask each rank draws.
- ``lfvila1_tp`` / ``hdvila1_tp``: the family cases at ``--tp 2`` on (2, 2);
  ``lfvila1_cp`` / ``lfvila1_tpcp``: LF-VILA's at ``--cp 2`` and at ``--tp 2
  --cp 2`` on (2, 2).
- ``swin_cp``: JAX's tiny context-parallel Swin3D at cp = the world size:
  the forward (global and local branch, from JAX's parameters in
  ``swin_cp.npz`` beside ``<out_dir>``) and one backward's gradients
  against the one-process port.
- ``lfvila_runner_cp``: ``run_pretrain_lfvila`` at ``--cp 2`` on 2 ranks, or
  at ``--cp 1`` on 1.

``seq_pipe_expert`` (``test_torch_seq_pipe_expert.py``, 4 ranks) forms a
mesh per case (``mesh.create_mesh``) from the inputs in
``seq_pipe_expert.npz`` beside ``<out_dir>`` and writes each rank's results
to ``<case>_<rank>.npz``: ring attention on (4,) ``seq`` and on (2, 2)
``(data, seq)``, with and without a mask (the rank's output block and the
gradients of its share of a mean-squared loss); the BERT pipeline on (4,)
``pipe`` at 4 and 8 microbatches and on (2, 2) ``(data, pipe)`` at 2 (the
output and the stage's gradients of the global loss, averaged over the data
group); the MoE FFN on (2, 2) ``(data, expert)``, top-1 and top-2 with
tokens dropped (the rank's output rows, ``aux``, the averaged gradients of
its leaves, and the checkpoint in the reference layout). Around the cases
it records the run's mesh (``run_mesh_<rank>.npz``): ``create_mesh`` must
leave the current mesh and its global-batch ``gather_rows`` as they were.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from xpretrain_tpu_torch.config import ConfigDict  # noqa: E402
from xpretrain_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

GLOBAL_BATCH, STEPS, VAL_ROWS, VAL_BATCH = 16, 3, 22, 8
PARAMS = {"file": "", "swin": "", "spe": ""}  # the JAX parameters and inputs of the cases (main sets them)
OPT = dict(learning_rate=1e-4, decay="constant", warmup_ratio=0.0, weight_decay=0.01, grad_norm=5.0, seed=0,
           validate_at_start=0, valid_steps=100, log_steps=1)
ZERO2_MIN_SIZE = 64  # JAX's test's min_size: the tiny models' leaves of 64 elements or more are sharded


def _zero2(trainer):
    """ZeRO-2 over the group at the tests' ``min_size`` (the trainers' is
    JAX's default, 16384)."""
    from xpretrain_tpu_torch.optim.optimizer import zero2_shard

    trainer.optimizer = zero2_shard(trainer.optimizer, min_size=ZERO2_MIN_SIZE)
    return trainer


def _record(trainer) -> list:
    """Wrap ``trainer.train_step`` to keep each step's metrics as floats."""
    rows = []
    step = trainer.train_step

    def recorded(state, batch, seed):
        state, metrics = step(state, batch, seed)
        rows.append({k: float(v) for k, v in metrics.items()})
        return state, metrics

    trainer.train_step = recorded
    return rows


def _clipvip_config():
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPTextConfig, CLIPVipConfig, CLIPVisionConfig, VipConfig

    return CLIPVipConfig(
        text=CLIPTextConfig(vocab_size=49408, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, max_position_embeddings=16),
        vision=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                image_size=32, patch_size=16),
        vip=VipConfig(temporal_size=2, add_cls_num=2), projection_dim=16)


class _Transformed:
    """``_mp_worker.py``'s synthetic clips with the CLIP transform."""

    def __init__(self, size, seed):
        from xpretrain_tpu_torch.data.datasets import SyntheticVideoTextDataset

        self.ds = SyntheticVideoTextDataset(size=size, num_frames=2, image_size=32, seed=seed)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        from xpretrain_tpu_torch.data.transforms import clip_transform

        item = self.ds[i]
        item["video"] = clip_transform(item["frames"], 32)
        return item


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, value in flat.items():
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def _clipvip_trainer(out_dir: str, params_file: str = "", **cfg):
    from xpretrain_tpu_torch.data.datasets import RetrievalCollator
    from xpretrain_tpu_torch.data.loader import BatchLoader, SequentialEvalLoader
    from xpretrain_tpu_torch.data.tokenization import HashTokenizer
    from xpretrain_tpu_torch.train.trainer import ClipVipTrainer

    pi, pc = mesh_lib.process_index_count()
    collate = RetrievalCollator(HashTokenizer(), max_txt_len=16)
    train = BatchLoader(_Transformed(48, seed=0), GLOBAL_BATCH // pc, collate, seed=0, process_index=pi,
                        process_count=pc)
    val = SequentialEvalLoader(_Transformed(VAL_ROWS, seed=7), VAL_BATCH // pc, collate, process_index=pi,
                               process_count=pc)
    with np.load(params_file or PARAMS["file"]) as f:
        params = _unflatten({k: f[k] for k in f.files})
    opt = dict(OPT, learning_rate=1e-3, weight_decay=0.0, grad_norm=2.0, num_train_steps=STEPS,
               save_steps=100, loss_name="NCELearnableTempLoss", bf16=0)
    opt.update(cfg)
    trainer = ClipVipTrainer(ConfigDict(output_dir=out_dir, **opt), train, val, val.valid_len,
                             model_cfg=_clipvip_config(), init_params=params, device="cpu")
    return _zero2(trainer)


def clipvip(out_dir: str) -> dict:
    trainer = _clipvip_trainer(out_dir)
    rows = _record(trainer)
    forward_scales = []  # the logit_scale parameter as each step's forward reads it
    step = trainer.train_step

    def before_step(state, batch, seed):
        forward_scales.append(float(torch.clamp(state.model.logit_scale.detach(), 0.0, 5.2983)))
        return step(state, batch, seed)

    trainer.train_step = before_step
    trainer.train()
    report = trainer.validate()
    return {"losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
            "logit_scale_metrics": [r["logit_scale"] for r in rows], "forward_logit_scales": forward_scales,
            "logit_scale": float(trainer.model.logit_scale.detach().reshape(-1)[0]),
            "t2v": report["t2v"], "v2t": report["v2t"], "t2v_dsl": report["t2v_dsl"]}


def clipvip_bf16(out_dir: str) -> dict:
    """3 steps at bf16 storage, a checkpoint at step 2; per-leaf state sizes."""
    trainer = _clipvip_trainer(out_dir, param_dtype="bf16", save_steps=2)
    rows = _record(trainer)
    trainer.train()
    opt = trainer.optimizer
    sizes = {}
    for i, name in enumerate(opt.names):
        master = opt.targets[i].numel() if i in opt.masters else 0
        sizes[name] = [opt.mu[i].numel(), opt.nu[i].numel(), master, opt.params[i].numel(), i in opt.shards]
    state = opt.state_dict()  # a collective: every rank gathers
    if mesh_lib.is_main_process():
        torch.save({"model": trainer.model.state_dict(), "optimizer": state},
                   os.path.join(out_dir, "final.pt"))
    state = opt.mu + opt.nu + opt.acc + [opt.targets[i] for i in opt.masters]
    return {"losses": [r["loss"] for r in rows], "sizes": sizes,
            "state_bytes": sum(t.numel() * t.element_size() for t in state)}


def _lfvila(stage: int, cp: bool = False):
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig, LfVilaPretrain
    from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig

    base = LfVilaConfig.tiny(stage=stage, sample_frame=8, final_num_patches=1)
    cfg = dataclasses.replace(
        base, video=Swin3DConfig.tiny(drop_path_rate=0.0, context_parallel_axis="model" if cp else None),
        bert=dataclasses.replace(base.bert, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    model = LfVilaPretrain(cfg).init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(stage)
    B, M, L = 4, 4, 8
    batches = []
    for _ in range(2):
        mask = (np.arange(L)[None, None] < rng.integers(2, L + 1, size=(B, M, 1))).astype(np.int64)
        batches.append({
            "video_frames": rng.normal(size=(B, 3, 8, 96, 160)).astype(np.float32),
            "text_ids": rng.integers(1, 1000, size=(B, M, L)),
            "attention_mask": mask,
            "mlm_labels": np.where(rng.random((B, M * L)) < 0.3, rng.integers(1, 1000, size=(B, M * L)), -100),
            "mtc_key": np.stack([rng.permutation(M)[:2] for _ in range(B)]),
            "mtc_value": np.stack([rng.permutation(M)[:2] for _ in range(B)]),
            "mtc_other": rng.integers(0, M, size=B),
        })

    def apply_fn(m, b, generator):
        return m(b["video_frames"], b["text_ids"], b["attention_mask"],
                 mlm_labels=b["mlm_labels"] if stage == 2 else None, generator=generator,
                 mtc_indices=(b["mtc_key"], b["mtc_value"], b["mtc_other"]))

    keys = ("ct_global_loss", "ct_time_loss", "mlm_loss", "vtm_loss", "mlm_acc", "vtm_acc")
    return model, apply_fn, batches, keys


def _hdvila():
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel
    from xpretrain_tpu_torch.models.bert import BertConfig
    from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoderConfig
    from xpretrain_tpu_torch.models.hd_vila.modeling import HdVilaModelConfig

    bert = BertConfig(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, intermediate_size=128,
                      stage_bounds=(2,), vocab_size=1000, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    model = HdVilaPretrainModel(HdVilaEncoderConfig.tiny(timesformer_frames=3, timesformer_hw=(1, 2)),
                                HdVilaModelConfig.tiny(stage=1, bert=bert, pixel_random_sampling_size=0))
    model.init_weights(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(11)
    B, L = 8, 10
    batches = [{
        "img_middle": rng.integers(0, 256, size=(B, 1, 3, 64, 128)).astype(np.uint8),
        "img_other": rng.integers(0, 256, size=(B, 1, 2, 3, 16, 32)).astype(np.uint8),
        "text_input_ids": rng.integers(2, 1000, size=(B, L)),
        "text_input_mask": (np.arange(L) < rng.integers(3, L + 1, size=(B, 1))).astype(np.int64),
    } for _ in range(2)]

    def apply_fn(m, b, generator):
        return m(b["img_middle"], b["img_other"], b["text_input_ids"], b["text_input_mask"], generator=generator)

    return model, apply_fn, batches, ("itc_loss",)


def _generic(out_dir: str, model, apply_fn, batches, keys, **cfg) -> dict:
    """Two steps of ``GenericTrainer`` on this rank's blocks of ``batches``
    (its data index's: the ranks of a model group take the same blocks)."""
    from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer

    mesh = mesh_lib.current_mesh()
    n, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    mine = [{k: v[rank * (len(v) // n):(rank + 1) * (len(v) // n)] for k, v in b.items()} for b in batches]
    trainer = _zero2(GenericTrainer(ConfigDict(output_dir=out_dir, num_train_steps=len(batches), save_steps=100,
                                               **OPT, **cfg), model, apply_fn, iter(mine), metric_keys=keys,
                                    device="cpu"))
    rows = _record(trainer)
    trainer.train()
    state = trainer.model.state_dict()  # gathered under a layout: every rank calls it
    if mesh_lib.is_main_process():
        torch.save(state, os.path.join(out_dir, "final.pt"))
    return {"metrics": rows, "shards": _shards(trainer)}


def lfvila1(out_dir: str) -> dict:
    return _generic(out_dir, *_lfvila(1))


def lfvila2(out_dir: str) -> dict:
    return _generic(out_dir, *_lfvila(2))


def hdvila1(out_dir: str) -> dict:
    return _generic(out_dir, *_hdvila())


def units(out_dir: str) -> dict:
    """Each site under the group against its one-process math on the global
    batch, computed here from the same seeded inputs; returns the largest
    differences."""
    from xpretrain_tpu_torch.cli.run_retrieval_hdvila import rolled_captions
    from xpretrain_tpu_torch.models.common import dropout
    from xpretrain_tpu_torch.models.lf_vila.pretrain import shuffle_embd_for_vtm
    from xpretrain_tpu_torch.ops import losses
    from xpretrain_tpu_torch.parallel.train_step import _seed

    mesh = mesh_lib.current_mesh()
    n, rank = mesh.world_size, mesh.rank
    b = 2
    B = n * b
    block = slice(rank * b, (rank + 1) * b)
    out = {}

    # the VTM roll: values, labels and the gradient through the exchange
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, 3, 5, generator=g, dtype=torch.float64)
    w = torch.randn(B, 3, 5, generator=g, dtype=torch.float64)
    mine = x[block].clone().requires_grad_(True)
    rolled, labels = shuffle_embd_for_vtm(mine)
    (rolled * w[block]).sum().backward()
    ref_x = x.clone().requires_grad_(True)
    ref = torch.cat([torch.roll(ref_x[:B // 2], 1, dims=0), ref_x[B // 2:]])
    (ref * w).sum().backward()
    ref_labels = (torch.arange(B) >= B // 2).long()
    out["vtm"] = float((rolled - ref[block]).abs().max())
    out["vtm_labels"] = bool(torch.equal(labels, ref_labels[block]))
    out["vtm_grad"] = float((mine.grad - ref_x.grad[block]).abs().max())

    # the global MLM mean with unequal masked counts per rank, through a
    # shared linear layer whose averaged gradient is the global one
    V, T = 7, 6
    theta0 = torch.randn(4, V, generator=g, dtype=torch.float64)
    feats = torch.randn(B, T, 4, generator=g, dtype=torch.float64)
    lab = torch.randint(0, V, (B, T), generator=g)
    counts = torch.arange(B) % T + 1  # row i masks its first counts[i] tokens, so the ranks differ
    lab = torch.where(torch.arange(T)[None] < counts[:, None], lab, torch.full_like(lab, -100))
    theta = theta0.clone().requires_grad_(True)
    loss = losses.mlm_loss(feats[block] @ theta, lab[block])
    loss.backward()
    grad = theta.grad.clone()
    mesh_lib.all_reduce_mean_([grad])
    mean_loss = mesh_lib.all_reduce_sum(loss.detach()) / n
    with _no_group():
        ref_theta = theta0.clone().requires_grad_(True)
        ref_loss = losses.mlm_loss(feats @ ref_theta, lab)
        ref_loss.backward()
    out["mlm_counts"] = int(lab[block].ne(-100).sum())
    out["mlm_loss"] = float(abs(mean_loss - ref_loss))
    out["mlm_grad"] = float((grad - ref_theta.grad).abs().max())

    # the contrastive registry loss and MTC (its rolled negatives cross
    # ranks), each on features from a shared layer
    C, Mc = 8, 4
    theta0 = torch.randn(C, C, generator=g, dtype=torch.float64)
    vis, txt = torch.randn(B, C, generator=g, dtype=torch.float64), torch.randn(B, C, generator=g, dtype=torch.float64)
    vloc, tloc = torch.randn(B, Mc, C, generator=g, dtype=torch.float64), torch.randn(B, Mc, C, generator=g,
                                                                                      dtype=torch.float64)
    idx = (torch.stack([torch.randperm(Mc, generator=g)[:2] for _ in range(B)]),
           torch.stack([torch.randperm(Mc, generator=g)[:2] for _ in range(B)]),
           torch.randint(0, Mc, (B,), generator=g))
    nce = losses.build_loss_fn("NCELearnableTempLoss")
    scale = torch.tensor(2.0, dtype=torch.float64)

    def both(th, rows, ids):
        norm = torch.nn.functional.normalize
        return (nce(norm(vis[rows] @ th, dim=-1), norm(txt[rows] @ th, dim=-1), scale)
                + losses.mtc_loss(norm(vloc[rows] @ th, dim=-1), norm(tloc[rows] @ th, dim=-1), indices=ids))

    theta = theta0.clone().requires_grad_(True)
    loss = both(theta, block, tuple(t[block] for t in idx))
    loss.backward()
    grad = theta.grad.clone()
    mesh_lib.all_reduce_mean_([grad])
    losses_all = mesh_lib.gather_rows(loss.detach()[None])
    with _no_group():
        ref_theta = theta0.clone().requires_grad_(True)
        ref_loss = both(ref_theta, slice(None), idx)
        ref_loss.backward()
    out["contrastive_loss"] = float((losses_all - ref_loss).abs().max())
    out["contrastive_grad"] = float((grad - ref_theta.grad).abs().max())

    # HD-VILA's rolled captions over the global batch
    ids = torch.arange(B * 3).reshape(B, 3)
    got_ids, got_mask = rolled_captions(ids[block], ids[block] % 2, 3)
    want = torch.cat([ids[block]] + [torch.roll(ids, s, 0)[block] for s in (1, 2, 3)])
    out["rerank_ids"] = bool(torch.equal(got_ids, want) and torch.equal(got_mask, want % 2))

    # per-rank draws: the step generator of each rank, and rank 0's is the
    # one a process without a group draws
    keep = dropout(torch.ones(64), 0.5, torch.Generator().manual_seed(_seed(123))) > 0
    masks = mesh_lib.gather_rows(keep[None].long())
    out["draws_distinct"] = len({tuple(m.tolist()) for m in masks}) == n
    with _no_group():
        alone = dropout(torch.ones(64), 0.5, torch.Generator().manual_seed(_seed(123))) > 0
    out["rank0_draw_is_the_ungrouped_draw"] = bool(torch.equal(masks[0].bool(), alone))
    return out


def _shards(trainer) -> dict:
    """{parameter: [this rank's elements, the full leaf's, its first moment's
    elements]} of the parameters a layout splits."""
    opt = trainer.optimizer
    out = {}
    for i, name in enumerate(opt.names):
        layout = opt.layouts.get(i)
        if layout is not None and layout.sharded:
            out[name] = [opt.params[i].numel(), int(np.prod(layout.full_shape)), opt.mu[i].numel(),
                         layout.tp_dim is not None, layout.dp_dim is not None]
    return out


def _replicated_sums(trainer) -> dict:
    """{parameter: the fp64 sum of its values} of the parameters no layout
    splits: every rank must hold the same."""
    sharded = {trainer.optimizer.names[i] for i, lay in trainer.optimizer.layouts.items() if lay.sharded}
    return {n: float(p.detach().double().sum()) for n, p in trainer.model.named_parameters() if n not in sharded}


def _with_mesh(**layout):
    """The scenario's mesh: the group's, with the model axis ``layout`` asks for."""
    mesh_lib._MESH = WORLD["mesh"]
    return mesh_lib.mesh_from_config(layout)


# JAX's TP / FSDP step set-up (tests/test_tensor_parallel_families.py:_run_steps)
JAX_STEP = dict(decay="cosine", learning_rate=1e-3, num_train_steps=100, warmup_ratio=0.1, weight_decay=0.1)
MP_STEPS = 2


def _clipvip_layout(out_dir: str, save_steps: int = 100, **layout) -> dict:
    from xpretrain_tpu_torch.parallel import fsdp

    _with_mesh(**layout)
    fsdp.MIN_SIZE = 64  # JAX's test's min_size
    trainer = _clipvip_trainer(out_dir, **JAX_STEP, save_steps=save_steps, **layout)
    trainer.num_train_steps = MP_STEPS  # the schedule's horizon stays JAX's 100
    rows = _record(trainer)
    trainer.train()
    state = {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict()}  # gathered
    if mesh_lib.is_main_process():
        torch.save(state, os.path.join(out_dir, "final.pt"))
    out = {"losses": [r["loss"] for r in rows], "grad_norms": [r["grad_norm"] for r in rows],
           "shards": _shards(trainer), "replicated": _replicated_sums(trainer)}
    other = os.path.join(os.path.dirname(out_dir), "clipvip_tp", "final.pt")
    if layout.get("zero3") and os.path.exists(other):
        # a file written under --tp 2 alone loads under this layout and
        # gathers back to itself
        saved = torch.load(other, weights_only=True)
        trainer.model.load_state_dict(saved["model"])
        trainer.optimizer.load_state_dict(saved["optimizer"])
        again = {"model": trainer.model.state_dict(), "optimizer": trainer.optimizer.state_dict()}
        flat = lambda d, p="": {f"{p}{k}": v for k, v in d.items() if torch.is_tensor(v)} | {  # noqa: E731
            x: y for k, v in d.items() if isinstance(v, dict) for x, y in flat(v, f"{p}{k}/").items()}
        a, b = flat(saved), flat(again)
        out["cross_layout_load"] = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    return out


def clipvip_tp(out_dir: str) -> dict:
    return _clipvip_layout(out_dir, tp=2)


def clipvip_zero3(out_dir: str) -> dict:
    return _clipvip_layout(out_dir, zero3=1)


def clipvip_zero3_tp(out_dir: str) -> dict:
    return _clipvip_layout(out_dir, save_steps=1, tp=2, zero3=1)


def units_mp(out_dir: str) -> dict:
    """On a (2, 2) mesh: the sample ids of this rank's first batch and the
    dropout mask its step generator draws."""
    from xpretrain_tpu_torch.data.datasets import RetrievalCollator
    from xpretrain_tpu_torch.data.loader import BatchLoader
    from xpretrain_tpu_torch.data.tokenization import HashTokenizer
    from xpretrain_tpu_torch.models.common import dropout
    from xpretrain_tpu_torch.parallel.train_step import _seed

    mesh = _with_mesh(tp=2)
    pi, pc = mesh_lib.process_index_count()
    loader = BatchLoader(_Transformed(48, seed=0), GLOBAL_BATCH // pc, RetrievalCollator(HashTokenizer(), 16),
                         seed=0, process_index=pi, process_count=pc)
    batch = next(iter(loader))
    keep = dropout(torch.ones(64), 0.5, torch.Generator().manual_seed(_seed(123))) > 0
    return {"data_index": mesh.rank, "model_index": mesh.model_rank, "process_index_count": [pi, pc],
            "rows": np.asarray(batch["text_input_ids"]).tolist(), "mask": keep.long().tolist()}


def lfvila1_tp(out_dir: str) -> dict:
    _with_mesh(tp=2)
    return _generic(out_dir, *_lfvila(1), tp=2)


def hdvila1_tp(out_dir: str) -> dict:
    _with_mesh(tp=2)
    return _generic(out_dir, *_hdvila(), tp=2)


def lfvila1_cp(out_dir: str) -> dict:
    """Stage 1 with the Swin3D frames over the model axis of a (2, 2) mesh
    (windows 2 and 4 local on 4 frames a rank, 8 and up gathered)."""
    _with_mesh(cp=2)
    return _generic(out_dir, *_lfvila(1, cp=True), cp=2)


def lfvila1_tpcp(out_dir: str) -> dict:
    """Stage 1 at ``--tp 2 --cp 2``: BERT TP-sharded, Swin3D time-sharded,
    on one model axis."""
    _with_mesh(tp=2, cp=2)
    return _generic(out_dir, *_lfvila(1, cp=True), tp=2, cp=2)


def _swin_cp_model(faithful: bool):
    from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params
    from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig, SwinTransformer3D

    cfg = Swin3DConfig.tiny(depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2), stages=(0, 0, 1, 1),
                            downsample_stages=(1,), window_size=((2, 2, 2), (4, 2, 2), (8, 2, 2), (8, 2, 2)),
                            local_window=4, faithful_local_branch=faithful, context_parallel_axis="model")
    with np.load(PARAMS["swin"]) as f:
        params = _unflatten({k[len("p/"):]: f[k] for k in f.files if k.startswith("p/")})
    return load_jax_params(SwinTransformer3D(cfg), params).eval()  # JAX's deterministic apply


def swin_cp(out_dir: str) -> dict:
    """The tiny Swin3D at cp = the world size: forward (faithful and true
    local branch) and the gradients of one backward, against one process."""
    mesh = _with_mesh(cp=WORLD["mesh"].world_size)
    with np.load(PARAMS["swin"]) as f:
        video = torch.from_numpy(f["video"])
    out = {"model_size": mesh.model_size}
    g = torch.Generator().manual_seed(3)
    for faithful in (True, False):
        model = _swin_cp_model(faithful)
        glob, loc = model(video)
        tag = "faithful" if faithful else "local"
        if mesh_lib.is_main_process():
            np.savez(os.path.join(out_dir, f"{tag}.npz"), glob=glob.detach().numpy(), loc=loc.detach().numpy())
        # one backward: the Swin3D gradients are partial sums over the rank's
        # frames, summed over the model group as the train step does
        wg, wl = torch.randn(glob.shape, generator=g), torch.randn(loc.shape, generator=g)
        ((glob * wg).sum() + (loc * wl).sum()).backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in model.parameters()]
        mesh_lib.all_reduce_model_sum_(grads)
        with _no_group():
            ref = _swin_cp_model(faithful)
            rg, rl = ref(video)
            ((rg * wg).sum() + (rl * wl).sum()).backward()
        want = [torch.zeros_like(p) if p.grad is None else p.grad for p in ref.parameters()]
        out[f"{tag}_fwd_vs_one_process"] = float(max((glob - rg).abs().max(), (loc - rl).abs().max()))
        out[f"{tag}_grad"] = max(float((a - w).abs().max() / w.abs().max().clamp_min(1e-12))
                                 for a, w in zip(grads, want))
        out[f"{tag}_grads_nonzero"] = sum(bool(w.abs().max() > 0) for w in want)
    return out


def lfvila_runner_cp(out_dir: str) -> dict:
    """``run_pretrain_lfvila`` at ``--cp 2`` on a group of 2 (one data index:
    the draws of one process) or at ``--cp 1`` on a group of 1: its scalars."""
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila

    cfg_path = os.path.join(out_dir, "tiny.json")
    with open(cfg_path, "w") as f:
        json.dump({"video_encoder": {"embed_dim": 32, "depths": [1, 1, 2, 1, 1, 1], "num_heads": [2, 2, 4, 4, 4, 4],
                                     "drop_path_rate": 0.0},
                   "bert": "tiny", "num_local_layers": 2, "stage1_layers": 4, "sample_frame": 8,
                   "final_num_patches": 1}, f)
    cp = WORLD["mesh"].world_size
    run_pretrain_lfvila.main(["--stage", "1", "--config", cfg_path, "--dummy_data", "1", "--input_hw", "96", "160",
                              "--num_train_steps", "2", "--train_batch_size", "4", "--max_txt_len", "8", "--bf16",
                              "0", "--log_steps", "1", "--device", "cpu", "--cp", str(cp), "--output_dir", out_dir])
    rows = []
    if mesh_lib.is_main_process():
        with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
    return {"cp": cp, "model_size": mesh_lib.current_mesh().model_size, "scalars": rows}


def _spe_inputs() -> dict:
    with np.load(PARAMS["spe"]) as f:
        return {k: torch.from_numpy(f[k]) for k in f.files}


def _save_rank(out_dir: str, case: str, **arrays) -> None:
    np.savez(os.path.join(out_dir, f"{case}_{mesh_lib.process_rank()}.npz"),
             **{k: v.detach().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in arrays.items()})


def _ring_cases(out_dir: str, inputs: dict) -> None:
    from xpretrain_tpu_torch.ops.ring_attention import make_ring_attention, sequence_block
    from xpretrain_tpu_torch.parallel.p2p import ring_shift

    q, k, v, target, mask = (inputs[f"ring/{n}"] for n in ("q", "k", "v", "target", "mask"))
    for shape, names in (((4,), ("seq",)), ((2, 2), ("data", "seq"))):
        mesh = mesh_lib.create_mesh(shape, names)
        # the shift's direction: each rank sends its index and receives its
        # predecessor's; the backward returns each gradient to its sender
        sent = torch.tensor([float(mesh.model_rank)], requires_grad=True)
        (got,) = ring_shift((sent,), mesh.model_group)
        (got * (10.0 + mesh.model_rank)).sum().backward()
        _save_rank(out_dir, f"shift_{'x'.join(map(str, shape))}", received=got, grad=sent.grad,
                   index=mesh.model_rank)
        data_axis = "data" if len(shape) == 2 else None
        rows = mesh_lib.rank_slice(torch.arange(q.shape[0]), mesh) if data_axis else torch.arange(q.shape[0])
        ring = make_ring_attention(mesh, seq_axis="seq", data_axis=data_axis)
        for with_mask in (False, True):
            local = [sequence_block(t[rows], mesh).clone().requires_grad_(True) for t in (q, k, v)]
            m = sequence_block(mask[rows], mesh, dim=1) if with_mask else None
            out = ring(*local, m)
            # this rank's share of the global mean-squared loss
            ((out - sequence_block(target[rows], mesh)) ** 2).sum().div(target.numel()).backward()
            _save_rank(out_dir, f"ring_{'x'.join(map(str, shape))}_{'mask' if with_mask else 'nomask'}", out=out,
                       gq=local[0].grad, gk=local[1].grad, gv=local[2].grad, rows=rows,
                       seq_index=mesh.model_rank, seq_size=mesh.model_size)


def _pipe_cases(out_dir: str, inputs: dict) -> None:
    from xpretrain_tpu_torch.models.bert import BertConfig
    from xpretrain_tpu_torch.models.common import expand_padding_mask
    from xpretrain_tpu_torch.parallel.pipeline import pipeline_param_shardings, pipelined_bert_encoder

    cfg = BertConfig(vocab_size=500, hidden_size=32, num_hidden_layers=4, num_attention_heads=4,
                     intermediate_size=64, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    stacked = {k[len("pipe/stacked/"):]: v for k, v in inputs.items() if k.startswith("pipe/stacked/")}
    hidden, target, pad = inputs["pipe/hidden"], inputs["pipe/target"], inputs["pipe/pad"]
    for case, shape, names, n_micro, with_mask in (("pipe_4_m4", (4,), ("pipe",), 4, True),
                                                  ("pipe_4_m8", (4,), ("pipe",), 8, False),
                                                  ("pipe_2x2_m2", (2, 2), ("data", "pipe"), 2, True)):
        mesh = mesh_lib.create_mesh(shape, names)
        data_axis = "data" if len(shape) == 2 else None
        stage = {n: t.clone().requires_grad_(True) for n, t in pipeline_param_shardings(stacked, mesh).items()}
        run = pipelined_bert_encoder(cfg, mesh, data_axis=data_axis, n_microbatches=n_micro)
        x = mesh_lib.rank_slice(hidden, mesh) if data_axis else hidden
        m = expand_padding_mask(mesh_lib.rank_slice(pad, mesh) if data_axis else pad) if with_mask else None
        out = run(stage, x.clone().requires_grad_(True), m)
        full = mesh_lib.gather_rows(out, mesh) if data_axis else out  # every rank computes the global loss
        ((full - target) ** 2).mean().backward()
        grads = [stage[n].grad for n in stage]
        mesh_lib.all_reduce_mean_(grads, mesh)  # the step's average over the data group
        _save_rank(out_dir, case, out=full, stage_index=mesh.model_rank, stage_size=mesh.model_size,
                   **{f"g/{n}": g for n, g in zip(stage, grads)})


def _moe_cases(out_dir: str, inputs: dict) -> None:
    from xpretrain_tpu_torch.parallel.moe import MoeFfn

    x = inputs["moe/x"]
    mesh = mesh_lib.create_mesh((2, 2), ("data", "expert"))
    for k in (1, 2):
        params = {n[len(f"moe{k}/"):]: t for n, t in inputs.items() if n.startswith(f"moe{k}/")}
        ffn = MoeFfn(x.shape[1], params["w1"].shape[0], params["w1"].shape[2], num_selected=k,
                     capacity_factor=float(inputs["moe/capacity_factor"]), expert_axis="expert", mesh=mesh)
        ffn.load_state_dict(params)  # the reference layout in, the rank's experts held
        y, aux = ffn(mesh_lib.rank_slice(x, mesh))
        full = mesh_lib.gather_rows(y, mesh)  # every rank computes the global loss
        ((full**2).mean() + 0.01 * aux).backward()
        grads = {n: p.grad for n, p in ffn.named_parameters()}
        mesh_lib.all_reduce_mean_(list(grads.values()), mesh)
        saved = ffn.state_dict()  # gathered to the reference layout
        _save_rank(out_dir, f"moe_k{k}", y=full, aux=aux, expert_index=mesh.model_rank,
                   experts=np.asarray(ffn.experts), **{f"g/{n}": g for n, g in grads.items()},
                   **{f"local/{n}": p for n, p in ffn.named_parameters()},
                   **{f"saved/{n}": t for n, t in saved.items()})


def seq_pipe_expert(out_dir: str) -> dict:
    """Ring attention, the pipeline and the MoE FFN on 4 ranks (see the
    module's docstring); returns the meshes' placements. Around them, the
    run's mesh: the current mesh object and a global-batch ``gather_rows``
    before and after ``create_mesh((4,), ("seq",))``, after
    ``create_mesh((2, 2), ("data", "expert"))`` and after every case, and
    whether ``devices`` of another count than the ranks raise."""
    inputs = _spe_inputs()
    run = mesh_lib.current_mesh()
    block = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * mesh_lib.process_rank()

    def seen():  # the run's mesh as the global-batch losses see it
        return mesh_lib.current_mesh() is run, mesh_lib.gather_rows(block)

    seen_at = [seen()]
    for shape, names in (((4,), ("seq",)), ((2, 2), ("data", "expert"))):
        mesh_lib.create_mesh(shape, names)
        seen_at.append(seen())
    try:
        mesh_lib.create_mesh((4,), ("seq",), devices=["cpu"] * 2)
        raised = ""
    except ValueError as e:
        raised = str(e)
    _ring_cases(out_dir, inputs)
    _pipe_cases(out_dir, inputs)
    _moe_cases(out_dir, inputs)
    seen_at.append(seen())
    _save_rank(out_dir, "run_mesh", same=np.asarray([s for s, _ in seen_at]), world=run.world_size,
               raised=np.asarray(raised), **{f"rows{i}": r for i, (_, r) in enumerate(seen_at)})
    return {"rank": mesh_lib.process_rank()}


class _no_group:
    """Compute as a process without a group (the reference math)."""

    def __enter__(self):
        self.saved, mesh_lib._MESH = mesh_lib._MESH, None

    def __exit__(self, *exc):
        mesh_lib._MESH = self.saved


SCENARIOS = {f.__name__: f for f in (clipvip, clipvip_bf16, lfvila1, lfvila2, hdvila1, units, clipvip_tp, clipvip_zero3,
                                     clipvip_zero3_tp, units_mp, lfvila1_tp, hdvila1_tp, lfvila1_cp, lfvila1_tpcp,
                                     swin_cp, lfvila_runner_cp, seq_pipe_expert)}
WORLD = {"mesh": None}  # the group's 1-D mesh, from which each scenario forms its own


def main() -> None:
    out_dir, store = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    PARAMS["file"] = os.path.join(os.path.dirname(os.path.abspath(out_dir)), "clipvip_params.npz")
    PARAMS["swin"] = os.path.join(os.path.dirname(os.path.abspath(out_dir)), "swin_cp.npz")
    PARAMS["spe"] = os.path.join(os.path.dirname(os.path.abspath(out_dir)), "seq_pipe_expert.npz")
    mesh = mesh_lib.maybe_init_distributed("cpu", init_method=f"file://{store}")
    assert mesh is not None and mesh.world_size == int(os.environ["WORLD_SIZE"])
    WORLD["mesh"] = mesh
    for name in sys.argv[3:]:
        run_dir = os.path.join(out_dir, name)
        os.makedirs(run_dir, exist_ok=True)
        mesh_lib._MESH = mesh
        result = SCENARIOS[name](run_dir)
        with open(os.path.join(out_dir, f"{name}_{mesh.rank}.json"), "w") as f:
            json.dump(result, f)
    mesh_lib.destroy_distributed()


if __name__ == "__main__":
    main()
