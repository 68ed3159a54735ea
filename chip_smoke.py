#!/usr/bin/env python3
"""Drive the PyTorch port (``xpretrain_tpu_torch``) on one NVIDIA card.

Phases, in order; any failure exits non-zero and prints no result:

1. require a CUDA card, print its name and power limit, turn TF32 off;
2. build the port's CUDA kernels from ``xpretrain_tpu_torch/csrc`` and list,
   per entry point (proxy attention, window attention, patch embed; bf16 and
   fp32), its registers, spills, shared memory and the tensor-core (``HMMA``)
   instructions in its SASS;
3. check the proxy-attention forward kernel against its plain PyTorch
   version on the card at B/32, B/16, the pretraining image branch's one-frame
   clips (b=32, N=1: S = 53) and small shapes, in fp32 and bf16, and
   the LSE it saves for the backward against ``proxy_attention_lse_plain``;
3b. the same for the backward kernel, at those shapes and the B/32 train
   shape (b=32), called alone (it computes the LSE itself) and with the
   forward's LSE (as autograd calls it), each twice (bit-identical), plus its
   gradient against autograd of the plain forward;
3c. the same for the window-attention kernel, at the LF-VILA stage shapes of
   batch 8 (stages 3-5, and the grouped stages 0-1), a tail and other head
   dims, and at stage 3 on q/k/v views of one fused qkv tensor (what the
   model passes; bit-equal to the contiguous call);
3d. the packed [B, S, H*D] proxy attention (the two proxy kernels through
   their stride arguments): forward at the phase-3 shapes, backward at the
   B/32 train shape, against the plain version (the phase 3/3b bars) and
   against the [B, H, S, D] kernels on the same data (bit-equal or not);
3e. the fused uint8 patch-embed kernel against ``fused_patch_embed``'s plain
   GEMM at the B/32 serving frames (288 of 224x224, P=32, D=768), at P=16 and
   at ragged shapes, fp32 and bf16 out;
3f. the frozen-BN kernels (``csrc/frozen_bn_act.cu``, HD-VILA's FrozenBN with
   its ReLU and residual add, a kernel of the port's own) against their plain
   versions at layer1's bn3 of the high-resolution ResNet (bf16 [32, 256,
   160, 256], channels_last), in each of the three forms: the ops' output
   within one bf16 ulp of float32, dx and the identity's gradient bit-equal
   to the backward's plain version, the parameters' sums within 1e-5 and the
   same bits in two runs; ``FrozenBatchNorm`` through its wrapper under
   autograd (also on contiguous maps) against the float32 plain version: y,
   dx and the identity's gradient within one bf16 ulp, the gradients of
   scale, bias, mean and var within 1e-3 of their norms, 3 launches (2 with
   the parameters frozen); and one forward of the stage-1 model, whose 96
   FrozenBatchNorms all take the kernel (``xpt.frozen_bn.kernel`` 96,
   ``xpt.frozen_bn.plain`` 0, 96 launches);
3g. the multi-tensor AdamW kernel (``csrc/adamw_multi_tensor.cu``, the
   optimizer's update in one pass, a kernel of the port's own) against the
   ``_foreach`` path at the three train cells' optimizers (the B/32
   fine-tune, LF-VILA and HD-VILA stage 1, built from
   ``benchmark/configs``), three updates each from the same state and
   gradients (the second clipped): moments bit-equal, parameters within 2
   fp32 ulps (the largest distance printed), every trained leaf on the
   kernel (``xpt.adamw.kernel``, ``xpt.adamw.plain`` 0), one launch per 512
   leaves; the B/32 leaf list also with bf16 moments and inside a captured
   CUDA graph, replayed for three updates;
4. run CLIP-ViP B/32 zero-shot retrieval eval (random weights from a seed,
   bf16, synthetic uint8 clips) through the CLI, counting kernel launches;
4b. run the MSR-VTT B/32 fine-tune preset through the CLI for a few steps
   (``--mode train``), counting forward and backward launches;
4c. run LF-VILA paragraph-to-video retrieval (the stage-1 preset's model at
   full width and depth, the window kernel on, bf16, synthetic data) through
   its CLI with no train step, counting window-kernel launches (96 synthetic
   samples, as 4g's evals, cut from the runner's 256 to keep the script's
   time);
4d. the ops path: the public op entries that no model calls, at the full
   B/32 widths in bf16: ``proxy_attention_packed`` forward (b=24) and
   forward + backward through autograd (b=32), and ``fused_patch_embed``
   with ``use_kernel=True`` on the 288 frames of a b=24 batch, counting the
   packed and patch-embed launches;
4e. run LF-VILA stage-1 pretraining (``run_pretrain_lfvila --stage 1`` on the
   port's JSON copy of the stage-1 preset: full width and depth, batch 16,
   bf16, synthetic u8 clips, the window kernel off as JAX trains) for 5
   steps: finite losses and gradient norms, step times in CUDA events, peak
   memory, and the op classes of the last step's ``torch.profiler`` trace;
4f. run stage-2 pretraining (the stage-2 preset, Swin3D remat, batch 48)
   for 4 steps: finite MLM and VTM losses, every
   frozen parameter bit-identical after the steps and every other one moved;
4g. run the LF-VILA fine-tunes through ``run_tasks_lfvila``: ``qa_mc``,
   ``qa_cls`` (ActivityNet-QA) and ``video_cls`` at their default text
   lengths on the kernel config with
   no train step (six window launches per video forward, accuracy in
   [0, 1]; 96 synthetic samples each, cut from the runner's 256 to keep the
   script's time), then 2 ``qa_mc`` train steps on the kernel-off config
   (the fusion and span-loss backward);
4h. run CLIP-ViP pretraining (``run_pretrain_clipvip`` on the port's JSON
   copy of the B/32 pretraining preset: b=32, 12 frames at 224, bf16,
   ``NCELearnableTempLoss_vsc_fc``, synthetic data with the image/caption
   branch) for 6 steps from a ``--clip_weights`` file it writes (a seeded
   B/32 under ``clipmodel.``, an 8-row temporal embedding): the loaded
   parameters against the file, finite losses and gradient norms, 24 forward
   and 24 backward proxy launches a step (12 video + 12 image layers), step
   times in CUDA events and peak memory;
4i. run LF-VILA stage-1 pretraining for 4 steps from a written 2-D Swin-B
   (``--swin_weight``, inflated to the preset's 3-D windows) and a BERT-large
   (``--bert_weight``, the 12 layers the stage-1 model holds): the BERT
   embeddings, the inflated patch embed and the tiled bias tables on the
   model before its first step, finite losses, step times in CUDA events;
4j. run HD-VILA stage-1 pretraining (``run_pretrain_hdvila`` on the port's
   JSON copy of the stage-1 preset: ResNet-50 x 2, TimeSformer 4 x 16 heads
   at hidden 1024, BERT-large, 2 clips of 7 frames, middles at 640x1024 and
   neighbours at 160x256, b=8, bf16, synthetic uint8 frames) for 4 steps:
   finite ITC losses, step times in CUDA events, peak memory, host steps/s;
   the trained model is written as a reference HDVILA checkpoint;
4k. run stage 2 (the stage-2 preset: b=16, 2 micro-batches an update, MLM
   under lse, pixel sampling at 160) from that checkpoint through
   ``--e2e_weights_path``: the frozen stage-1 modules bit-identical to the
   checkpoint after the steps, the others moved;
4l. run ``run_retrieval_hdvila``: 3 ITC steps and R@K, then 2 steps of the
   rerank head (``--loss_type rank``);
4m. run ``run_video_qa_hdvila``: multiple choice and FrameQA, 2 steps each
   with a validation, then ``--mode inference`` on the first run;
4n. run the MSR-VTT B/32 preset through ``--mode train`` with the
   production switches, ``--steps_per_call 4 --param_dtype bf16
   --async_checkpoint 1``, 8 steps at b=16 with saves and validations every
   4: 12 + 12 proxy launches a step counted at the graph's replays, no plain
   call on CUDA, finite losses, every stored parameter of >= 2 dims bf16 and
   equal to bf16 of its fp32 master, both checkpoints loaded and the last
   equal to the final state bit for bit, and both files equal bit for bit to
   those of the same run with ``--async_checkpoint 0``;
4o. run LF-VILA stage-1 pretraining (the preset at b=16, kernel off) at
   ``--steps_per_call 2`` for 4 steps and eagerly on the same seed and data:
   the per-step losses and gradient norms within phase 5b's bars (the MTC
   clips follow the step's seed, not the capture);
4p. serve B/32 (b=24) in the ``factorized`` proxy mode: no proxy launch and
   no guarded plain call, features within 1e-4 of the masked_full kernel
   path in fp32 (bf16 printed), and a training step with attention dropout;
4q. move 16 synthetic B/32 batches onto the card through
   ``PrefetchLoader(depth=2)`` and ``batch_to_device``: each bit-equal to its
   host batch;
4s. train at attention dropout 0.1, set through the model API as in JAX
   (no flag sets it): the MSR-VTT B/32 preset through ``run_retrieval_clipvip``
   with ``ClipVipTrainer(model_cfg=...)`` (both towers' attention dropout),
   2 steps at b=16 eagerly and at ``--steps_per_call 2``, then its
   validation: no proxy launch in training (JAX's gate takes
   ``dot_attention`` over the proxy mask, with dropout: 12 such calls on
   CUDA a training forward, counted exactly, remat off as in the preset), 12
   forward launches a validation batch, finite losses, the graphed run bit
   for bit the eager one; then LF-VILA ``qa_mc`` on the window-kernel config
   with ``Swin3DConfig.attn_drop_rate`` 0.1, 2 steps at b=4 and its eval: no
   window launch in training, 6 a batch in the eval, finite losses;
4r. (inside 4f, 4g, 4h and 4j-4m, after each eager training run) run the
   same runner again at ``--steps_per_call 2``: LF-VILA stage 2 under remat,
   the qa_mc fine-tune, CLIP-ViP pretraining, HD-VILA stages 1 and 2 (2
   micro-batches an update: two graphs on one memory pool), HD-VILA
   retrieval (ITC and rank) and video QA (mc and FrameQA). Each captures a
   graph; its losses and gradient norms are held to the eager run's within
   phase 5b's bars and its launch counts equal the eager run's; its peak
   memory is printed;
5. serve a few requests through ``RetrievalTowers`` in fp32 and compare the
   card's features with the CPU's (plain path) for the same weights;
5b. take one fp32 pretraining step of B/32 at batch 2 on the card (kernels)
   and on the CPU (plain) from the same weights and batch (fp32 video, one
   image and caption a clip, ``vsc_fc``), and compare;
5c. encode one clip and its paragraph through ``LfVilaTowers`` in fp32 on the
   card and on the CPU from the same weights, and compare;
5d. take one fp32 ``LfVilaPretrain`` train step per stage on the card and on
   the CPU (full widths, one block per Swin3D stage and one BERT layer per
   BERT stage, batch 2, explicit MTC clips) and compare, as 5b;
5e. take one fp32 HD-VILA pretraining step per stage on the card and on the
   CPU at the presets' widths and depth (batch 2 of one clip, dropout off):
   the loss within 1e-5, stage 1's gradient norm within 1e-4 relative;
5f. the graphed train step against the eager one: the B/32 bf16 step at
   b=32, 4 steps as replays of a captured CUDA graph (K = 4) and 4 eager
   steps on the same batches and seeds, plain and with gradient accumulation
   2 (one graph per micro-step index): parameters, moments and losses bit
   for bit, else their largest differences within phase 5b's bars; then 4
   more steps, every one a replay, under ``torch.profiler``: the launch
   counters equal the proxy kernels the device ran, by kernel name, and the
   peak memory of the graphed steps is printed;
6. time the forward kernel against the plain version, and the whole forward;
6b. time the backward kernel (with the forward's LSE, and alone) against its
   plain version, forward and backward through autograd (kernels against the
   plain forward and, in bf16, SDPA), and the B/32 bf16 train step at b=32;
6c. time the window kernel against its plain version at the batch-8 shapes,
   and the LF-VILA video and text towers at batch 8 in bf16;
6d. time the packed kernels (the backward as autograd runs it, on the
   forward's LSE, and alone) and the patch-embed kernel against their plain
   versions and one PyTorch call that computes the same function
   (``library_ms``: ``scaled_dot_product_attention`` with the proxy mask; a
   bf16 ``addmm`` of pre-gathered bf16 patches and the bf16-rounded weight,
   the model's own GEMM), and that call for the kernels of phases 6-6c at
   their shapes; the window kernel at stages 3, 5 and the grouped 0-1 against
   its plain version and the model's off-gate path (``dot_attention`` with
   bias + mask as one additive mask); each kernel's device time alone
   (``torch.profiler``) over the calls it is timed on;
6e. time the HD-VILA stage-1 bf16 train step at b=8 (windows of CUDA
   events, device time by op class, its operations from
   ``torch.utils.flop_counter`` against the bf16 dense peak) and the video
   tower at b=8;
6h. time the frozen-BN kernels at 3f's shape in the bn3 form (+ identity,
   ReLU): forward, and forward + backward through autograd, against the
   plain version (the module's eager arithmetic before the fusion) and the
   bound of their bytes;
6i. time the multi-tensor AdamW kernel alone at each train cell's leaf
   list against its byte bound (28 B an element), the ``_foreach`` chain
   it replaces, both with the gradient norm's pass ahead of them (what the
   op class ``optimizer_ms.train`` reads holds), and
   ``torch.optim.AdamW(fused=True)`` on the same leaves as a yardstick that
   the port never calls;
6f. time the B/32 bf16 train step at b=32 eager and graphed (K = 4), with
   fp32 and with bf16 parameter storage, and LF-VILA stage 1 at b=16 eager
   and at K = 2: ms a step (5 windows of about 0.5 s, LF-VILA's 0.6),
   device busy time and idle share,
   device kernels and host launch calls a step, peak memory;
6g. time the graphed B/32 bf16 train step at b=32 (K = 2) at attention
   dropout 0.1 beside 0 (6f's measure): what JAX's dense dropout branch
   costs, a record for a kernel with dropout inside to beat;
7a. export B/32 (bf16, kernel attention, u8 [b, 12, 224, 224, 3], 70
   tokens) through ``export_serving_clipvip`` to a file, load it with
   ``load_artifact`` and call it at b = 1, 7 and 24: features within 1e-4
   of the live ``RetrievalTowers`` on the same weights, 12 proxy-forward
   launches per video call counted inside the loaded program and no other;
   a ``plain`` artifact beside it (no launch, within the forward kernel's
   bf16 bar of the kernel artifact's); video + text at b=24 through the
   artifact and the live towers timed (5 windows), with the export, save and
   load times and the file size;
7b. the same for LF-VILA at the stage-1 preset's width in fp32 with the
   window kernel on (fp32 frames [2, 3, 32, 192, 320], 4 x 50 tokens):
   within 1e-4 of ``LfVilaTowers``, 6 window launches per video call inside
   the program;
7c. HD-VILA at the stage-1 preset's width in fp32, uint8 middles and
   neighbours, b=1, the exported programs called without a file: within
   1e-4 of ``HdVilaTowers``, one frozen-BN launch per FrozenBatchNorm a
   video call and no other kernel;
7d. a module calling ``fused_patch_embed(use_kernel=True)`` at the B/32
   frames through ``torch.export``, saved and loaded: bit-equal to the eager
   kernel, one launch a call;
7e. B/32 under ``int8_serving`` (w8a8, ``torch._int_mm``) at b=24: embedding
   cosine (JAX's: of the batch's flattened features) >= 0.9994 against the
   bf16 path, the lowest row's printed, both timed (a record);
7f. in the process before any group: JAX's one-device call sequence.
   ``create_mesh((1,), ("seq",))`` returns a one-rank mesh on ``cuda:0`` and
   leaves no current mesh; ring attention through it at 10a's shapes equals
   the ``mesh=None`` call bit for bit, fp32 and bf16, gradients included;
8a. set up a one-rank NCCL group as ``torchrun`` would (``RANK=0``,
   ``WORLD_SIZE=1``, ``LOCAL_RANK=0``, ``MASTER_ADDR``, a free
   ``MASTER_PORT``; the runner's ``parse_args`` joins it) and run 4b's
   fine-tune again (``--zero2 1``), eagerly and at ``--steps_per_call 2``
   (NCCL inside the captured graph): losses, gradient norms, every tensor of
   the last checkpoint and the validation report bit for bit against 4b's
   run without a group (else within phase 5b's bars), launches equal;
8b. the B/32 bf16 step at b=32, ZeRO-2, K = 2 under the group: 2 replayed
   steps under ``torch.profiler`` (the proxy kernels by name as in 5f, and
   the NCCL kernels the collectives left in the graph), then its ms a step
   (5 windows of CUDA events) with the group and, once it is destroyed,
   without: the collectives' cost at world size 1;
8c. LF-VILA stage 1 (the preset's widths, depth cut, b=8, 3 steps, MTC and
   InfoNCE over the global batch, ZeRO-2) and the retrieval eval with the
   window kernel on, without a group and under a one-rank group: held as
   8a, the eval's report and window launches equal;
9a. under a one-rank group again, 4b's fine-tune at ``--zero3 1`` (each
   parameter of >= 16384 elements in its one data rank's block, gathered per
   transformer block), eagerly and at ``--steps_per_call 2``: bit for bit
   against 4b's run, launches equal;
9b. the B/32 bf16 step (b=32, 2 eager steps) under the tensor-parallel plan
   ``--tp N`` applies (``apply_tensor_parallel``) over a 1 x 1 (data, model)
   mesh, bit for bit against the step without a group, launches equal; the
   proxy kernels at the local head counts of ``--tp 2`` and ``4`` (6 and 3)
   with phases 3 and 3b's bars; the graphed step (K = 2) timed under the TP
   plan and under ZeRO-3 (8b's measure);
9c. the LF-VILA towers of 4c (b=8, one batch) built as ``--cp`` builds them,
   over a model axis of one rank, bit for bit against the towers without it,
   6 window launches; the window kernel at one rank's stage-3 windows under
   ``--cp 2`` with phase 3c's bars;
10a. under a one-rank NCCL group again (each of 10a-10c forms its mesh with
   ``create_mesh``, which must leave the run's mesh, and a ``gather_rows``
   through it, as they were), ring attention
   (``ops/ring_attention.py``) on a (data, seq) mesh of one rank at
   BERT-large's heads over 2048 tokens ([4, 16, 2048, 64]) with a padding
   mask, fp32 and bf16: the output and the gradients of ``sum(out * w)``
   against one dense softmax on the same inputs (fp32 2e-5 and 3e-5·max|g|,
   JAX's bars; bf16 2e-2), both timed;
10b. the GPipe pipeline (``parallel/pipeline.py``) of BERT-large (24 layers,
   1024 wide) on a (data, pipe) mesh of one rank, 4 microbatches, b=16,
   S=50, fp32: output and stacked gradients against ``StagedBertEncoder`` on
   the same weights (2e-5, 3e-5; bit-identity reported), both timed;
10c. the MoE FFN (``parallel/moe.py``) at B/32's MLP widths (d 768, 8 experts
   of d_ff 3072) on a (data, expert) mesh of one rank over 8 clips' vision
   tokens (4736), top-1 and top-2, fp32 and bf16, capacity factor 1.25: the
   drops equal to the CPU's routing of the same probabilities, every expert
   trained, the leaves on the card, ms and peak GiB; at ample capacity the
   fp32 output within 2e-5 of a per-expert loop;
11. print the kernel summary (each kernel's time in CUDA events and on the
   device, plain time, library time and the bound of its work at the card's
   peak rates) and, as the last line, the status JSON.

Each main-path run (4, 4b, 4c, 4d, 4e, 4f, each run of 4g, 4h, 4i, each
run of 4j-4m, 4n, 4o, 4p, each run of 4s, the artifact calls of 7a, 7b and
7d, 7f's rings, each run
of 8a and 8c under the group, each run of 9a, 9b's step under the plan,
9c's cp towers and the runs of 10a-10c) sets
every launch count to 0 just before it and reads the counts just after (a
graphed step adds, at each replay, the launches its capture recorded; an
exported program counts in the kernels' ``xpt::`` ops, which it calls); the
summary reports each path's count and their sum.
While they run, a call of a plain version on CUDA tensors fails the phase;
4s alone expects the masked ``dot_attention`` of JAX's dropout branch, and
counts its calls.
HD-VILA runs none of the six kernels (JAX computes its convolutions,
TimeSformer attention and BERT in XLA): its phases check that they launch
none, that every FrozenBatchNorm takes the frozen-BN kernel (as many
launches as its modules' calls make, ``frozen_bn_calls``; no plain call) and
that the encoder's inputs and parameters are on the card. The summary gives that kernel its own entry, ``fused_kernels``.
Every path that trains updates through the AdamW kernel: its launches are
held, on each path, to ceil(trained leaves / 512) for each update the
optimizer made on the card, eager or replayed (``ADAMW_SEEN``), the
``_foreach`` chain on CUDA tensors counts as a plain call, and the summary
gives the kernel the second entry of ``fused_kernels``.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(about 13 minutes on one H100, the kernels' build included).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # name -> (source, the TPU kernel it replaces): one per pallas_call site
    "proxy_attention_fwd": ("xpretrain_tpu_torch/csrc/proxy_attention_fwd.cu",
                            "xpretrain_tpu/ops/proxy_attention.py:201"),  # _attention_pallas
    "proxy_attention_bwd": ("xpretrain_tpu_torch/csrc/proxy_attention_bwd.cu",
                            "xpretrain_tpu/ops/proxy_attention.py:345"),  # _attention_pallas_bwd
    "proxy_attention_packed_fwd": ("xpretrain_tpu_torch/csrc/proxy_attention_fwd.cu",
                                   "xpretrain_tpu/ops/proxy_attention.py:228"),  # _attention_pallas_packed
    "proxy_attention_packed_bwd": ("xpretrain_tpu_torch/csrc/proxy_attention_bwd.cu",
                                   "xpretrain_tpu/ops/proxy_attention.py:379"),  # _attention_pallas_bwd_packed
    "patch_embed_u8": ("xpretrain_tpu_torch/csrc/patch_embed_u8.cu",
                       "xpretrain_tpu/ops/patchify.py:84"),  # _pallas_patch_embed
    "window_attention_fwd": ("xpretrain_tpu_torch/csrc/window_attention_fwd.cu",
                             "xpretrain_tpu/ops/window_attention.py:59"),  # window_attention_pallas
}
# H100 SXM data-sheet peaks (dense): the bound of a kernel's work is the larger
# of its bytes over HBM_BYTES_PER_S and its operations over the tensor cores'
# bf16 rate, the least time the card needs for a bf16 output whatever computes
# it (the patch embed's u8 inputs widen to bf16 exactly; its hi + lo weight
# split is the kernel's cost, not the function's)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # max abs; fp32: summation order; bf16: output rounding
# patch embed, fp32 out, relative to max|out|: K = 3*P*P terms of up to 255*|w|
# summed in fp32 in another order than cuBLAS's, so the difference grows with
# the size of the sums, not with an output that happens to be small
PATCH_FP32_REL = 3e-5
# (N, H, W, P, D): the B/32 serving frames (24 clips x 12), P=16, ragged rows/K/D
PATCH_SHAPES = {
    "b32": (288, 224, 224, 32, 768),
    "p16": (288, 224, 224, 16, 768),
    "ragged_d200": (7, 64, 96, 16, 200),
    "ragged_rows": (5, 96, 160, 32, 768),
    "p14_k588": (2, 28, 42, 14, 64),
}
BF16_MAX_ULP = 1.0  # bf16 output vs the fp32 plain version of the same inputs: rounding alone
BWD_TOL_FP32 = 1e-4  # max abs: summation order over up to S terms
BWD_MAX_ULP = 2.0  # bf16 vs fp32 plain gradients: fp32 accumulation and one rounding at the store
LSE_TOL = 1e-5  # max abs, the forward's fp32 LSE: a sum of up to S exponentials in another order
B32 = dict(B=24, H=12, M=4, N=12, L=49, D=64)  # CLIP-ViP B/32 serving, batch 24
B32_TRAIN = dict(B32, B=32)  # CLIP-ViP B/32 training, batch 32
PRESET = "xpretrain_tpu_torch/configs/msrvtt_retrieval_vip_base_32.json"  # the port's copy of the MSR-VTT preset
TRAIN_STEPS, TRAIN_EVERY = 6, 3  # the fine-tune run of phase 4b: steps, validate/save cadence
B32_IMAGE = dict(B32_TRAIN, N=1)  # pretraining's image branch: b=32 one-frame clips, S = 4 + 49
CHECK_SHAPES = {
    "b32": B32,
    "b32_image": B32_IMAGE,
    "b16": dict(B=2, H=12, M=4, N=12, L=196, D=64),
    "tiny": dict(B=2, H=2, M=3, N=4, L=13, D=16),
    "l256_d128": dict(B=2, H=3, M=1, N=3, L=256, D=128),
    "d48": dict(B=2, H=3, M=4, N=5, L=7, D=48),
}
EVAL_BATCH = 24
VIDEO_LAYERS = 12
# LF-VILA: the stage-1 preset (as JSON, with the window kernel on) at batch 8,
# the JAX bench's LF-VILA batch (tools/bench_report.py:189)
LFVILA_PRESET = "xpretrain_tpu_torch/configs/lfvila_stage1_window_kernel.json"
LFVILA_BATCH = 8
WINDOW_BLOCKS = 6  # blocks of stages 3-5, whose windows hold >= 240 tokens: launches per video forward
# name -> (Bn, H, N, d, mask), the mask as the model builds it: stage shapes of
# 32 frames at 192x320, batch 8 (stage 3's shifted block, stage 3, stage 5,
# the grouped shifted blocks of stages 0 and 1), then random -100 masks
WINDOW_SHAPES = {
    "s3_shifted": (64, 16, 240, 32, ("shifted", (32, 6, 10), (16, 3, 5), (0, 1, 2))),
    "s3": (64, 16, 240, 32, None),
    "s5": (8, 32, 480, 32, None),
    "s0_grouped": (2048, 4, 120, 32, ("grouped", (32, 24, 40), (2, 3, 5), (0, 1, 2), 4)),
    "s1_grouped": (512, 8, 120, 32, ("grouped", (32, 12, 20), (4, 3, 5), (0, 1, 2), 2)),
    "tail_d16": (6, 3, 77, 16, ("random", 3)),
    "d64": (4, 2, 200, 64, ("random", 2)),
}
WINDOW_TIMED = ("s3_shifted", "s3", "s5")
# LF-VILA training: the port's JSON copies of the two pretraining presets
# (window kernel off, as JAX trains), full width and depth, synthetic data
STAGE_PRESETS = {1: "xpretrain_tpu_torch/configs/lfvila_pretrain_stage1.json",
                 2: "xpretrain_tpu_torch/configs/lfvila_pretrain_stage2.json"}
# steps of each stage's run: the first warms up and is not timed; stage 1's
# last is the profiled one (its op-class table), so it is not timed either
PRETRAIN_STEPS = {1: 5, 2: 4}  # the median is over the steps after the warm-up and before the profiled
PROFILED = {1: 1, 2: 0}  # trailing steps under torch.profiler
# the fine-tunes' eval paths on the kernel config (no train step), TASK_EVAL_SAMPLES synthetic samples each; qa_mc's
# 8 text rows (question, answer, 6 subtitles) of 50 tokens fit the 512 sentence positions, of 70 they do not
TASK_RUNS = {
    "qa_mc": ["--task", "qa_mc"],
    "qa_cls": ["--task", "qa_cls", "--qa_dataset", "actnet"],
    "video_cls": ["--task", "video_cls"],
}
QA_TRAIN = dict(steps=2, batch=4, samples=16)  # qa_mc train steps on the kernel-off config (span loss backward)
# synthetic samples each 4c and 4g eval decodes (the runner's default: 256): the host
# decodes at ~7-8 clips/s, so this is the phase's time
TASK_EVAL_SAMPLES = 96
# CLIP-ViP pretraining: the port's JSON copy of the B/32 preset; the first step warms up and is not timed
PRETRAIN_PRESET = "xpretrain_tpu_torch/configs/pretrain_vip_base_32.json"
PRETRAIN_CLIPVIP_STEPS = 6
PROXY_LAYERS_PER_STEP = 2 * VIDEO_LAYERS  # the video clips' and the images' passes through the 12 layers
# LF-VILA stage 1 from 2-D ImageNet Swin-B (4x4 patches, 7x7 windows) and BERT-large weights
CASCADE = dict(batch=8, steps=4, bert_layers=12)
# HD-VILA: the port's JSON copies of the two pretraining presets (ResNet-50 x 2, TimeSformer 4 x 16 heads at
# hidden 1024, BERT-large, 2 clips of 7 frames: the middle at 640x1024, 6 neighbours at 160x256), bf16, synthetic
HDVILA_PRESETS = {1: "xpretrain_tpu_torch/configs/hdvila_pretrain_stage1.json",
                  2: "xpretrain_tpu_torch/configs/hdvila_pretrain_stage2.json"}
HDVILA_STEPS = {1: 4, 2: 4}  # train-step calls; the first warms up; stage 2's preset accumulates 2 per update
HDVILA_VAL_ROWS = 16  # synthetic captions / questions of the retrieval and QA evals (the runners' default: 64)
HDVILA_TIMED_BATCH = 8  # phase 6e: the stage-1 preset's batch
# phases 3f and 6h: layer1's bn3 of the high-resolution ResNet in the cell hdvila_stage1.pretrain (b=16 samples of 2
# clips: 32 middles of 640x1024, 160x256 after the stem), bf16 channels_last
FROZEN_BN_SHAPE = (32, 256, 160, 256)
FROZEN_BN_FORMS = {"affine": (False, False), "relu": (True, False), "relu_identity": (True, True)}
# phases 3g and 6i: the optimizers of the three train cells, built from benchmark/configs/<config>.json as the
# cells' programs build them; the multi-tensor AdamW kernel against the _foreach path over ADAMW_UPDATES updates
ADAMW_CELLS = {"clipvip_b32": "clipvip_b32.train_graphed", "lfvila_stage1": "lfvila_stage1.pretrain",
               "hdvila_stage1": "hdvila_stage1.pretrain"}
ADAMW_UPDATES = 3
ADAMW_MAX_ULP = 2  # the parameters' largest distance from the _foreach path, in fp32 ulps (moments: bit-equal)
ADAMW_BYTES = 28  # an element's update reads p, g, m, v and writes p, m, v (fp32)
ARTIFACT_BATCHES = (1, 7, 24)  # 7a: the B/32 kernel artifact called at these batch sizes
ARTIFACT_TOL = 1e-4  # artifact vs live towers, max abs on the features (phase 5's bar)
INT8_COS = 0.9994  # 7e: w8a8 against bf16 embedding cosine (JAX's bar at B/32, xpretrain_tpu/ops/quant.py)
ARTIFACT_TIMED_ITERS = 20  # 7a/7e: calls per timing window (5 windows, as phase 6)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        print(f"FAIL in phase '{name}': {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); |want| below
    2^-8 counts as 2^-8."""
    import torch

    mag = want.abs().clamp_min(2.0**-8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


def qkv(shape: dict, dtype, seed: int = 0, n: int = 3):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    size = (shape["B"], shape["H"], shape["M"] + shape["N"] * shape["L"], shape["D"])
    return [torch.randn(size, device="cuda", generator=g).to(dtype) for _ in range(n)]


def window_inputs(shape: tuple, dtype, seed: int = 0):
    """q, k, v [Bn, H, N, d] in ``dtype``, an fp32 bias [H, N, N] and the
    fp32 mask of ``WINDOW_SHAPES``' kind (or None), on the card."""
    import numpy as np
    import torch
    from xpretrain_tpu_torch.models.lf_vila.swin3d import grouped_window_mask, shifted_window_mask

    Bn, H, N, d, kind = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(Bn, H, N, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(H, N, N, device="cuda", generator=g)
    if kind is None:
        mask = None
    elif kind[0] == "shifted":
        mask = torch.from_numpy(np.array(shifted_window_mask(*kind[1:]))).cuda()
    elif kind[0] == "grouped":
        mask = torch.from_numpy(np.array(grouped_window_mask(*kind[1:]))).cuda()
    else:
        draw = torch.rand(kind[1], N, N, device="cuda", generator=g)
        mask = torch.where(draw < 0.3, -100.0, 0.0)
    if mask is not None:
        check(tuple(mask.shape) == (mask.shape[0], N, N) and Bn % mask.shape[0] == 0, f"mask {mask.shape}")
    return q, k, v, bias, mask


def check_proxy_fwd(name: str, s: dict, dtype) -> float:
    """Phase 3's check of the proxy forward kernel at one shape and dtype
    against its plain version (and, in bf16, the fp32 plain version), with
    the LSE it saves; prints the line and returns the max abs error."""
    import torch
    from xpretrain_tpu_torch.ops import proxy_attention as pa

    q, k, v = qkv(s, dtype)
    before = pa.proxy_attention.launches
    got = pa.proxy_attention(q, k, v, s["M"], s["N"], s["L"], s["D"] ** -0.5)
    torch.cuda.synchronize()
    check(pa.proxy_attention.launches == before + 1, f"{name}: launch not counted")
    want = pa.proxy_attention_plain(q, k, v, s["M"], s["L"], s["D"] ** -0.5)
    dt = str(dtype).split(".")[-1]
    err = (got.float() - want.float()).abs().max().item()
    line = f"  {name:10s} {dt:8s} {s} max_abs {err:.3e} tol {TOL[dt]:.0e}"
    check(got.dtype == dtype and got.shape == q.shape, f"{name} {dt}: output dtype/shape")
    check(math.isfinite(err) and err <= TOL[dt], f"{name} {dt}: max_abs {err} > {TOL[dt]}")
    if dtype == torch.bfloat16:
        # The bf16 plain version rounds P to bf16 before PV, so its
        # error floor hides a kernel that accumulates in bf16; the
        # fp32 plain version of the same inputs leaves only the
        # kernel's output rounding, at most half an ulp.
        exact = pa.proxy_attention_plain(q.float(), k.float(), v.float(), s["M"], s["L"],
                                         s["D"] ** -0.5)
        ulps = bf16_ulps(got, exact)
        line += (f"; vs fp32 plain max_abs {(got.float() - exact).abs().max().item():.3e}, "
                 f"{ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})")
        check(ulps <= BF16_MAX_ULP, f"{name} bf16: {ulps} ulp from the fp32 plain version")
    # the LSE the forward saves for the backward (when a gradient follows)
    with_lse, lse = pa._launch_fwd(q, k, v, s["M"], s["N"], s["L"], s["D"] ** -0.5, with_lse=True)
    lse_err = (lse - pa.proxy_attention_lse_plain(q.float(), k.float(), s["M"], s["L"],
                                                  s["D"] ** -0.5)).abs().max().item()
    line += f"; LSE max_abs {lse_err:.3e} (tol {LSE_TOL:.0e})"
    check(torch.equal(with_lse, got), f"{name} {dt}: the output changes when the LSE is saved")
    check(lse.dtype == torch.float32 and lse.shape == q.shape[:3], f"{name} {dt}: LSE dtype/shape")
    check(math.isfinite(lse_err) and lse_err <= LSE_TOL, f"{name} {dt}: LSE max_abs {lse_err}")
    print(line)
    return err


def check_proxy_bwd(name: str, s: dict, dtype) -> dict:
    """Phase 3b's check of the proxy backward kernel at one shape and dtype,
    alone and on the forward's LSE, against the fp32 plain gradients; prints
    the line and returns {mode: max abs error}."""
    import torch
    from xpretrain_tpu_torch.ops import proxy_attention as pa

    scale = s["D"] ** -0.5
    errors = {}
    q, k, v, d_out = qkv(s, dtype, seed=1, n=4)
    before = pa.proxy_attention_bwd.launches
    alone = pa.proxy_attention_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale)
    torch.cuda.synchronize()
    check(pa.proxy_attention_bwd.launches == before + 1, f"{name}: backward launch not counted")
    # as autograd calls it: on the LSE the forward saved
    _, lse = pa._launch_fwd(q, k, v, s["M"], s["N"], s["L"], scale, with_lse=True)
    runs = {"alone": (alone, pa.proxy_attention_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale)),
            "forward's LSE": tuple(pa._launch_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale, lse=lse)
                                   for _ in range(2))}
    torch.cuda.synchronize()
    # the fp32 plain gradients of the same inputs: for bf16 that
    # leaves the kernel's one rounding at the store
    want = pa.proxy_attention_bwd_plain(*(t.float() for t in (q, k, v, d_out)),
                                        s["M"], s["L"], scale)
    dt = str(dtype).split(".")[-1]
    line = f"  {name:10s} {dt:8s}"
    for mode, (got, again) in runs.items():
        for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
            check(g.dtype == dtype and g.shape == q.shape, f"{name} {dt} {gname}: dtype/shape")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{name} {dt} {mode}: two calls differ (the backward is not deterministic)")
        err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
        errors[mode] = err
        line += f" {mode}: max_abs {err:.3e}"
        check(math.isfinite(err), f"{name} {dt} {mode}: backward not finite")
        if dtype == torch.float32:
            line += f" (tol {BWD_TOL_FP32:.0e})"
            check(err <= BWD_TOL_FP32, f"{name} fp32 backward {mode}: max_abs {err} > {BWD_TOL_FP32}")
        else:
            ulps = max(bf16_grad_ulps(g, w) for g, w in zip(got, want))
            line += f", {ulps:.3f} ulp of the fp32 plain gradients (tol {BWD_MAX_ULP:.0f})"
            check(ulps <= BWD_MAX_ULP, f"{name} bf16 backward {mode}: {ulps} ulp")
        line += ";"
    same = all(torch.equal(a, b) for a, b in zip(*(got for got, _ in runs.values())))
    print(f"{line} two calls bit-identical; alone bit-equal to with the forward's LSE: {same}")
    del q, k, v, d_out, alone, runs, want
    return errors


def check_window(name: str, shape: tuple, dtype) -> float:
    """Phase 3c's check of the window kernel at one shape and dtype against
    its plain version (and, in bf16, the fp32 plain version); prints the line
    and returns the max abs error."""
    import torch
    from xpretrain_tpu_torch.ops import window_attention as wa

    q, k, v, bias, mask = window_inputs(shape, dtype)
    before = wa.window_attention.launches
    got = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    check(wa.window_attention.launches == before + 1, f"{name}: launch not counted")
    want = wa.window_attention_plain(q, k, v, bias, mask)
    dt = str(dtype).split(".")[-1]
    err = (got.float() - want.float()).abs().max().item()
    line = (f"  {name:10s} {dt:8s} [Bn,H,N,d]={list(shape[:4])} mask "
            f"{None if mask is None else list(mask.shape)} max_abs {err:.3e} tol {TOL[dt]:.0e}")
    check(got.dtype == dtype and got.shape == q.shape, f"{name} {dt}: output dtype/shape")
    check(math.isfinite(err) and err <= TOL[dt], f"{name} {dt}: max_abs {err} > {TOL[dt]}")
    if dtype == torch.bfloat16:
        # as in phase 3: against the fp32 plain version of the same
        # inputs only the kernel's output rounding is left
        exact = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
        ulps = bf16_ulps(got, exact)
        line += f"; vs fp32 plain {ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})"
        check(ulps <= BF16_MAX_ULP, f"{name} bf16: {ulps} ulp from the fp32 plain version")
    print(line)
    del q, k, v, bias, mask, got, want
    return err


def bf16_grad_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); |want| below
    2^-8 max|want| counts at that floor."""
    import torch

    mag = want.abs().clamp_min(2.0**-8 * want.abs().max().item())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


@contextlib.contextmanager
def plain_on_cuda_guard():
    """Record every call on CUDA tensors, while inside, of the plain functions
    the main paths' kernels stand in for: both proxy-attention versions and
    their packed forms, the masked ``dot_attention`` that ``ProxyAttention``
    takes under dropout, the window-attention version and the plain patch
    embed GEMM, the frozen BN's plain version, and the optimizer's
    ``_foreach`` chain (``GroupedAdamW._update_plain``). Yields the list of
    calls."""
    from xpretrain_tpu_torch.models.clip_vip import model as clip_vip_model
    from xpretrain_tpu_torch.ops import frozen_bn as fb
    from xpretrain_tpu_torch.ops import patchify as pp
    from xpretrain_tpu_torch.ops import proxy_attention as pa
    from xpretrain_tpu_torch.ops import window_attention as wa
    from xpretrain_tpu_torch.optim.optimizer import GroupedAdamW

    hooks = [(pa, "proxy_attention_plain"), (pa, "proxy_attention_bwd_plain"),
             (pa, "proxy_attention_packed_plain"), (pa, "proxy_attention_packed_bwd_plain"),
             (clip_vip_model, "dot_attention"), (wa, "window_attention_plain"), (pp, "patch_embed_plain"),
             (fb, "frozen_bn_act_plain")]
    originals = [getattr(module, name) for module, name in hooks]
    calls = []

    def guard(fn):
        def wrapped(q, *args, **kwargs):
            if q.is_cuda:
                calls.append((fn.__name__, tuple(q.shape)))
            return fn(q, *args, **kwargs)
        return wrapped

    def guard_optimizer(fn):
        def wrapped(self, grads, *args, **kwargs):
            if self.scalars.is_cuda:
                calls.append((fn.__name__, len(grads)))
            return fn(self, grads, *args, **kwargs)
        return wrapped

    hooks.append((GroupedAdamW, "_update_plain"))
    originals.append(GroupedAdamW._update_plain)
    for (module, name), fn in zip(hooks, originals):
        setattr(module, name, guard_optimizer(fn) if module is GroupedAdamW else guard(fn))
    try:
        yield calls
    finally:
        for (module, name), fn in zip(hooks, originals):
            setattr(module, name, fn)


def counted_wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches: the
    six of ``KERNELS``, the frozen-BN kernels (forward and backward) and the
    optimizer's AdamW kernel."""
    from xpretrain_tpu_torch.ops import frozen_bn as fb
    from xpretrain_tpu_torch.optim import adamw_kernel
    from xpretrain_tpu_torch.ops import patchify as pp
    from xpretrain_tpu_torch.ops import proxy_attention as pa
    from xpretrain_tpu_torch.ops import window_attention as wa

    return {"proxy_attention_fwd": pa.proxy_attention, "proxy_attention_bwd": pa.proxy_attention_bwd,
            "proxy_attention_packed_fwd": pa.proxy_attention_packed,
            "proxy_attention_packed_bwd": pa.proxy_attention_packed_bwd,
            "patch_embed_u8": pp.fused_patch_embed, "window_attention_fwd": wa.window_attention,
            "frozen_bn_act": fb.frozen_bn_act, "adamw_multi_tensor": adamw_kernel.adamw_multi_tensor}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


# the optimizer's updates on the card since the last reset_launches: device
# updates (eager, or in a replayed graph), the AdamW launches they should make
# (ceil(trained leaves / 512) each) and the trained leaf counts seen
ADAMW_SEEN = {"updates": 0, "launches": 0, "leaves": set()}
_ADAMW_CAPTURED: dict[int, tuple[int, int]] = {}  # id(graph) -> (updates, launches) its capture recorded


def adamw_recorder() -> None:
    """Hook, once, ``GroupedAdamW._update_kernel`` and ``GraphedStep``'s
    capture and replay so that ``ADAMW_SEEN`` follows every update on the
    card: an eager call counts at once, a captured one at each replay of its
    graph. The expected launches come from the optimizer's own trained leaf
    count, not from the kernel's wrapper."""
    import torch
    from xpretrain_tpu_torch.optim import adamw_kernel
    from xpretrain_tpu_torch.optim.optimizer import GroupedAdamW
    from xpretrain_tpu_torch.parallel.train_step import GraphedStep

    if getattr(GroupedAdamW._update_kernel, "recorded", False):
        return
    update, capture, replay = GroupedAdamW._update_kernel, GraphedStep._capture, GraphedStep._replay
    pending = [0, 0]  # the capture under way: updates, launches

    def recorded_update(self, grads, gnorm):
        trained = sum(len(idx) for idx in self.groups.values())
        n = -(-trained // adamw_kernel.MAX_LEAVES)
        ADAMW_SEEN["leaves"].add(trained)
        if torch.cuda.is_current_stream_capturing():
            pending[0] += 1
            pending[1] += n
        else:
            ADAMW_SEEN["updates"] += 1
            ADAMW_SEEN["launches"] += n
        return update(self, grads, gnorm)

    def recorded_capture(self, state, batch):
        pending[:] = [0, 0]
        out = capture(self, state, batch)
        _ADAMW_CAPTURED[id(out.graph)] = tuple(pending)
        return out

    def recorded_replay(capture_, batch, seed):
        updates, launches = _ADAMW_CAPTURED.get(id(capture_.graph), (0, 0))
        ADAMW_SEEN["updates"] += updates
        ADAMW_SEEN["launches"] += launches
        return replay(capture_, batch, seed)

    recorded_update.recorded = True
    GroupedAdamW._update_kernel = recorded_update
    GraphedStep._capture = recorded_capture
    GraphedStep._replay = staticmethod(recorded_replay)


def reset_launches() -> None:
    adamw_recorder()
    for fn in counted_wrappers().values():
        fn.launches = 0
    ADAMW_SEEN.update(updates=0, launches=0, leaves=set())


def expected(**launches: int) -> dict[str, int]:
    """Every counted kernel's expected launch count: 0 unless given, but the
    AdamW kernel's, which defaults to what the optimizer's updates on the
    card since the last :func:`reset_launches` make (``ADAMW_SEEN``)."""
    launches.setdefault("adamw_multi_tensor", ADAMW_SEEN["launches"])
    return {name: launches.get(name, 0) for name in counted_wrappers()}


def alternate(fns: dict, iters: int = 200) -> dict[str, list[float]]:
    """ms per call of each of ``fns`` (plain, kernel and any other), timed in
    turns there and back: plain, kernel, ..., ..., kernel, plain (CUDA
    events, ``iters`` calls each)."""
    from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

    order = ["plain", "kernel"] + [name for name in fns if name not in ("plain", "kernel")]
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        runs[name].append(cuda_time_ms(fns[name], iters=iters))
    return runs


def mean(xs: list[float]) -> float:
    return sum(xs) / len(xs)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for work of ``flops`` bf16
    operations and ``nbytes`` moved, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def packed(t):
    """[B, H, S, D] -> the packed [B, S, H*D] projection layout (a copy)."""
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D).contiguous()


def head_view(t, head_dim: int):
    """The [B, H, S, D] head view of a packed tensor (no copy)."""
    B, S, E = t.shape
    return t.view(B, S, E // head_dim, head_dim).transpose(1, 2)


def patch_inputs(shape: tuple, seed: int = 0):
    """uint8 frames [N, H, W, 3] and a patch kernel [P, P, 3, D] (std 0.02)
    on the card."""
    import torch

    N, H, W, P, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (N, H, W, 3), device="cuda", generator=g, dtype=torch.uint8)
    return frames, torch.randn(P, P, 3, D, device="cuda", generator=g) * 0.02


@contextlib.contextmanager
def timed_train_steps(module=None, name: str = "make_model_train_step"):
    """CUDA-event times of every call, while inside, of the train steps that
    ``module.name`` builds (default: ``generic_trainer.make_model_train_step``,
    the LF-VILA and HD-VILA trainers' step; ``ClipVipTrainer`` builds its own
    through ``trainer.make_train_step``, which the default leaves untimed):
    yields a list that fills with (start, end) event pairs, one per step;
    read them after a synchronize."""
    import torch
    from xpretrain_tpu_torch.train import generic_trainer

    module = module or generic_trainer
    original = getattr(module, name)
    events = []

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def timed(state, batch, seed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch, seed)
            end.record()
            events.append((start, end))
            return out
        return timed

    setattr(module, name, make)
    try:
        yield events
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def after_call(module, name: str):
    """While inside, each call of ``module.name(.., model, ..)`` (a loader of
    pretrained weights) copies the model's parameters right after it: yields
    the list of (copy: name -> tensor on the model's device, seconds the call
    took on the host clock)."""
    import torch

    original = getattr(module, name)
    copies = []

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        seconds = time.perf_counter() - t0
        model = next(a for a in args if isinstance(a, torch.nn.Module))
        copies.append(({n: p.detach().clone() for n, p in model.named_parameters()}, seconds))
        return out

    setattr(module, name, call)
    try:
        yield copies
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def snapshot_params():
    """While inside, every ``GenericTrainer`` (a ``ClipVipTrainer`` is one
    too; the phases that use this build none) copies its model's parameters
    as it is built (before any step): yields the list of those copies."""
    from xpretrain_tpu_torch.train import generic_trainer

    original = generic_trainer.GenericTrainer.__init__
    snapshots = []

    def init(self, cfg, model, *args, **kwargs):
        snapshots.append({name: p.detach().clone() for name, p in model.named_parameters()})
        original(self, cfg, model, *args, **kwargs)

    generic_trainer.GenericTrainer.__init__ = init
    try:
        yield snapshots
    finally:
        generic_trainer.GenericTrainer.__init__ = original


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested dict's leaves by their "/"-joined keys."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = value
    return out


def scalars(out_dir: str) -> dict[str, list[float]]:
    """The runner's logged train scalars, by tag, in step order."""
    tags: dict[str, list[float]] = {}
    with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
        for row in map(json.loads, f):
            tags.setdefault(row["tag"], []).append(row["value"])
    return tags


def run_pretrain_stage(stage: int, batch: int, out_dir: str, extra: list[str]):
    """One ``run_pretrain_lfvila`` run of ``stage`` on its preset: (state,
    launch counts, plain calls on CUDA, per-step ms, parameter snapshot)."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila

    torch.cuda.reset_peak_memory_stats()
    with snapshot_params() as snapshots, timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls:
        reset_launches()
        state = run_pretrain_lfvila.main(pretrain_stage_argv(stage, batch, out_dir, extra))
        torch.cuda.synchronize()
        launches = launch_counts()
    ms = [start.elapsed_time(end) for start, end in events]
    return state, launches, list(plain_cuda_calls), ms, snapshots[0]


def pretrain_stage_argv(stage: int, batch: int, out_dir: str, extra: list[str]) -> list[str]:
    """``run_pretrain_lfvila``'s arguments for :func:`run_pretrain_stage`."""
    steps = PRETRAIN_STEPS[stage]
    profile = ["--profile_steps", str(PROFILED[stage]), "--profile_start_step", str(steps - PROFILED[stage])]
    return ["--config", os.path.join(REPO, STAGE_PRESETS[stage]), "--stage", str(stage), "--dummy_data", "1",
            "--device_ingest", "1", "--train_batch_size", str(batch), "--num_train_steps", str(steps),
            "--log_steps", "1", "--save_steps", "1000", "--device", "cuda", "--output_dir", out_dir,
            *(profile if PROFILED[stage] else []), *extra]


def report_pretrain_stage(stage: int, batch: int, out_dir: str, launches: dict, plain_cuda_calls: list,
                          ms: list[float], card: str, keys: tuple[str, ...]) -> dict:
    """Print and check one stage's run: no kernel launch and no plain call on
    CUDA (the window kernel is off for training, as in JAX), finite losses
    and gradient norms, the step times and the peak memory."""
    import torch
    from xpretrain_tpu_torch.tools.profile_train_step import median

    print(f"  launches {launches} (expected none: the window kernel is off for training, as in JAX); "
          f"plain path on CUDA: {len(plain_cuda_calls)} calls")
    check(launches == expected(), f"stage {stage}: kernel launches on a training path without kernels")
    check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    tags = scalars(out_dir)
    steps = PRETRAIN_STEPS[stage]
    for key in ("loss", "grad_norm") + keys:
        values = tags.get(f"train/{key}", [])
        print(f"  {key} {[round(v, 5) for v in values]}")
        check(len(values) == steps and all(math.isfinite(v) for v in values), f"stage {stage}: {key} {values}")
    timed = ms[1:steps - PROFILED[stage]]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  stage-{stage} train step b={batch}: median {median(timed):.4f} ms (min {min(timed):.4f}, max "
          f"{max(timed):.4f}) over steps 2-{steps - PROFILED[stage]}; every step {[round(x, 2) for x in ms]} ms "
          f"(CUDA events around each step, first = warm-up{', last = profiled' if PROFILED[stage] else ''}) [{card}]")
    print(f"  peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated) [{card}]")
    check(all(math.isfinite(x) for x in ms), f"stage {stage}: step times")
    return {"batch": batch, "step_ms": timed, "peak_gib": peak}


def lfvila_5d_config(stage: int):
    """The stage's pretraining model for phase 5d: full widths (Swin3D embed
    128, BERT-large), depth cut to one block per Swin3D stage and one BERT
    layer per BERT stage, dropout and drop-path off (the card's and the
    CPU's generators draw different masks), fp32."""
    import torch
    from xpretrain_tpu_torch.models.bert import BertConfig
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig
    from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig

    bert = dataclasses.replace(
        BertConfig.bert_large(stage_bounds=(1, 2), type_vocab_size=8, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0), num_hidden_layers=3)
    video = Swin3DConfig(depths=(1,) * 6, drop_path_rate=0.0, local_window=4 if stage == 1 else 8)
    return LfVilaConfig(video=video, bert=bert, stage=stage, dtype=torch.float32)


def lfvila_5d_batch(cfg, seed: int, batch: int = 2, sentence_len: int = 50):
    """A numpy batch of ``batch`` u8 clips of 32 frames at 192x320 with
    paragraphs of ``sample_clip`` sentences (and MLM labels in stage 2), and
    explicit MTC clip indices (key, value, other)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M, L = cfg.sample_clip, sentence_len
    out = {"video_frames": rng.integers(0, 256, size=(batch, cfg.sample_frame, 192, 320, 3), dtype=np.uint8),
           "text_ids": rng.integers(1, cfg.bert.vocab_size, size=(batch, M, L)),
           "attention_mask": (np.arange(L)[None, None] < rng.integers(5, L + 1, size=(batch, M, 1))).astype(np.int64)}
    if cfg.stage == 2:
        out["mlm_labels"] = np.where(rng.random((batch, M * L)) < 0.15,
                                     rng.integers(1, cfg.bert.vocab_size, size=(batch, M * L)), -100)
    perms = np.stack([rng.permutation(M) for _ in range(3 * batch)])
    indices = (perms[:batch, :cfg.num_key], perms[batch:2 * batch, :cfg.num_value], perms[2 * batch:, 0])
    return out, indices


def lfvila_stage1_phase(card: str) -> tuple[dict, dict]:
    """Phase 4e: ``run_pretrain_lfvila --stage 1`` on the stage-1 preset at its
    batch (16, no remat: about 40 GiB), 5 steps; returns (launch counts, step
    times, peak memory and the op-class table of the profiled step)."""
    import torch

    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(REPO, STAGE_PRESETS[1])) as f:
            batch = json.load(f)["train_batch_size"]
        state, stage1_launches, plain_calls, ms, _ = run_pretrain_stage(1, batch, out_dir, [])
        print(f"  preset {STAGE_PRESETS[1]}, batch {batch}, no remat")
        stage1 = report_pretrain_stage(1, batch, out_dir, stage1_launches, plain_calls, ms, card,
                                       ("ct_global_loss", "ct_time_loss"))
        with open(os.path.join(out_dir, "profile", "op_classes.json")) as f:
            classes = json.load(f)["classes"]
        stage1["op_classes"] = classes
        print(f"  op classes of the profiled step (torch.profiler device time; train/profiling.py) [{card}]:")
        for row in classes:
            print(f"    {row['class']:48s} {row['device_ms_per_step']:10.3f} ms {100 * row['share']:5.1f}% "
                  f"{row['launches_per_step']:8.0f} launches")
        print(f"    device total {sum(r['device_ms_per_step'] for r in classes):.3f} ms of the profiled step")
    return stage1_launches, stage1


def lfvila_stage2_phase(card: str) -> tuple[dict, dict]:
    """Phase 4f: ``run_pretrain_lfvila --stage 2`` on the stage-2 preset with
    Swin3D remat at the preset's batch (48: about 50 GiB), 4 steps; checks
    that the frozen parameters did not move and the others did. Returns
    (launch counts, step times and peak memory)."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila
    from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths

    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(REPO, STAGE_PRESETS[2])) as f:
            stage2_preset = json.load(f)
        batch = stage2_preset["train_batch_size"]
        state, stage2_launches, plain_calls, ms, start = run_pretrain_stage(
            2, batch, out_dir, ["--gradient_checkpointing", "1"])
        print(f"  preset {STAGE_PRESETS[2]}, batch {batch}, --gradient_checkpointing 1")
        stage2 = report_pretrain_stage(2, batch, out_dir, stage2_launches, plain_calls, ms, card,
                                       ("mlm_loss", "vtm_loss", "mlm_acc", "vtm_acc"))
        # the frozen stage-1 modules did not move, bit for bit; the rest did
        frozen = [pattern.lower() for pattern in stage2_preset["frozen_patterns"]]
        paths = flax_param_paths(state.model)
        moved = {True: [], False: []}
        for name, p in state.model.named_parameters():
            is_frozen = any(pattern in paths[name].lower() for pattern in frozen)
            moved[is_frozen].append((name, not torch.equal(p, start[name])))
        n_frozen = sum(start[n].numel() for n, _ in moved[True])
        n_free = sum(start[n].numel() for n, _ in moved[False])
        print(f"  frozen: {len(moved[True])} tensors ({n_frozen / 1e6:.1f} M values), moved "
              f"{sum(m for _, m in moved[True])}; trained: {len(moved[False])} tensors ({n_free / 1e6:.1f} M), "
              f"moved {sum(m for _, m in moved[False])}")
        check(moved[True] and not any(m for _, m in moved[True]), "a frozen parameter moved")
        check(moved[False] and all(m for _, m in moved[False]),
              f"trained parameters that did not move: {[n for n, m in moved[False] if not m][:5]}")
        del state, start
        stage2["graphed"] = graphed_rerun(
            "4r LF-VILA stage 2 (remat)", run_pretrain_lfvila, "GenericTrainer",
            pretrain_stage_argv(2, batch, out_dir, ["--gradient_checkpointing", "1"]), scalars(out_dir),
            stage2_launches, card)
    return stage2_launches, stage2


def lfvila_finetune_phase(card: str) -> dict:
    """Phase 4g: ``run_tasks_lfvila`` qa_mc, qa_cls (ActivityNet-QA) and
    video_cls on the kernel config with no train step (the eval paths, six
    window launches a video forward, ``TASK_EVAL_SAMPLES`` synthetic samples
    each), then 2 qa_mc train steps on the kernel-off config; returns each
    run's launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_tasks_lfvila

    task_launches = {}
    n_batches = math.ceil(TASK_EVAL_SAMPLES / LFVILA_BATCH)
    for task, args in TASK_RUNS.items():
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            dummy_size, run_tasks_lfvila.DUMMY_SIZE = run_tasks_lfvila.DUMMY_SIZE, TASK_EVAL_SAMPLES
            try:
                with plain_on_cuda_guard() as plain_cuda_calls:
                    reset_launches()
                    report = run_tasks_lfvila.main([
                        "--config", os.path.join(REPO, LFVILA_PRESET), *args, "--dummy_data", "1",
                        "--num_train_steps", "0", "--val_batch_size", str(LFVILA_BATCH), "--device", "cuda",
                        "--output_dir", out_dir,
                    ])
                    torch.cuda.synchronize()
                    task_launches[task] = launch_counts()
            finally:
                run_tasks_lfvila.DUMMY_SIZE = dummy_size
            wall = time.perf_counter() - t0
            with open(os.path.join(out_dir, "final_report.json")) as f:
                check(json.load(f)["accuracy"] == report["accuracy"], f"{task}: final_report.json")
        want = expected(window_attention_fwd=WINDOW_BLOCKS * n_batches)
        print(f"  {task}: launches {task_launches[task]} (expected {WINDOW_BLOCKS} window blocks x {n_batches} "
              f"batches, one video forward each); plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(task_launches[task] == want, f"{task} kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        print(f"  {task}: accuracy {report['accuracy']:.4f} over {report['n']} samples; eval "
              f"{report['perf']['wall_s']:.2f} s, {report['perf']['clips_per_s']:.2f} clips/s; run wall "
              f"{wall:.1f} s (host clock; model build, synthetic decode and upload included) [{card}]")
        check(report["n"] == TASK_EVAL_SAMPLES and math.isfinite(report["accuracy"])
              and 0.0 <= report["accuracy"] <= 1.0, f"{task}: accuracy {report['accuracy']}")
    # qa_mc's training: fusion, span loss and their backward on the card,
    # the kernel off (its forward has no backward), a smaller synthetic set
    with tempfile.TemporaryDirectory() as out_dir:
        dummy_size, run_tasks_lfvila.DUMMY_SIZE = run_tasks_lfvila.DUMMY_SIZE, QA_TRAIN["samples"]
        try:
            argv = ["--config", os.path.join(REPO, STAGE_PRESETS[1]), *TASK_RUNS["qa_mc"], "--dummy_data", "1",
                    "--num_train_steps", str(QA_TRAIN["steps"]), "--train_batch_size", str(QA_TRAIN["batch"]),
                    "--val_batch_size", str(QA_TRAIN["batch"]), "--log_steps", "1", "--save_steps", "1000",
                    "--device", "cuda", "--output_dir", out_dir]
            with timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_tasks_lfvila.main(argv)
                torch.cuda.synchronize()
                task_launches["qa_mc_train"] = launch_counts()
            tags = scalars(out_dir)
            graphed_rerun("4r LF-VILA qa_mc fine-tune", run_tasks_lfvila, "GenericTrainer", argv, tags,
                          task_launches["qa_mc_train"], card)
        finally:
            run_tasks_lfvila.DUMMY_SIZE = dummy_size
    print(f"  qa_mc training, kernel off, b={QA_TRAIN['batch']}: launches {task_launches['qa_mc_train']} "
          f"(expected none); plain path on CUDA: {len(plain_cuda_calls)} calls; steps "
          f"{[round(a.elapsed_time(b), 2) for a, b in events]} ms (CUDA events) [{card}]")
    for key in ("loss", "span_loss", "acc", "span_acc", "grad_norm"):
        values = tags.get(f"train/{key}", [])
        print(f"  qa_mc train {key} {[round(v, 5) for v in values]}")
        check(len(values) == QA_TRAIN["steps"] and all(math.isfinite(v) for v in values), f"qa_mc train {key}")
    check(task_launches["qa_mc_train"] == expected() and not plain_cuda_calls, "qa_mc training launches")
    check(all(tags["train/loss"][i] > tags["train/span_loss"][i] > 0 for i in range(QA_TRAIN["steps"])),
          "qa_mc: the total holds the span loss")
    check(math.isfinite(report["accuracy"]) and 0.0 <= report["accuracy"] <= 1.0, "qa_mc train accuracy")
    return task_launches


def lfvila_card_vs_cpu_phase() -> None:
    """Phase 5d: one fp32 ``LfVilaPretrain`` train step per stage on the card
    and on the CPU from the same weights and batch (explicit MTC clips), held
    to phase 5b's bars."""
    import torch
    from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaPretrain
    from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA, build_optimizer
    from xpretrain_tpu_torch.optim.schedules import get_schedule
    from xpretrain_tpu_torch.parallel.train_step import TrainState, batch_to_device, make_model_train_step

    lr = 1e-5
    for stage in (1, 2):
        cfg = lfvila_5d_config(stage)
        model_cpu = LfVilaPretrain(cfg).init_weights(torch.Generator().manual_seed(stage))
        model_gpu = copy.deepcopy(model_cpu).cuda()
        batch, indices = lfvila_5d_batch(cfg, seed=10 + stage)
        metrics = {}
        for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            optimizer, _ = build_optimizer(dict(model.named_parameters()), get_schedule("constant", lr, 10),
                                           weight_decay=0.05, no_decay_patterns=NO_DECAY_LFVILA,
                                           paths=flax_param_paths(model))
            step = make_model_train_step(
                lambda m, b, g: m(b["video_frames"], b["text_ids"], b["attention_mask"],
                                  mlm_labels=b.get("mlm_labels"), generator=g, mtc_indices=indices),
                device, metric_keys=("ct_global_loss", "ct_time_loss", "mlm_loss", "vtm_loss"))
            t0 = time.perf_counter()
            _, m = step(TrainState(step=0, model=model, optimizer=optimizer), batch_to_device(device)(batch), 0)
            metrics[device] = {k: v.item() for k, v in m.items()}
            print(f"  stage {stage} on {device}: {metrics[device]} ({time.perf_counter() - t0:.1f} s)")
        loss_err = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"])
        norm_err = abs(metrics["cuda"]["grad_norm"] / metrics["cpu"]["grad_norm"] - 1)
        cpu_state = model_cpu.state_dict()
        diffs = torch.cat([(v.cpu() - cpu_state[k]).abs().flatten() for k, v in model_gpu.state_dict().items()])
        print(f"  stage {stage}: loss diff {loss_err:.3e} (tol 1e-4), grad_norm rel diff {norm_err:.3e} "
              f"(tol 1e-3); params after the step: max diff {diffs.max().item():.3e} (tol 2 lr = {2 * lr:.0e})")
        check(all(math.isfinite(v) for v in metrics["cuda"].values()), f"stage {stage}: card metrics not finite")
        check(loss_err <= 1e-4, f"stage {stage}: train loss card vs cpu {loss_err}")
        check(norm_err <= 1e-3, f"stage {stage}: grad_norm card vs cpu rel {norm_err}")
        check(diffs.max().item() <= 2 * lr, f"stage {stage}: params after one step differ by more than 2 lr")
        del model_cpu, model_gpu, cpu_state, diffs


def clip_weights_file(path: str, seed: int = 0) -> dict:
    """Write a released-style CLIP-ViP B/32 checkpoint of a seeded port model
    to ``path``: HF keys under ``clipmodel.``, the patch weight as a Conv2d
    weight [768, 3, 32, 32], an 8-row temporal embedding (the model holds 12).
    Returns the state dict as written, without the prefix."""
    import torch
    from xpretrain_tpu_torch.models.clip_vip.convert import torch_clip_state_dict
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    model = CLIPViPModel(CLIPVipConfig.base_patch32())
    model.init_weights(torch.Generator().manual_seed(seed))
    sd = torch_clip_state_dict(model)
    g = torch.Generator().manual_seed(seed + 1)
    width = model.config.vision.hidden_size
    sd["vision_model.embeddings.temporal_embedding"] = 0.02 * torch.randn(1, 8, width, generator=g)
    torch.save({"clipmodel." + k: v for k, v in sd.items()}, path)
    return sd


def clipvip_pretrain_phase(card: str) -> tuple[dict, dict]:
    """Phase 4h: ``run_pretrain_clipvip`` on the B/32 pretraining preset for
    ``PRETRAIN_CLIPVIP_STEPS`` steps from a written ``--clip_weights`` file;
    returns (launch counts, step times and peak memory)."""
    import numpy as np
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_clipvip
    from xpretrain_tpu_torch.models.clip_vip.convert import _interp_temporal
    from xpretrain_tpu_torch.train import trainer as trainer_module
    from xpretrain_tpu_torch.tools.profile_train_step import median

    steps = PRETRAIN_CLIPVIP_STEPS
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "clipvip_b32.pt")
        t0 = time.perf_counter()
        written = clip_weights_file(path)
        print(f"  wrote {path.split('/')[-1]}: {len(written)} tensors, "
              f"{sum(v.numel() for v in written.values()) / 1e6:.1f} M values ({time.perf_counter() - t0:.1f} s)")
        with open(os.path.join(REPO, PRETRAIN_PRESET)) as f:
            preset = json.load(f)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with after_call(run_pretrain_clipvip, "load_pretrained") as loaded, \
                timed_train_steps(trainer_module, "make_train_step") as events, \
                plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            argv = ["--config", os.path.join(REPO, PRETRAIN_PRESET), "--dummy_data", "1",
                    "--clip_weights", path, "--num_train_steps", str(steps), "--log_steps", "1",
                    "--save_steps", "1000", "--valid_steps", "1000", "--device", "cuda", "--output_dir", out_dir]
            state = run_pretrain_clipvip.main(argv)
            torch.cuda.synchronize()
            launches = launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        tags = scalars(out_dir)
        graphed = graphed_rerun("4r CLIP-ViP B/32 pretraining", run_pretrain_clipvip, "ClipVipTrainer", argv, tags,
                                launches, card)
    check(state.step == steps and len(loaded) == 1, f"pretraining ran {state.step} steps, loaded {len(loaded)} times")
    # the loaded model against the file: copies, the patch weight in the
    # port's layout, the temporal embedding interpolated 8 -> 12 rows
    got = {k: v.cpu() for k, v in loaded[0][0].items()}
    print(f"  load_pretrained (read, merge into the model on the card): {loaded[0][1]:.2f} s [{card}]")
    temporal = _interp_temporal(written["vision_model.embeddings.temporal_embedding"].numpy(),
                                preset["clip_vision_additional_config"]["temporal_size"])
    pairs = {
        "text_model.embeddings.token_embedding.weight": written["text_model.embeddings.token_embedding.weight"],
        "vision_model.encoder.layers.11.self_attn.q_proj.weight":
            written["vision_model.encoder.layers.11.self_attn.q_proj.weight"],
        "logit_scale": written["logit_scale"],
        "vision_model.embeddings.patch_embedding.weight":
            written["vision_model.embeddings.patch_embedding.weight"].permute(2, 3, 1, 0),
        "vision_model.embeddings.temporal_embedding": torch.from_numpy(temporal.astype(np.float32)),
    }
    for key, want in pairs.items():
        same = torch.equal(got[key], want)
        print(f"  loaded {key} {tuple(got[key].shape)}: equal to the file's: {same}")
        check(same, f"{key} is not the file's")
    check(all(torch.equal(got[k], written[k]) for k in written if k not in pairs), "a loaded parameter is not the file's")
    want = expected(proxy_attention_fwd=PROXY_LAYERS_PER_STEP * steps, proxy_attention_bwd=PROXY_LAYERS_PER_STEP * steps)
    print(f"  launches {launches} (expected {want}: {PROXY_LAYERS_PER_STEP} layers a step, {VIDEO_LAYERS} for the "
          f"video clips and {VIDEO_LAYERS} for the images, forward and backward); plain path on CUDA: "
          f"{len(plain_cuda_calls)} calls")
    check(launches == want, "pretraining kernel launch counts")
    check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    for key in ("loss", "grad_norm"):
        values = tags.get(f"train/{key}", [])
        print(f"  {key} {[round(v, 5) for v in values]}")
        check(len(values) == steps and all(math.isfinite(v) for v in values), f"pretraining {key} {values}")
    ms = [start.elapsed_time(end) for start, end in events]
    timed = ms[1:]
    sps = tags.get("train/steps_per_s", [])
    print(f"  preset {PRETRAIN_PRESET}: b={preset['train_batch_size']}, {preset['num_frm']} frames at "
          f"{preset['crop_img_size']}, bf16, {preset['loss_name']}")
    print(f"  B/32 pretraining step b={preset['train_batch_size']}: median {median(timed):.4f} ms (min "
          f"{min(timed):.4f}, max {max(timed):.4f}) over steps 2-{steps}; every step {[round(x, 2) for x in ms]} ms "
          f"(CUDA events around each step, the first a warm-up) [{card}]")
    print(f"  steps/s on the host clock, synthetic data and its host transform included: "
          f"{[round(x, 3) for x in sps]}; run wall {wall:.1f} s [{card}]")
    print(f"  peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated) [{card}]")
    check(all(math.isfinite(x) for x in ms), "pretraining step times")
    del state, loaded, got, written
    return launches, {"step_ms": timed, "peak_gib": peak, "graphed": graphed}


def swin2d_state_dict(g, embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window=7, patch=4):
    """An ImageNet Swin-B state dict (torch keys, 4 stages, 4x4 patches, 7x7
    windows), random from ``g``: what ``--swin_weight`` takes with
    ``--pretrained_2d 1``."""
    import torch

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    top = embed_dim * 2 ** (len(depths) - 1)
    sd = {"patch_embed.proj.weight": t(embed_dim, 3, patch, patch), "patch_embed.proj.bias": t(embed_dim),
          "patch_embed.norm.weight": 1 + t(embed_dim), "patch_embed.norm.bias": t(embed_dim),
          "norm.weight": 1 + t(top), "norm.bias": t(top)}
    side = 2 * window - 1
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed_dim * 2**i
        for b in range(depth):
            p = f"layers.{i}.blocks.{b}."
            for name, shape in (("norm1.weight", (c,)), ("norm1.bias", (c,)), ("attn.qkv.weight", (3 * c, c)),
                                ("attn.qkv.bias", (3 * c,)), ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                                ("attn.relative_position_bias_table", (side * side, h)), ("norm2.weight", (c,)),
                                ("norm2.bias", (c,)), ("mlp.fc1.weight", (4 * c, c)), ("mlp.fc1.bias", (4 * c,)),
                                ("mlp.fc2.weight", (c, 4 * c)), ("mlp.fc2.bias", (c,))):
                sd[p + name] = t(*shape) + (1 if name.startswith("norm") and name.endswith("weight") else 0)
        if i < len(depths) - 1:  # 2-D Swin downsamples after stages 0..2
            sd[f"layers.{i}.downsample.reduction.weight"] = t(2 * c, 4 * c)
            sd[f"layers.{i}.downsample.norm.weight"] = 1 + t(4 * c)
            sd[f"layers.{i}.downsample.norm.bias"] = t(4 * c)
    return sd


def bert_state_dict(g, layers: int, hidden=1024, intermediate=4096, vocab=30522, positions=512, types=2):
    """An HF BERT-large state dict (``bert.`` keys, ``layers`` encoder layers
    and the pooler), random from ``g``: what ``--bert_weight`` takes."""
    import torch

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"bert.embeddings.word_embeddings.weight": t(vocab, hidden),
          "bert.embeddings.position_embeddings.weight": t(positions, hidden),
          "bert.embeddings.token_type_embeddings.weight": t(types, hidden),
          "bert.embeddings.LayerNorm.weight": 1 + t(hidden), "bert.embeddings.LayerNorm.bias": t(hidden),
          "bert.pooler.dense.weight": t(hidden, hidden), "bert.pooler.dense.bias": t(hidden)}
    for i in range(layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = t(hidden, hidden), t(hidden)
        sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"] = t(intermediate, hidden), t(intermediate)
        sd[p + "output.dense.weight"], sd[p + "output.dense.bias"] = t(hidden, intermediate), t(hidden)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 1 + t(hidden), t(hidden)
    return sd


def lfvila_cascade_phase(card: str) -> dict:
    """Phase 4i: ``run_pretrain_lfvila --stage 1`` on the stage-1 preset from
    a written 2-D Swin-B (``--swin_weight``, ``--pretrained_2d 1``) and
    BERT-large (``--bert_weight``), ``CASCADE["steps"]`` steps; returns the
    launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        g = torch.Generator().manual_seed(21)
        swin, bert = swin2d_state_dict(g), bert_state_dict(g, CASCADE["bert_layers"])
        swin_path, bert_path = os.path.join(out_dir, "swin_base_2d.pth"), os.path.join(out_dir, "bert_large.bin")
        torch.save({"model": swin}, swin_path)
        torch.save(bert, bert_path)
        print(f"  wrote a 2-D Swin-B ({sum(v.numel() for v in swin.values()) / 1e6:.1f} M values) and BERT-large's "
              f"first {CASCADE['bert_layers']} layers ({sum(v.numel() for v in bert.values()) / 1e6:.1f} M values) "
              f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        with after_call(run_pretrain_lfvila, "load_lfvila_cascade") as loaded, \
                timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            state = run_pretrain_lfvila.main([
                "--config", os.path.join(REPO, STAGE_PRESETS[1]), "--stage", "1", "--dummy_data", "1",
                "--device_ingest", "1", "--train_batch_size", str(CASCADE["batch"]),
                "--num_train_steps", str(CASCADE["steps"]), "--log_steps", "1", "--save_steps", "1000",
                "--swin_weight", swin_path, "--bert_weight", bert_path, "--pretrained_2d", "1",
                "--device", "cuda", "--output_dir", out_dir,
            ])
            torch.cuda.synchronize()
            launches = launch_counts()
        wall = time.perf_counter() - t0
        tags = scalars(out_dir)
    check(state.step == CASCADE["steps"] and len(loaded) == 1, "stage 1 from the cascade: steps or loads")
    got = {k: v.cpu() for k, v in loaded[0][0].items()}
    # BERT: copied; the 2-D patch kernel 4x4 tiled to 8x8 (and kd=1), / 4
    inflated = swin["patch_embed.proj.weight"][:, :, None].repeat(1, 1, 1, 2, 2) / 4
    table = got["video_encoder.layers_2_blocks_0.attn.relative_position_bias_table"]
    spatial = 5 * 9  # stage 2's (8, 3, 5) window: (2*3-1) x (2*5-1) offsets, tiled 2*8-1 times over time
    checks = {
        "text_encoder.embeddings.word_embeddings.weight = the file's":
            torch.equal(got["text_encoder.embeddings.word_embeddings.weight"],
                        bert["bert.embeddings.word_embeddings.weight"]),
        "text_encoder.encoder.layer_11.output_dense.weight = the file's, transposed twice":
            torch.equal(got["text_encoder.encoder.layer_11.output_dense.weight"],
                        bert["bert.encoder.layer.11.output.dense.weight"]),
        "video_encoder.patch_embed.proj.weight = the 2-D kernel inflated":
            torch.allclose(got["video_encoder.patch_embed.proj.weight"], inflated, atol=1e-7, rtol=0),
        "video_encoder.layers_0_blocks_0.attn.qkv.weight = the 2-D block's":
            torch.equal(got["video_encoder.layers_0_blocks_0.attn.qkv.weight"], swin["layers.0.blocks.0.attn.qkv.weight"]),
        f"stage-2 bias table {tuple(table.shape)} tiled over time":
            table.shape[0] == 15 * spatial and all(torch.equal(table[:spatial], table[i * spatial:(i + 1) * spatial])
                                                   for i in range(15)),
    }
    for what, ok in checks.items():
        print(f"  loaded {what}: {ok}")
        check(ok, f"4i: {what}")
    print(f"  launches {launches} (expected none: the window kernel is off for training, as in JAX); plain path "
          f"on CUDA: {len(plain_cuda_calls)} calls")
    check(launches == expected() and not plain_cuda_calls, "stage 1 from the cascade: launches")
    for key in ("loss", "grad_norm", "ct_global_loss", "ct_time_loss"):
        values = tags.get(f"train/{key}", [])
        print(f"  {key} {[round(v, 5) for v in values]}")
        check(len(values) == CASCADE["steps"] and all(math.isfinite(v) for v in values), f"4i {key} {values}")
    ms = [start.elapsed_time(end) for start, end in events]
    print(f"  load_lfvila_cascade (read, inflate, convert, merge into the model on the card): {loaded[0][1]:.2f} s; "
          f"steps {[round(x, 2) for x in ms]} ms (CUDA events, the first a warm-up); run wall {wall:.1f} s at "
          f"b={CASCADE['batch']} (host clock; model build and synthetic data included) [{card}]")
    check(len(ms) == CASCADE["steps"] and all(math.isfinite(x) for x in ms), "4i step times")
    del state, loaded, got, swin, bert
    return launches


# ---------------------------------------------------------------------------
# HD-VILA (phases 4j-4m, 5e, 6e): no kernel of the six, convolutions on cuDNN
# and GEMMs on cuBLAS
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def devices_seen(cls):
    """While inside, every call of ``cls.forward`` records the device types of
    its tensor arguments and of the module's parameters: yields that set."""
    import torch

    original = cls.forward
    seen = set()

    def forward(self, *args, **kwargs):
        seen.update(a.device.type for a in (*args, *kwargs.values()) if isinstance(a, torch.Tensor))
        seen.update(p.device.type for p in self.parameters())
        return original(self, *args, **kwargs)

    cls.forward = forward
    try:
        yield seen
    finally:
        cls.forward = original


@contextlib.contextmanager
def frozen_bn_calls():
    """While inside, count from the FrozenBatchNorm modules' own calls on CUDA
    the frozen-BN kernel launches they must make: ``fwd`` one a call;
    ``bwd``, for each call whose output then receives its gradient, one for
    the backward kernel and one more for the sums' finish when the module's
    parameters train. Yields that dict."""
    import torch
    from xpretrain_tpu_torch.models.hd_vila.resnet import FrozenBatchNorm

    n = {"fwd": 0, "bwd": 0}

    def on_grad(launches: int):
        def hook(grad):
            n["bwd"] += launches

        return hook

    # a call is counted before it runs: remat's recompute stops inside a
    # block's last FrozenBatchNorm once its saved tensors are back, after the
    # launch, so no forward hook sees that call end
    def pre_hook(module, args):
        if isinstance(module, FrozenBatchNorm) and args[0].is_cuda:
            n["fwd"] += 1

    def forward_hook(module, args, out):
        if isinstance(module, FrozenBatchNorm) and out.is_cuda and out.requires_grad:
            out.register_hook(on_grad(1 + any(p.requires_grad for p in module.parameters())))

    handles = (torch.nn.modules.module.register_module_forward_pre_hook(pre_hook),
               torch.nn.modules.module.register_module_forward_hook(forward_hook))
    try:
        yield n
    finally:
        for handle in handles:
            handle.remove()


def hdvila_preset(stage: int) -> dict:
    with open(os.path.join(REPO, HDVILA_PRESETS[stage])) as f:
        return json.load(f)


def hdvila_run(module, argv: list[str]):
    """One HD-VILA runner run on the card: (its return value, launch counts,
    ms of each train step in CUDA events, host seconds). Fails on a launch of
    any of the six kernels, frozen-BN launches other than its FrozenBatchNorms'
    calls make (``frozen_bn_calls``), a call of a plain version on CUDA, or
    an encoder input or parameter off the card."""
    import torch
    from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoder
    from xpretrain_tpu_torch.utils.profiling import counts

    t0 = time.perf_counter()
    before = counts()
    with timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls, \
            devices_seen(HdVilaEncoder) as seen, frozen_bn_calls() as bn:
        reset_launches()
        out = module.main([*argv, "--device", "cuda"])
        torch.cuda.synchronize()
        launches = launch_counts()
    wall = time.perf_counter() - t0
    calls = {k: counts().get(f"xpt.frozen_bn.{k}", 0) - before.get(f"xpt.frozen_bn.{k}", 0) for k in ("kernel", "plain")}
    check(launches == expected(frozen_bn_act=bn["fwd"] + bn["bwd"]) and bn["fwd"] > 0,
          f"HD-VILA launched {launches}; its FrozenBatchNorms' calls make {bn} frozen-BN launches and none of the six")
    check(calls == {"kernel": bn["fwd"], "plain": 0},
          f"HD-VILA's FrozenBatchNorms: {calls} calls by path, {bn['fwd']} on CUDA")
    check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    check(seen == {"cuda"}, f"HD-VILA encoder inputs or parameters on {sorted(seen)}")
    return out, launches, [a.elapsed_time(b) for a, b in events], wall


def hdvila_train_report(name: str, out_dir: str, keys: tuple[str, ...], steps: int, ms: list[float], wall: float,
                        batch: int, card: str) -> dict:
    """Print and check a run's logged losses (finite, one per step), its step
    times (the first warms up), peak memory and host steps/s."""
    import torch
    from xpretrain_tpu_torch.tools.profile_train_step import median

    tags = scalars(out_dir)
    for key in ("loss", "grad_norm") + keys:
        values = tags.get(f"train/{key}", [])
        print(f"  {name} {key} {[round(v, 5) for v in values]}")
        check(len(values) == steps and all(math.isfinite(v) for v in values), f"{name}: {key} {values}")
    check(len(ms) == steps and all(math.isfinite(x) for x in ms), f"{name}: step times {ms}")
    timed = ms[1:]
    peak = torch.cuda.max_memory_allocated() / 2**30
    sps = tags["train/steps_per_s"]
    print(f"  {name} train step b={batch}: median {median(timed):.4f} ms (min {min(timed):.4f}, max {max(timed):.4f}) "
          f"over steps 2-{steps}; every step {[round(x, 2) for x in ms]} ms (CUDA events around each step, first = "
          f"warm-up) [{card}]")
    print(f"  {name}: peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); host steps/s "
          f"{[round(x, 3) for x in sps]} (the trainer's log: synthetic 640x1024 decode on the host included); run "
          f"wall {wall:.1f} s [{card}]")
    return {"batch": batch, "step_ms": timed, "peak_gib": peak, "host_steps_per_s": sps}


def hdvila_stage1_phase(card: str, ckpt_path: str) -> tuple[dict, dict]:
    """Phase 4j: ``run_pretrain_hdvila --stage 1`` on the stage-1 preset at its
    batch (8: 16 middle frames of 640x1024 and 96 neighbours of 160x256 a
    step), ``HDVILA_STEPS[1]`` steps; writes the trained model as a reference
    HDVILA checkpoint to ``ckpt_path`` for phase 4k. Returns (launch counts,
    step times and peak memory)."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_hdvila
    from xpretrain_tpu_torch.models.hd_vila.convert import hdvila_e2e_state_dict

    steps, batch = HDVILA_STEPS[1], hdvila_preset(1)["train_batch_size"]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        argv = ["--config", os.path.join(REPO, HDVILA_PRESETS[1]), "--stage", "1", "--dummy_data", "1",
                "--num_train_steps", str(steps), "--log_steps", "1", "--save_steps", "1000", "--output_dir", out_dir]
        state, launches, ms, wall = hdvila_run(run_pretrain_hdvila, argv)
        print(f"  preset {HDVILA_PRESETS[1]}, batch {batch}; launches {launches} (expected none of the six); every "
              f"parameter on the card: {all(p.is_cuda for p in state.model.parameters())}")
        check(all(p.is_cuda for p in state.model.parameters()), "4j: a parameter off the card")
        report = hdvila_train_report("stage 1", out_dir, ("itc_loss",), steps, ms, wall, batch, card)
        torch.save(hdvila_e2e_state_dict(state.model), ckpt_path)
        print(f"  wrote the trained model as a reference HDVILA checkpoint ({os.path.getsize(ckpt_path) / 2**20:.0f} "
              f"MiB)")
        del state
        report["graphed"] = graphed_rerun("4r HD-VILA stage 1", run_pretrain_hdvila, "GenericTrainer",
                                          [*argv, "--device", "cuda"], scalars(out_dir), launches, card)
    return launches, report


def hdvila_stage2_phase(card: str, ckpt_path: str) -> tuple[dict, dict]:
    """Phase 4k: ``run_pretrain_hdvila --stage 2`` on the stage-2 preset (batch
    16, 2 micro-batches accumulated per update, MLM under lse, pixel sampling
    at 160) from phase 4j's checkpoint through ``--e2e_weights_path``
    (``load_hdvila_e2e`` on the card). The frozen stage-1 modules are the
    checkpoint's, bit for bit, after the steps; the others moved."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_hdvila
    from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths, hdvila_e2e_state_dict

    preset = hdvila_preset(2)
    steps, batch, accum = HDVILA_STEPS[2], preset["train_batch_size"], preset["gradient_accumulation_steps"]
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir, snapshot_params() as snapshots, \
            after_call(run_pretrain_hdvila, "load_hdvila_e2e") as loaded:
        argv = ["--config", os.path.join(REPO, HDVILA_PRESETS[2]), "--stage", "2", "--dummy_data", "1",
                "--num_train_steps", str(steps // accum), "--e2e_weights_path", ckpt_path, "--log_steps", "1",
                "--save_steps", "1000", "--output_dir", out_dir]
        state, launches, ms, wall = hdvila_run(run_pretrain_hdvila, argv)
        print(f"  preset {HDVILA_PRESETS[2]}: batch {batch}, {accum} micro-batches per update, score_agg_func "
              f"{preset['score_agg_func']}, pixel_random_sampling_size {preset['pixel_random_sampling_size']} (the "
              f"640x1024 grid holds 10 x 16 = 160 tokens: all kept, as in JAX); launches {launches} (expected none of the six)")
        print(f"  load_hdvila_e2e (read, convert, merge into the model on the card): {loaded[0][1]:.2f} s")
        report = hdvila_train_report("stage 2", out_dir, ("mlm_loss", "mlm_acc"), steps, ms, wall, batch, card)
        eager_tags = scalars(out_dir)
    start, paths = snapshots[0], flax_param_paths(state.model)
    frozen_patterns = [p.lower() for p in preset["frozen_patterns"]]
    moved = {True: [], False: []}
    for name, p in state.model.named_parameters():
        is_frozen = any(pattern in paths[name].lower() for pattern in frozen_patterns)
        moved[is_frozen].append((name, not torch.equal(p, start[name])))
    print(f"  frozen: {len(moved[True])} tensors, moved {sum(m for _, m in moved[True])}; trained: "
          f"{len(moved[False])} tensors, moved {sum(m for _, m in moved[False])}; unmoved: "
          f"{[n for n, m in moved[False] if not m]}")
    check(moved[True] and not any(m for _, m in moved[True]), "4k: a frozen parameter moved")
    # the preset turns ITM off (use_itm 0): pooler2 and seq_relationship feed
    # only the ITM logits, so their biases have no gradient and no decay
    itm_only = ("pooler2", "seq_relationship")
    still = [n for n, m in moved[False] if not m]
    check(moved[False] and not preset["use_itm"] and all(any(k in n for k in itm_only) for n in still),
          f"4k: trained parameters that did not move: {still[:5]}")
    # the frozen part is the stage-1 model of the checkpoint, bit for bit
    ref = torch.load(ckpt_path, map_location="cpu")
    now = hdvila_e2e_state_dict(state.model)
    same = sum(torch.equal(now[key], value) for key, value in ref.items())
    print(f"  the model after the steps against the stage-1 checkpoint: {same} of its {len(ref)} tensors bit-equal")
    check(same == len(ref), "4k: the frozen modules are not the stage-1 checkpoint's")
    del state, start, snapshots, loaded, ref, now
    # accumulation at a real size: one graph per micro-step index, one memory pool
    with tempfile.TemporaryDirectory() as out_dir:
        argv[argv.index("--output_dir") + 1] = out_dir
        report["graphed"] = graphed_rerun("4r HD-VILA stage 2 (2 micro-batches an update)", run_pretrain_hdvila,
                                          "GenericTrainer", [*argv, "--device", "cuda"], eager_tags, launches, card)
    check(report["graphed"]["graphs"] == accum, f"4r HD-VILA stage 2: {report['graphed']['graphs']} graphs")
    return launches, report


def hdvila_retrieval_phase(card: str) -> dict:
    """Phase 4l: ``run_retrieval_hdvila`` on the stage-1 preset's model:
    ``--mode train`` (ITC, 3 steps at batch 8, then R@K over
    ``HDVILA_VAL_ROWS`` synthetic captions), then ``--loss_type rank`` (2
    steps of the fusion rerank head at batch 4, 3 rolled negatives).
    Returns each run's launch counts."""
    from xpretrain_tpu_torch.cli import run_retrieval_hdvila

    launches = {}
    preset = os.path.join(REPO, HDVILA_PRESETS[1])
    rows, run_retrieval_hdvila.DUMMY_VAL_ROWS = run_retrieval_hdvila.DUMMY_VAL_ROWS, HDVILA_VAL_ROWS
    try:
        for name, args, steps in (("itc", ["--num_train_steps", "3"], 3),
                                  ("rank", ["--loss_type", "rank", "--train_batch_size", "4", "--num_train_steps",
                                            "2"], 2)):
            with tempfile.TemporaryDirectory() as out_dir:
                argv = ["--config", preset, "--dummy_data", "1", *args, "--val_batch_size", "8", "--valid_steps",
                        "1000", "--log_steps", "1", "--save_steps", "1000", "--output_dir", out_dir]
                report, launches[name], ms, wall = hdvila_run(run_retrieval_hdvila, argv)
                tags = scalars(out_dir)
                graphed_rerun(f"4r HD-VILA retrieval {name}", run_retrieval_hdvila, "GenericTrainer",
                              [*argv, "--device", "cuda"], tags, launches[name], card)
            keys = ("rank_loss",) if name == "rank" else ()
            for key in ("loss", "grad_norm") + keys:
                values = tags.get(f"train/{key}", [])
                check(len(values) == steps and all(math.isfinite(v) for v in values), f"4l {name}: {key} {values}")
            recalls = {k: report["t2v"][k] for k in ("R1", "R5", "R10")}
            print(f"  {name}: losses {[round(v, 5) for v in tags['train/loss']]}; steps {[round(x, 2) for x in ms]} "
                  f"ms (CUDA events); t2v {recalls} over {HDVILA_VAL_ROWS} clips, eval {report['perf']['wall_s']:.2f} "
                  f"s; run wall {wall:.1f} s [{card}]")
            check(all(math.isfinite(v) and 0.0 <= v <= 100.0 for v in recalls.values()), f"4l {name}: R@K {recalls}")
    finally:
        run_retrieval_hdvila.DUMMY_VAL_ROWS = rows
    return launches


def hdvila_qa_phase(card: str) -> dict:
    """Phase 4m: ``run_video_qa_hdvila`` on the stage-1 preset's model: a
    multiple-choice task (5 options) and TGIF FrameQA classification (1540
    answers), 2 steps each at batch 4 with a validation at step 2, then
    ``--mode inference`` on the multiple-choice run (its args and best
    checkpoint restored). Returns each run's launch counts."""
    from xpretrain_tpu_torch.cli import run_video_qa_hdvila

    launches = {}
    preset = os.path.join(REPO, HDVILA_PRESETS[1])
    rows, run_video_qa_hdvila.DUMMY_VAL_ROWS = run_video_qa_hdvila.DUMMY_VAL_ROWS, HDVILA_VAL_ROWS
    try:
        with tempfile.TemporaryDirectory() as root:
            for task, extra in (("mc", ["--num_options", "5"]), ("frameqa", ["--num_labels", "1540"])):
                out_dir = os.path.join(root, task)
                argv = ["--config", preset, "--dummy_data", "1", "--task_type", task, *extra, "--train_batch_size",
                        "4", "--val_batch_size", "4", "--num_train_steps", "2", "--valid_steps", "2", "--log_steps",
                        "1", "--save_steps", "1000", "--output_dir", out_dir]
                report, launches[task], ms, wall = hdvila_run(run_video_qa_hdvila, argv)
                losses = scalars(out_dir).get("train/loss", [])
                print(f"  {task}: losses {[round(v, 5) for v in losses]}; steps {[round(x, 2) for x in ms]} ms (CUDA "
                      f"events); accuracy {report['accuracy']:.4f} over {report['n']} questions; run wall {wall:.1f} s "
                      f"[{card}]")
                check(len(losses) == 2 and all(math.isfinite(v) for v in losses), f"4m {task}: losses {losses}")
                check(report["n"] == HDVILA_VAL_ROWS and 0.0 <= report["accuracy"] <= 1.0, f"4m {task}: {report}")
                graphed_rerun(f"4r HD-VILA video QA {task}", run_video_qa_hdvila, "GenericTrainer",
                              [*argv, "--device", "cuda"], scalars(out_dir), launches[task], card)
            again, launches["mc_inference"], _, wall = hdvila_run(run_video_qa_hdvila, [
                "--mode", "inference", "--output_dir", os.path.join(root, "mc")])
            print(f"  mc --mode inference: accuracy {again['accuracy']:.4f} over {again['n']} questions from the run's "
                  f"best checkpoint; run wall {wall:.1f} s [{card}]")
            check(again["n"] == HDVILA_VAL_ROWS and 0.0 <= again["accuracy"] <= 1.0, f"4m inference: {again}")
            check(os.path.exists(os.path.join(root, "mc", "inference_report.json")), "4m: inference_report.json")
    finally:
        run_video_qa_hdvila.DUMMY_VAL_ROWS = rows
    return launches


def hdvila_full_width(stage: int, bf16: bool, device: str, seed: int = 0):
    """The stage's ``HdVilaPretrainModel`` at the preset's widths and depth on
    ``device``, seeded; fp32 models have dropout off (the card's and the
    CPU's generators draw different masks)."""
    import torch
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel, hdvila_configs_from

    enc, model_cfg = hdvila_configs_from({**hdvila_preset(stage), "bf16": int(bf16)})
    if not bf16:
        model_cfg = dataclasses.replace(model_cfg, bert=dataclasses.replace(
            model_cfg.bert, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))
    model = HdVilaPretrainModel(enc, model_cfg, temp=model_cfg.temp, device=device)
    return model.init_weights(torch.Generator(device=device).manual_seed(seed))


def hdvila_batch(stage: int, batch: int, clips: int, device: str, seed: int = 0) -> dict:
    """A synthetic batch at the preset's shapes on ``device``: uint8 middles
    [batch, clips, 3, 640, 1024] and neighbours [batch, clips, 6, 3, 160,
    256], 50-token texts (and MLM labels in stage 2)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    p = hdvila_preset(stage)
    h, w = p["crop_size"]
    L = p["max_txt_len"]
    out = {"img_middle": torch.randint(0, 256, (batch, clips, 3, h, w), generator=g, device=device, dtype=torch.uint8),
           "img_other": torch.randint(0, 256, (batch, clips, p["num_frm"] - 1, 3, h // 4, w // 4), generator=g,
                                      device=device, dtype=torch.uint8),
           "text_input_ids": torch.randint(1, 30522, (batch, L), generator=g, device=device),
           "text_input_mask": (torch.arange(L, device=device)[None] < torch.randint(
               8, L + 1, (batch, 1), generator=g, device=device)).long()}
    if stage == 2:
        masked = torch.rand(batch, L, generator=g, device=device) < 0.15
        out["mlm_labels"] = torch.where(masked, out["text_input_ids"], torch.full_like(out["text_input_ids"], -100))
    return out


def hdvila_apply(model, batch, generator):
    return model(batch["img_middle"], batch["img_other"], batch["text_input_ids"], batch["text_input_mask"],
                 mlm_labels=batch.get("mlm_labels"), generator=generator)


def hdvila_card_vs_cpu_phase() -> None:
    """Phase 5e: one fp32 train step of the stage-1 and the stage-2
    pretraining model at the presets' widths and depth, on the card and on
    the CPU, from the same weights and batch (2 samples of one clip: the ITC
    loss of a single pair is 0 whatever the weights). The loss within 1e-5;
    stage 1's gradient norm within 1e-4 relative."""
    import torch
    from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths
    from xpretrain_tpu_torch.optim.optimizer import build_optimizer
    from xpretrain_tpu_torch.optim.schedules import get_schedule
    from xpretrain_tpu_torch.parallel.train_step import TrainState, make_model_train_step

    for stage in (1, 2):
        model_cpu = hdvila_full_width(stage, bf16=False, device="cpu", seed=stage)
        model_gpu = copy.deepcopy(model_cpu).cuda()
        batch = hdvila_batch(stage, 2, 1, "cpu", seed=20 + stage)
        metrics = {}
        for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            optimizer, _ = build_optimizer(dict(model.named_parameters()), get_schedule("constant", 1e-5, 10),
                                           weight_decay=0.01, paths=flax_param_paths(model))
            step = make_model_train_step(hdvila_apply, device, metric_keys=("itc_loss", "mlm_loss"))
            t0 = time.perf_counter()
            _, m = step(TrainState(step=0, model=model, optimizer=optimizer),
                        {k: v.to(device) for k, v in batch.items()}, 0)
            metrics[device] = {k: v.item() for k, v in m.items()}
            print(f"  stage {stage} on {device}: {metrics[device]} ({time.perf_counter() - t0:.1f} s)")
        loss_err = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"])
        norm_err = abs(metrics["cuda"]["grad_norm"] / metrics["cpu"]["grad_norm"] - 1)
        print(f"  stage {stage}: loss diff {loss_err:.3e} (tol 1e-5), grad_norm rel diff {norm_err:.3e}"
              f"{' (tol 1e-4)' if stage == 1 else ''}")
        check(all(math.isfinite(v) for v in metrics["cuda"].values()), f"5e stage {stage}: card metrics not finite")
        check(metrics["cpu"]["loss"] > 0, f"5e stage {stage}: a zero loss checks nothing")
        check(loss_err <= 1e-5, f"5e stage {stage}: loss card vs cpu {loss_err}")
        check(stage == 2 or norm_err <= 1e-4, f"5e stage 1: grad_norm card vs cpu rel {norm_err}")
        del model_cpu, model_gpu, batch


def frozen_bn_inputs(form: str, seed: int = 0):
    """bf16 channels_last maps of ``FROZEN_BN_SHAPE`` (x, the identity or
    None, an output gradient) and fp32 per-channel (inv, shift) of both signs."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    _, with_identity = FROZEN_BN_FORMS[form]

    def maps():
        return torch.randn(FROZEN_BN_SHAPE, device="cuda", generator=g).to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    C = FROZEN_BN_SHAPE[1]
    x, identity, grad = maps(), maps() if with_identity else None, maps()
    inv = torch.randn(C, device="cuda", generator=g) * 0.5 + 1.0
    shift = torch.randn(C, device="cuda", generator=g) * 0.5
    return x, identity, grad, inv, shift


def frozen_bn_module(seed: int):
    """A FrozenBatchNorm of ``FROZEN_BN_SHAPE``'s channels on the card, its
    statistics seeded: scales and shifts of both signs, so a ReLU zeroes
    part of every channel."""
    import torch
    from xpretrain_tpu_torch.models.hd_vila.resnet import FrozenBatchNorm

    C = FROZEN_BN_SHAPE[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    bn = FrozenBatchNorm(C, device="cuda")
    with torch.no_grad():
        bn.scale.copy_(torch.randn(C, device="cuda", generator=g) * 0.5 + 1.0)
        bn.bias.copy_(torch.randn(C, device="cuda", generator=g) * 0.5)
        bn.mean.copy_(torch.randn(C, device="cuda", generator=g) * 0.3)
        bn.var.copy_(torch.rand(C, device="cuda", generator=g) * 1.5 + 0.5)
    return bn


def frozen_bn_module_check(form: str, layout, seed: int) -> dict:
    """``FrozenBatchNorm(x, relu, identity)`` under autograd at
    ``FROZEN_BN_SHAPE`` in bf16, maps in ``layout``, against
    ``frozen_bn_act_plain`` in float32 on the kernel's own per-channel values
    (inv and shift rounded to bf16, autograd's gradient through the fp32
    ones): y, dx and the identity's gradient within ``BF16_MAX_ULP``, the
    gradients of scale, bias, mean and var within 1e-3 of their norms (the
    kernel sums over N*H*W per block, then across blocks, in another order).
    Also the same call with the parameters frozen: no sums (one launch
    fewer), dx and the identity's gradient bit-equal. Returns the readings."""
    import torch
    from xpretrain_tpu_torch.ops import frozen_bn as fb

    relu, with_identity = FROZEN_BN_FORMS[form]
    params = ("scale", "bias", "mean", "var")
    x, identity, grad, _, _ = frozen_bn_inputs(form, seed=seed)
    x = x.contiguous(memory_format=layout)
    identity = None if identity is None else identity.contiguous(memory_format=layout)
    maps = [x.requires_grad_()] + ([identity.requires_grad_()] if with_identity else [])
    bn = frozen_bn_module(seed)
    got = {}
    for frozen in (True, False):  # trainable last: the reference below takes their gradients
        for name in params:
            getattr(bn, name).requires_grad_(not frozen)
        leaves = maps + ([] if frozen else [getattr(bn, name) for name in params])
        launches = fb.frozen_bn_act.launches
        y = bn(x, relu=relu, identity=identity)
        grads = torch.autograd.grad(y, leaves, grad)
        torch.cuda.synchronize()
        got[frozen] = (y.detach(), grads, fb.frozen_bn_act.launches - launches)
        del y
    y, grads, launches = got[False]
    check(launches == 3 and got[True][2] == 2, f"3f {form}: launches {launches} (frozen {got[True][2]}), expected 3 "
          f"(2 frozen)")
    check(y.is_contiguous(memory_format=torch.channels_last), f"3f {form}: output strides {y.stride()}")
    inv = torch.rsqrt(bn.var + bn.eps) * bn.scale
    shift = bn.bias - bn.mean * inv
    inv_r = inv + (inv.to(torch.bfloat16).float() - inv).detach()
    shift_r = shift + (shift.to(torch.bfloat16).float() - shift).detach()
    fmaps = [t.detach().float().requires_grad_() for t in maps]
    want = fb.frozen_bn_act_plain(fmaps[0], inv_r, shift_r, relu, fmaps[1] if with_identity else None)
    wgrads = torch.autograd.grad(want, fmaps + [getattr(bn, name) for name in params], grad.float())
    names = ["x"] + (["identity"] if with_identity else [])
    ulps = {"y": bf16_grad_ulps(y, want.detach())}
    del want
    ulps.update({f"d{n}": bf16_grad_ulps(a, b) for n, a, b in zip(names, grads, wgrads)})
    rel = {f"d{n}": ((a - b).norm() / b.norm()).item() for n, a, b in zip(params, grads[len(maps):], wgrads[len(maps):])}
    frozen_same = all(torch.equal(a, b) for a, b in zip(grads[:len(maps)], got[True][1]))
    check(all(u <= BF16_MAX_ULP for u in ulps.values()) and all(r <= 1e-3 for r in rel.values()) and frozen_same,
          f"3f {form} {layout}: FrozenBatchNorm against float32 plain: ulps {ulps}, parameters rel {rel}, frozen "
          f"bit-equal {frozen_same}")
    return {"ulps": ulps, "rel": rel}


def frozen_bn_check_phase(card: str) -> dict:
    """Phase 3f: the frozen-BN ops at ``FROZEN_BN_SHAPE`` in each form against
    their plain versions, then the ResNets' entry, ``FrozenBatchNorm`` with
    its wrapper, through autograd against float32 plain
    (``frozen_bn_module_check``; in each form on channels_last maps, and the
    residual form on contiguous ones too), and one forward of the stage-1
    model with every FrozenBatchNorm on the kernel. Returns the worst bf16
    ulps of the ops' outputs per form."""
    import torch
    from xpretrain_tpu_torch.ops import frozen_bn as fb
    from xpretrain_tpu_torch.utils.profiling import counts

    worst = {}
    for form, (relu, with_identity) in FROZEN_BN_FORMS.items():
        x, identity, grad, inv, shift = frozen_bn_inputs(form, seed=len(worst))
        before = fb.frozen_bn_act.launches
        y = torch.ops.xpt.frozen_bn_act_fwd(x, inv, shift, identity, relu)
        runs = [torch.ops.xpt.frozen_bn_act_bwd(grad, y if relu else None, x, inv, with_identity) for _ in range(2)]
        torch.cuda.synchronize()
        check(fb.frozen_bn_act.launches == before + 5, f"3f {form}: {fb.frozen_bn_act.launches - before} launches")
        a, b = inv.to(torch.bfloat16).float(), shift.to(torch.bfloat16).float()
        want = x.float() * a[:, None, None] + b[:, None, None]
        if with_identity:
            want += identity.float()
        if relu:
            want.relu_()
        ulps = bf16_grad_ulps(y, want)
        del want
        dx, d_identity, sums = runs[0]
        ref = fb.frozen_bn_act_bwd_plain(grad, y if relu else None, x, inv, with_identity)
        sums_rel = ((sums - ref[2]).norm(dim=1) / ref[2].norm(dim=1)).max().item()
        same = all(torch.equal(p, q) for p, q in zip(*runs))
        exact = torch.equal(dx, ref[0]) and (not with_identity or torch.equal(d_identity, ref[1]))
        worst[form] = ulps
        print(f"  {form:14s} ops, bf16 {list(FROZEN_BN_SHAPE)} channels_last: output {ulps:.3f} ulp of float32 (tol "
              f"{BF16_MAX_ULP:.0f}); dx{' and d_identity' if with_identity else ''} bit-equal to the plain "
              f"backward: {exact}; parameter sums rel {sums_rel:.2e} (tol 1e-5); two runs bit-equal: {same}")
        check(ulps <= BF16_MAX_ULP and exact and sums_rel <= 1e-5 and same, f"3f {form}: frozen-BN kernels")
        del x, identity, grad, y, runs, ref, dx, d_identity, sums
        release_memory()
    cases = [(form, torch.channels_last) for form in FROZEN_BN_FORMS] + [("relu_identity", torch.contiguous_format)]
    for i, (form, layout) in enumerate(cases):
        r = frozen_bn_module_check(form, layout, seed=10 + i)
        print(f"  {form:14s} FrozenBatchNorm under autograd, bf16 {list(FROZEN_BN_SHAPE)} {str(layout)[6:]} in: bf16 "
              f"ulps of float32 plain {({k: round(v, 3) for k, v in r['ulps'].items()})} (tol {BF16_MAX_ULP:.0f}); "
              f"parameters' gradients rel {({k: f'{v:.2e}' for k, v in r['rel'].items()})} (tol 1e-3); 3 launches, "
              f"2 with the parameters frozen (dx bit-equal) [{card}]")
        release_memory()
    model = hdvila_full_width(1, bf16=True, device="cuda")
    batch = hdvila_batch(1, 1, hdvila_preset(1)["train_n_clips"], "cuda", seed=4)
    before, launches = counts(), fb.frozen_bn_act.launches
    with torch.no_grad(), plain_on_cuda_guard() as plain_cuda_calls:
        model.forward_video(batch["img_middle"], batch["img_other"])
    torch.cuda.synchronize()
    launches = fb.frozen_bn_act.launches - launches
    calls = {k: counts().get(f"xpt.frozen_bn.{k}", 0) - before.get(f"xpt.frozen_bn.{k}", 0) for k in ("kernel", "plain")}
    print(f"  one forward of the stage-1 model (bf16, 1 sample): FrozenBatchNorm calls {calls}, frozen-BN launches "
          f"{launches} (expected kernel 96, plain 0, 96 launches) [{card}]")
    check(calls == {"kernel": 96, "plain": 0} and launches == 96 and not plain_cuda_calls,
          f"3f: FrozenBatchNorm calls {calls}, {launches} launches")
    del model, batch
    release_memory()
    return worst


def marked_device_ms(fn, iters: int):
    """Device time per call of ``fn`` (ms), or None: a profiled window of
    ``iters`` calls, a sleep kernel, then ``iters`` more, summed over every
    device event after the sleep; up to ``PROFILE_ATTEMPTS`` windows. Late in
    a whole run the profiler lost a window's first few dozen kernel records
    (see ``replays_against_device``), and in phase 6h it twice recorded no
    device event at all (ten one-launch calls read 0 ms; a window held no
    sleep kernel): None then, as the time was not measured."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()  # the window's first records, which the profiler may lose
            torch.cuda._sleep(1_000_000)
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        if marks and len(events) > marks[-1] + 1:
            return sum(e.time_range.elapsed_us() for e in events[marks[-1] + 1:]) / 1e3 / iters
    return None


def frozen_bn_timing_phase(card: str) -> dict:
    """Phase 6h: the frozen-BN kernels at ``FROZEN_BN_SHAPE`` in the bn3 form
    (+ identity, ReLU): the forward op, and forward + backward through
    autograd with the four parameters' gradients, against the plain version
    (the module's eager arithmetic before the fusion); each in CUDA events
    and, where the profiler records it, in device time (``marked_device_ms``),
    and the bound of its bytes (forward: x, identity, y;
    backward: g, y, x, dx, d_identity; each once). Returns the summary's
    fields for the kernel (ms: forward + backward)."""
    import torch
    from xpretrain_tpu_torch.ops import frozen_bn as fb

    x, identity, grad, inv, shift = frozen_bn_inputs("relu_identity", seed=9)
    leaves = [t.detach().requires_grad_() for t in (x, identity, inv, shift)]

    def kernel_fwd():
        return fb.frozen_bn_act(x, inv, shift, True, identity)

    def plain_fwd():
        return fb.frozen_bn_act_plain(x, inv, shift, True, identity)

    def kernel_fwd_bwd():
        xl, il, vl, sl = leaves
        torch.autograd.grad(fb.frozen_bn_act(xl, vl, sl, True, il), leaves, grad)

    def plain_fwd_bwd():
        xl, il, vl, sl = leaves
        torch.autograd.grad(fb.frozen_bn_act_plain(xl, vl, sl, True, il), leaves, grad)

    fns = {"kernel": kernel_fwd, "plain": plain_fwd, "kernel_fwd_bwd": kernel_fwd_bwd,
           "plain_fwd_bwd": plain_fwd_bwd}
    runs = alternate(fns, iters=20)
    ms = {name: mean(r) for name, r in runs.items()}
    dev = {name: marked_device_ms(fn, iters=10) for name, fn in fns.items()}
    check(all(math.isfinite(v) and v > 0 for v in ms.values()) and all(v is None or v > 0 for v in dev.values()),
          f"6h: frozen-BN timing {ms} {dev}")

    def device(name):
        return "not measured: the profiler recorded no device event" if dev[name] is None else f"{dev[name]:.4f}"

    n = math.prod(FROZEN_BN_SHAPE)
    fwd_bound, by = bound_ms(3 * n, 3 * n * 2)
    bwd_bound, _ = bound_ms(3 * n, 5 * n * 2)
    for what, k, p, bound in (("forward", "kernel", "plain", fwd_bound),
                              ("forward + backward", "kernel_fwd_bwd", "plain_fwd_bwd", fwd_bound + bwd_bound)):
        shares = {name: "" if dev[name] is None else f", {bound / dev[name]:.3f} of its device time" for name in (k, p)}
        print(f"  {what:18s} bf16 {list(FROZEN_BN_SHAPE)} + identity, ReLU: kernel {ms[k]:.4f} ms (device "
              f"{device(k)}), plain {ms[p]:.4f} ms (device {device(p)}); bound {bound:.4f} ms ({by}, "
              f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s): share {bound / ms[k]:.3f} of the kernel's CUDA-event time"
              f"{shares[k]}, {bound / ms[p]:.3f} of the plain's{shares[p]}; windows {runs[k]} / {runs[p]} [{card}]")
    del x, identity, grad, leaves
    release_memory()
    return {"ms": ms["kernel_fwd_bwd"], "device_ms": dev["kernel_fwd_bwd"], "plain_ms": ms["plain_fwd_bwd"],
            "plain_device_ms": dev["plain_fwd_bwd"], "fwd_ms": ms["kernel"], "fwd_device_ms": dev["kernel"],
            "fwd_plain_ms": ms["plain"], "bound_ms": fwd_bound + bwd_bound, "fwd_bound_ms": fwd_bound,
            "bound_by": by}


def train_cell_optimizer(config: str, out_dir: str):
    """The GroupedAdamW of the train cell over ``benchmark/configs/<config>.json``,
    on the card, with the model at its initial weights: the trainer as the
    cell's program builds it (its preset, its no-decay patterns and paths)."""
    from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer

    with open(os.path.join(REPO, "benchmark", "configs", f"{config}.json")) as f:
        cfg = json.load(f)
    if config == "clipvip_b32":
        from xpretrain_tpu_torch.train.trainer import ClipVipTrainer

        return ClipVipTrainer({**cfg["preset"], "output_dir": out_dir}, train_loader=None, device="cuda").optimizer
    if config == "lfvila_stage1":
        from xpretrain_tpu_torch.cli.run_pretrain_lfvila import lfvila_config_from
        from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
        from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaPretrain
        from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA

        preset = {**cfg["preset"]["train"], "output_dir": out_dir}
        model = LfVilaPretrain(lfvila_config_from(preset), device="cuda")
        return GenericTrainer(preset, model, None, None, no_decay_patterns=NO_DECAY_LFVILA,
                              param_paths=flax_param_paths(model), device="cuda").optimizer
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel, hdvila_configs_from
    from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths

    preset = {**cfg["preset"], "output_dir": out_dir}
    enc_cfg, model_cfg = hdvila_configs_from(preset)
    model = HdVilaPretrainModel(enc_cfg, model_cfg, temp=model_cfg.temp, device="cuda")
    return GenericTrainer(preset, model, None, None, param_paths=flax_param_paths(model), device="cuda").optimizer


def adamw_grads(optimizer, call: int) -> list:
    """Seeded gradients for every parameter of ``optimizer``, fp32 on the
    card: at 1e-4 (a norm below the cells' clip of 1-5 for up to 2.5e9
    elements) except the second call's, at 1 (far above: the clip scales)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(100 + call)
    scale = 1.0 if call == 1 else 1e-4
    return [torch.randn(t.shape, generator=g, device="cuda") * scale for t in optimizer.targets]


def fp32_ulps(a, b) -> int:
    """Largest distance between two fp32 tensors in units in the last place."""
    import torch

    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() else 0


def adamw_foreach_update(optimizer, grads: list) -> None:
    """``optimizer``'s device part of one update (no accumulation) through
    its ``_foreach`` chain on the card, the kernel's reference: the norm, the
    chain, the stored copies."""
    grads = optimizer.upcast(grads)
    gnorm = optimizer.grad_norm(grads) if optimizer.max_grad_norm is not None else None
    optimizer._update_plain(grads, gnorm)
    optimizer._store()


def adamw_against_foreach(optimizer, what: str, apply=None) -> int:
    """``ADAMW_UPDATES`` updates of ``optimizer``: each from one state and
    one set of gradients, through the kernel (``apply(grads)``, default
    ``optimizer.apply``) and through the ``_foreach`` path; moments
    bit-equal, parameters within ``ADAMW_MAX_ULP``, every trained leaf on the
    kernel in ceil(leaves / 512) launches. The state carries on from the
    ``_foreach`` path's. Returns the largest parameter distance."""
    import torch
    from xpretrain_tpu_torch.optim import adamw_kernel
    from xpretrain_tpu_torch.utils.profiling import counts

    trained = sum(len(idx) for idx in optimizer.groups.values())
    worst = 0
    for call in range(ADAMW_UPDATES):
        grads = adamw_grads(optimizer, call)
        state = [*optimizer.targets, *optimizer.mu, *optimizer.nu]
        start = [t.clone() for t in state]
        optimizer.prepare()
        before, launches = counts(), adamw_kernel.adamw_multi_tensor.launches
        (apply or optimizer.apply)(grads)
        torch.cuda.synchronize()
        after = counts()
        kernel = after.get("xpt.adamw.kernel", 0) - before.get("xpt.adamw.kernel", 0)
        plain = after.get("xpt.adamw.plain", 0) - before.get("xpt.adamw.plain", 0)
        n_launches = adamw_kernel.adamw_multi_tensor.launches - launches
        got = [t.clone() for t in state]
        for t, s0 in zip(state, start):
            t.copy_(s0)
        adamw_foreach_update(optimizer, grads)
        optimizer.advance()
        torch.cuda.synchronize()
        n = len(optimizer.targets)
        moments_equal = all(torch.equal(a, b) for a, b in zip(got[n:], state[n:]))
        ulps = max(fp32_ulps(a, b) for a, b in zip(got[:n], state[:n]))
        worst = max(worst, ulps)
        print(f"  {what} update {call}: {trained} trained leaves, kernel {kernel}, plain {plain}, {n_launches} "
              f"launches; moments bit-equal {moments_equal}, parameters within {ulps} ulp of the _foreach path")
        if apply is None:
            check(kernel == trained and plain == 0 and n_launches == -(-trained // adamw_kernel.MAX_LEAVES),
                  f"3g {what}: kernel {kernel} plain {plain} launches {n_launches} of {trained} trained leaves")
        check(moments_equal and ulps <= ADAMW_MAX_ULP, f"3g {what} update {call}: moments equal {moments_equal}, "
              f"parameters {ulps} ulp (tol {ADAMW_MAX_ULP})")
    return worst


def adamw_check_phase(card: str) -> dict:
    """Phase 3g: the AdamW kernel against the ``_foreach`` path at the three
    train cells' optimizers, the B/32 one also with bf16 moments and
    captured in a CUDA graph. Returns the largest parameter distance (ulp)
    by case."""
    import torch
    from xpretrain_tpu_torch.optim import adamw_kernel
    from xpretrain_tpu_torch.optim.optimizer import GroupedAdamW

    worst = {}
    with tempfile.TemporaryDirectory() as out_dir, torch.no_grad():
        for config, cell in ADAMW_CELLS.items():
            optimizer = train_cell_optimizer(config, out_dir)
            n = sum(optimizer.targets[i].numel() for idx in optimizer.groups.values() for i in idx)
            print(f"  {cell}: {len(optimizer.targets)} leaves, {sum(len(i) for i in optimizer.groups.values())} "
                  f"trained in {len(optimizer.groups)} groups, {n / 1e6:.1f} M trained elements, clip "
                  f"{optimizer.max_grad_norm}")
            worst[cell] = adamw_against_foreach(optimizer, cell)
            if config == "clipvip_b32":
                named = {name: t.detach().clone() for name, t in zip(optimizer.names, optimizer.targets)}
                bf16 = GroupedAdamW(named, dict(zip(optimizer.names, optimizer.labels)), optimizer.schedule,
                                    0.2, (optimizer.b1, optimizer.b2), optimizer.eps, 1.0, optimizer.max_grad_norm,
                                    moment_dtype=torch.bfloat16)
                worst[f"{cell} bf16 moments"] = adamw_against_foreach(bf16, f"{cell} bf16 moments")
                del bf16, named
                worst[f"{cell} CUDA graph"] = adamw_graph_check(optimizer, cell)
            del optimizer
            release_memory()
    check(adamw_kernel.adamw_multi_tensor.launches > 0, "3g: the AdamW kernel never launched")
    return worst


def adamw_graph_check(optimizer, cell: str) -> int:
    """The kernel's update (gradient norm and kernel) captured in a CUDA
    graph on static gradients and replayed, held to the ``_foreach`` path as
    ``adamw_against_foreach``; each replay adds the capture's launches."""
    import torch
    from xpretrain_tpu_torch.optim import adamw_kernel

    static = [torch.zeros_like(t) for t in optimizer.targets]

    def run():
        optimizer.apply(static, optimizer.grad_norm(static))

    state = [*optimizer.targets, *optimizer.mu, *optimizer.nu]
    start = [t.clone() for t in state]
    optimizer.prepare()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = adamw_kernel.adamw_multi_tensor.launches
    with torch.cuda.graph(graph):
        run()
    captured = adamw_kernel.adamw_multi_tensor.launches - launches
    adamw_kernel.adamw_multi_tensor.launches = launches
    for t, s0 in zip(state, start):
        t.copy_(s0)
    check(captured > 0, f"3g {cell} CUDA graph: the capture recorded no AdamW launch")

    def replay(grads):
        for buf, g in zip(static, grads):
            buf.copy_(g)
        graph.replay()
        adamw_kernel.adamw_multi_tensor.launches += captured

    before = adamw_kernel.adamw_multi_tensor.launches
    worst = adamw_against_foreach(optimizer, f"{cell} CUDA graph", apply=replay)
    check(adamw_kernel.adamw_multi_tensor.launches - before == ADAMW_UPDATES * captured,
          f"3g {cell} CUDA graph: launches counted at replay")
    del graph, static
    return worst


def adamw_timing_phase(card: str) -> dict:
    """Phase 6i: at each train cell's optimizer, the AdamW kernel alone and
    the ``_foreach`` chain alone on the same leaves (``plain``), both after
    the gradient norm's pass too (the whole update), and
    ``torch.optim.AdamW(fused=True)`` on the same leaves (yardstick only: its
    update has no clip or groups), in CUDA events and device time, against
    the bytes' bound: 28 B an element for the update, 4 B more for the norm.
    Returns the summary's fields by cell."""
    import torch
    from xpretrain_tpu_torch.optim import adamw_kernel

    out = {}
    with tempfile.TemporaryDirectory() as out_dir, torch.no_grad():
        for config, cell in ADAMW_CELLS.items():
            optimizer = train_cell_optimizer(config, out_dir)
            grads = adamw_grads(optimizer, 0)
            gnorm = optimizer.grad_norm(grads)
            optimizer.prepare()
            index = [i for idx in optimizer.groups.values() for i in idx]
            group_of = {i: (2 + group, wd) for group, ((_, wd), idx) in enumerate(optimizer.groups.items())
                        for i in idx}
            table = adamw_kernel.LeafTable([optimizer.targets[i] for i in index], [optimizer.mu[i] for i in index],
                                           [optimizer.nu[i] for i in index], [group_of[i][0] for i in index],
                                           [group_of[i][1] for i in index], optimizer.scalars.device)
            trained = [optimizer.targets[i] for i in index]
            n = sum(t.numel() for t in trained)
            fused = torch.optim.AdamW(trained, lr=1e-5, betas=(optimizer.b1, optimizer.b2), eps=optimizer.eps,
                                      weight_decay=0.01, fused=True)
            for t, i in zip(trained, index):
                t.grad = grads[i]

            def whole_plain():
                adamw_foreach_update(optimizer, grads)

            fns = {"kernel": lambda: adamw_kernel.adamw_multi_tensor(table, [grads[i] for i in index],
                                                                     optimizer.scalars, gnorm, optimizer.hyper),
                   "plain": lambda: optimizer._update_plain(grads, gnorm),
                   "whole_kernel": lambda: optimizer.apply(grads), "whole_plain": whole_plain,
                   "fused_adamw": fused.step}
            runs = alternate(fns, iters=10)
            ms = {name: mean(r) for name, r in runs.items()}
            dev = {name: marked_device_ms(fn, iters=5) for name, fn in fns.items()}
            check(all(math.isfinite(v) and v > 0 for v in ms.values()), f"6i {cell}: AdamW timing {ms}")
            bound = ADAMW_BYTES * n / HBM_BYTES_PER_S * 1e3
            whole_bound = (ADAMW_BYTES + 4) * n / HBM_BYTES_PER_S * 1e3

            def device(name):
                return "not measured" if dev[name] is None else f"{dev[name]:.4f}"

            print(f"  {cell}: {len(trained)} trained leaves, {n / 1e6:.1f} M elements; update bound {bound:.4f} ms "
                  f"({ADAMW_BYTES} B an element at {HBM_BYTES_PER_S / 1e12:.2f} TB/s) [{card}]")
            print(f"    kernel {ms['kernel']:.4f} ms (device {device('kernel')}), share of the bound "
                  f"{bound / ms['kernel']:.3f}; _foreach chain {ms['plain']:.4f} ms (device {device('plain')}); "
                  f"torch.optim.AdamW(fused=True) {ms['fused_adamw']:.4f} ms (device {device('fused_adamw')})")
            print(f"    with the norm's pass: kernel {ms['whole_kernel']:.4f} ms (device {device('whole_kernel')}), "
                  f"_foreach {ms['whole_plain']:.4f} ms (device {device('whole_plain')}); bound {whole_bound:.4f} ms; "
                  f"windows {runs['kernel']} / {runs['plain']}")
            out[cell] = {"ms": ms["kernel"], "device_ms": dev["kernel"], "plain_ms": ms["plain"],
                         "plain_device_ms": dev["plain"], "whole_ms": ms["whole_kernel"],
                         "whole_device_ms": dev["whole_kernel"], "whole_plain_ms": ms["whole_plain"],
                         "library_ms": ms["fused_adamw"], "bound_ms": bound, "whole_bound_ms": whole_bound,
                         "bound_by": "bytes", "elements": n, "leaves": len(trained)}
            for t in trained:
                t.grad = None
            del optimizer, grads, table, fused, trained, fns
            release_memory()
    return out


def hdvila_timing_phase(card: str) -> dict:
    """Phase 6e: the stage-1 bf16 train step at batch 8 (the preset's) in
    windows of CUDA events, its device time by op class (``torch.profiler``)
    and its operations (``utils/profiling.py:flops_estimate``, the
    ``torch.utils.flop_counter`` count of one step: the
    convolutions, GEMMs and attention that the code runs, forward and
    backward) against the card's bf16 dense peak; and the video tower
    (``forward_video``) at batch 8."""
    import torch
    from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths
    from xpretrain_tpu_torch.optim.optimizer import build_optimizer
    from xpretrain_tpu_torch.optim.schedules import get_schedule
    from xpretrain_tpu_torch.parallel.train_step import TrainState, make_model_train_step
    from xpretrain_tpu_torch.tools.profile_train_step import median, spread, window_ms
    from xpretrain_tpu_torch.train.profiling import start_profiler, stop_profiler
    from xpretrain_tpu_torch.utils.profiling import flops_estimate

    batch = HDVILA_TIMED_BATCH
    model = hdvila_full_width(1, bf16=True, device="cuda")
    data = hdvila_batch(1, batch, hdvila_preset(1)["train_n_clips"], "cuda", seed=3)
    optimizer, _ = build_optimizer(dict(model.named_parameters()), get_schedule("constant", 5e-5, 100),
                                   weight_decay=0.01, paths=flax_param_paths(model))
    step = make_model_train_step(hdvila_apply, "cuda", metric_keys=("itc_loss",))
    state = TrainState(step=0, model=model, optimizer=optimizer)

    def train():
        return step(state, data, 0)

    train()
    flops = flops_estimate(train)
    check(flops > 0, "torch.utils.flop_counter counted no operation in the step")
    torch.cuda.reset_peak_memory_stats()
    windows = window_ms(train, iters=4, windows=6)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with tempfile.TemporaryDirectory() as out_dir:
        prof = start_profiler()
        for _ in range(2):
            train()
        classes = stop_profiler(prof, out_dir, 2)
    device_total = sum(r["device_ms_per_step"] for r in classes)
    bound = flops / PEAK_FLOPS * 1e3
    step_ms = median(windows)
    print(f"  stage-1 bf16 train step b={batch} (2 clips, 640x1024 middles, 160x256 neighbours): {spread(windows)}; "
          f"windows {windows} (CUDA events, 4 steps per window, batch on the card) [{card}]")
    print(f"  operations of one step (torch.utils.flop_counter: convolutions, GEMMs, attention; forward + backward): "
          f"{flops / 1e12:.3f} TFLOP; bound at the bf16 dense peak ({PEAK_FLOPS / 1e12:.0f} TFLOP/s) {bound:.3f} ms; "
          f"share of the peak at the median step {bound / step_ms:.4f} [{card}]")
    print(f"  peak device memory of the timed windows {peak:.2f} GiB; device time of a step {device_total:.3f} ms "
          f"(torch.profiler, 2 steps) [{card}]; its three heaviest op classes:")
    for row in classes[:3]:
        print(f"    {row['class']:40s} {row['device_ms_per_step']:10.3f} ms {100 * row['share']:5.1f}% "
              f"{row['launches_per_step']:8.0f} launches")
    check(all(math.isfinite(x) for x in windows) and flops > 0 and device_total > 0, "6e: step timing")
    model.eval()
    with torch.inference_mode():
        video = window_ms(lambda: model.forward_video(data["img_middle"], data["img_other"]), iters=5, windows=5)
        video_flops = flops_estimate(model.forward_video, data["img_middle"], data["img_other"])
    check(video_flops > 0, "torch.utils.flop_counter counted no operation in the video tower")
    print(f"  video tower (forward_video) b={batch} bf16: {spread(video)}; windows {video} (CUDA events, 5 calls per "
          f"window); {video_flops / 1e12:.3f} TFLOP, share of the bf16 peak at the median "
          f"{video_flops / PEAK_FLOPS * 1e3 / median(video):.4f} [{card}]")
    del model, optimizer, state, data
    return {"step_ms": windows, "tflop": flops / 1e12, "peak_share": bound / step_ms, "peak_gib": peak,
            "video_ms": video, "op_classes": classes[:3]}


# ---------------------------------------------------------------------------
# The trainers' production switches (phases 4n-4q, 5f, 6f): --steps_per_call
# as a captured CUDA graph of the step, --param_dtype bf16 with fp32 masters,
# async checkpoints, the factorized proxy mode, the prefetch loader
# ---------------------------------------------------------------------------

GRAPHED_FINETUNE = dict(steps=8, every=4, k=4)  # phase 4n: the MSR-VTT preset at its batch (16)
GRAPHED_LFVILA = dict(steps=4, k=2)  # phase 4o: the stage-1 preset at its batch (16), kernel off
GRAPH_K = 4  # phases 5f and 6f: the B/32 bf16 train step at b=32, K steps a call
STEP_WINDOW_S = 0.5  # phases 6f and 6g: seconds a timing window of the B/32 step (LF-VILA's: 0.6), 5 windows each
PREFETCH = dict(batches=16, batch=16, depth=2)  # phase 4q: B/32 u8 clips
# the host calls that put work on the card, counted per step from torch.profiler's CPU rows
HOST_LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


@contextlib.contextmanager
def built_trainers(module, name: str):
    """While inside, every trainer that ``module`` builds through its
    ``name`` (``ClipVipTrainer``, ``GenericTrainer``) is recorded. Yields
    {"built": [the trainers], "skip": False}; set ``skip`` and their
    ``train()`` returns at once."""
    original = getattr(module, name)
    record = {"built": [], "skip": False}

    class Recorded(original):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            record["built"].append(self)

        def train(self):
            return None if record["skip"] else super().train()

    setattr(module, name, Recorded)
    try:
        yield record
    finally:
        setattr(module, name, original)


def graphed_rerun(tag: str, module, trainer_name: str, argv: list[str], eager_tags: dict, eager_launches: dict,
                  card: str, k: int = 2) -> dict:
    """Phase 4r's check of one training runner: ``module.main(argv)`` again,
    at ``--steps_per_call k``, in a fresh output directory on the card. Its
    logged losses (1e-4) and gradient norms (1e-3 relative) against the
    eager run's ``eager_tags`` (phase 5b's bars), its kernel launches equal
    to the eager run's (counted at replay), no plain call on CUDA, and at
    least one graph captured. Returns {"launches", "peak_gib", "graphs"}."""
    import torch

    with tempfile.TemporaryDirectory() as out_dir, built_trainers(module, trainer_name) as rec:
        args = list(argv)
        args[args.index("--output_dir") + 1] = out_dir
        release_memory()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            module.main([*args, "--steps_per_call", str(k)])
            torch.cuda.synchronize()
            launches = launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        reserved = torch.cuda.max_memory_reserved() / 2**30
        graphs = capture_launches(rec["built"][0].train_step)
        tags = scalars(out_dir)
        del rec["built"][:]
    release_memory()
    compared = sorted(t for t in eager_tags if t.startswith("train/") and ("loss" in t or t == "train/grad_norm"))
    check(bool(compared), f"{tag}: no eager losses to compare")
    worst = {}
    for name in compared:
        a, b = eager_tags[name], tags.get(name, [])
        check(len(a) == len(b) and all(math.isfinite(x) for x in b), f"{tag} {name}: eager {a}, K = {k} {b}")
        if name == "train/grad_norm":
            worst[name] = max(abs(y / x - 1) for x, y in zip(a, b))
            check(worst[name] <= 1e-3, f"{tag} {name}: K = {k} vs eager rel {worst[name]} (phase 5b's bar 1e-3)")
        else:
            worst[name] = max(abs(x - y) for x, y in zip(a, b))
            check(worst[name] <= 1e-4, f"{tag} {name}: K = {k} vs eager {worst[name]} (phase 5b's bar 1e-4)")
    same = all(eager_tags[n] == tags[n] for n in compared)
    diffs = {n.split("/")[1]: f"{v:.3e}" for n, v in worst.items()}
    print(f"  {tag} at --steps_per_call {k}: {len(eager_tags['train/loss'])} steps, {len(graphs)} graph(s) captured "
          f"(launches recorded {graphs}); against the eager run: largest differences {diffs}, bit-identical "
          f"{same}; launches "
          f"{launches} (eager {eager_launches}); peak {peak:.2f} GiB allocated, {reserved:.2f} GiB reserved; run wall "
          f"{wall:.1f} s [{card}]")
    check(launches == eager_launches, f"{tag}: K = {k} launches {launches}, eager {eager_launches}")
    check(not plain_cuda_calls, f"{tag}: the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    return {"launches": launches, "peak_gib": peak, "graphs": len(graphs)}


def release_memory() -> None:
    """Free what an earlier run left behind (models, graphs) before a large one."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def b32_train_state(bf16_storage: bool, accum: int = 1, lr: float = 1e-5, layout=None,
                    attention_dropout: float = 0.0):
    """A B/32 bf16-compute model (seed 0) and its grouped AdamW (cosine with
    warmup, so the lr moves every update), with ``--param_dtype bf16``'s
    storage and masters when asked; ``layout(model)`` lays the model out
    (returning its layouts) before the optimizer is built;
    ``attention_dropout`` is both towers'."""
    import torch
    from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel
    from xpretrain_tpu_torch.optim.optimizer import build_optimizer, cast_params_for_storage, master_weights
    from xpretrain_tpu_torch.optim.schedules import get_schedule
    from xpretrain_tpu_torch.parallel.train_step import TrainState

    model = CLIPViPModel(with_attention_dropout(CLIPVipConfig.base_patch32(dtype=torch.bfloat16), attention_dropout),
                         device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    layouts = layout(model) if layout is not None else {}
    optimizer, _ = build_optimizer(dict(model.named_parameters()), get_schedule("cosine", lr, 16, warmup_ratio=0.25),
                                   grad_accum_steps=accum, paths=flax_param_paths(model.config))
    if layouts:
        optimizer.set_layouts(layouts)
    if bf16_storage:
        cast_params_for_storage(model, torch.bfloat16)
        optimizer = master_weights(optimizer)
    return TrainState(step=0, model=model, optimizer=optimizer)


def b32_train_batches(k: int, batch: int = 32) -> tuple[list, dict]:
    """``k`` synthetic B/32 train batches on the card and their stack."""
    import torch
    from xpretrain_tpu_torch.tools.profile_train_step import synthetic_batch

    batches = [synthetic_batch(batch, "cuda", seed=3 + i) for i in range(k)]
    return batches, {key: torch.stack([b[key] for b in batches]) for key in batches[0]}


def b32_steps(k: int):
    """(eager one-step function, the K-step function) of the fine-tune step."""
    from xpretrain_tpu_torch.ops.losses import build_loss_fn
    from xpretrain_tpu_torch.parallel.train_step import make_train_step
    from xpretrain_tpu_torch.train.trainer import ClipVipTrainer

    loss = build_loss_fn("NCELearnableTempLoss")
    return (make_train_step(ClipVipTrainer._apply_train, loss, "cuda"),
            make_train_step(ClipVipTrainer._apply_train, loss, "cuda", steps_per_call=k))


def capture_launches(step) -> list[dict]:
    """The kernel launches each capture of a K-step function recorded, one
    {wrapper name: count} per graph; fails if it captured none."""
    captures = [c for c in step.graphed.captures.values() if c is not None]
    check(bool(captures), "the K-step function captured no graph")
    return [{fn.__name__: n for fn, n in c.launches if n} for c in captures]


def graphed_finetune_phase(card: str) -> dict:
    """Phase 4n: the MSR-VTT B/32 preset through ``run_retrieval_clipvip
    --mode train`` with ``--steps_per_call 4 --param_dtype bf16
    --async_checkpoint 1``: 8 steps at the preset's b=16, validation and saves
    every 4. The proxy launches counted at replay, no plain call on CUDA,
    finite losses; every stored parameter of >= 2 dims bf16 and equal to
    bf16(master); both checkpoints load, the last equal to the final state
    bit for bit; and both equal, bit for bit, the files of the same run with
    synchronous saves (the step-4 file is the one that the update after it
    would corrupt if the snapshot did not come first)."""
    import torch
    from xpretrain_tpu_torch.cli import run_retrieval_clipvip
    from xpretrain_tpu_torch.optim import adamw_kernel

    steps, every, k = GRAPHED_FINETUNE["steps"], GRAPHED_FINETUNE["every"], GRAPHED_FINETUNE["k"]
    with open(os.path.join(REPO, PRESET)) as f:
        preset = json.load(f)

    def argv(out_dir: str, async_checkpoint: int) -> list[str]:
        return ["--config", os.path.join(REPO, PRESET), "--dummy_data", "1", "--device_ingest", "1",
                "--mode", "train", "--num_train_steps", str(steps), "--valid_steps", str(every),
                "--save_steps", str(every), "--log_steps", "1", "--steps_per_call", str(k),
                "--param_dtype", "bf16", "--async_checkpoint", str(async_checkpoint), "--device", "cuda",
                "--output_dir", out_dir]

    with tempfile.TemporaryDirectory() as sync_dir:
        run_retrieval_clipvip.main(argv(sync_dir, 0))
        synchronous = {step: torch.load(os.path.join(sync_dir, "ckpt", f"{step}.pt"), map_location="cpu",
                                        weights_only=True) for step in (every, steps)}
    release_memory()
    with tempfile.TemporaryDirectory() as out_dir, built_trainers(run_retrieval_clipvip, "ClipVipTrainer") as rec:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            report = run_retrieval_clipvip.main(argv(out_dir, 1))
            torch.cuda.synchronize()
            launches = launch_counts()
        wall = time.perf_counter() - t0
        trainer = rec["built"][0]
        n_val = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / preset["val_batch_size"])
        validations = 1 + steps // every + 1  # at start, at each boundary, the final report's
        want = expected(proxy_attention_fwd=VIDEO_LAYERS * (steps + validations * n_val),
                        proxy_attention_bwd=VIDEO_LAYERS * steps)
        recorded = capture_launches(trainer.train_step)
        print(f"  launches {launches} (expected {want}: {VIDEO_LAYERS} + {VIDEO_LAYERS} a step x {steps} steps, one "
              f"eager warm-up and the rest replays, + {validations} validations x {n_val} batches forward); "
              f"recorded by the capture and added at each replay: {recorded}; plain path on CUDA: "
              f"{len(plain_cuda_calls)} calls")
        check(launches == want, "graphed fine-tune kernel launch counts")
        per_update = -(-sum(len(idx) for idx in trainer.optimizer.groups.values()) // adamw_kernel.MAX_LEAVES)
        check(recorded == [{"proxy_attention": VIDEO_LAYERS, "proxy_attention_bwd": VIDEO_LAYERS,
                            "adamw_multi_tensor": per_update}], f"the capture recorded {recorded}")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        tags = scalars(out_dir)
        losses, norms = tags["train/loss"], tags["train/grad_norm"]
        print(f"  batch {preset['train_batch_size']}, K = {k}: losses {[round(x, 4) for x in losses]}, "
              f"grad norms {[round(x, 4) for x in norms]}")
        check(len(losses) == steps and all(math.isfinite(x) for x in losses + norms), "graphed losses not finite")
        check(all(math.isfinite(report[d][m]) for d in ("t2v", "v2t") for m in ("R1", "R5", "R10")), "R@K")
        opt = trainer.optimizer
        masters = {opt.names[i]: opt.targets[i] for i in opt.masters}
        stored = 0
        for name, p in trainer.model.named_parameters():
            if p.dim() >= 2:
                check(p.dtype == torch.bfloat16 and masters[name].dtype == torch.float32, f"{name}: storage dtypes")
                check(torch.equal(p, masters[name].to(torch.bfloat16)), f"{name}: param != bf16(master)")
                stored += 1
            else:
                check(p.dtype == torch.float32 and name not in masters, f"{name}: a 1-D leaf is fp32, its own master")
        ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")), key=lambda n: int(n.split(".")[0]))
        check(ckpts == [f"{every}.pt", f"{steps}.pt"], f"checkpoints {ckpts}")
        first, last = trainer.ckpt.restore(every), trainer.ckpt.restore(steps)
        check(first["step"] == every and first["optimizer"]["count"] == every, "the first checkpoint's step")
        final = {"model": trainer.model.state_dict(), **{f"optimizer.{key}": opt.state_dict()[key]
                                                          for key in ("mu", "nu", "master")}}
        for part, tensors in final.items():
            saved = last["model"] if part == "model" else last["optimizer"][part.split(".")[1]]
            check(set(saved) == set(tensors), f"{part}: checkpoint keys")
            for key, value in tensors.items():
                check(saved[key].dtype == value.dtype and torch.equal(saved[key], value.cpu()),
                      f"{part}[{key}]: the last checkpoint differs from the final state")
        check(last["step"] == steps and last["optimizer"]["count"] == opt.count == steps, "the last checkpoint's step")
        for step, saved in ((every, first), (steps, last)):
            want, got = flatten(synchronous[step]), flatten(saved)
            check(set(got) == set(want), f"step {step}: the async file's keys differ from the synchronous one's")
            for key, value in want.items():
                if torch.is_tensor(value):
                    same = value.dtype == got[key].dtype and torch.equal(value, got[key])
                else:
                    same = value == got[key]
                check(same, f"step {step} {key}: the async file differs from the synchronous one")
            print(f"  the async file of step {step} equals the synchronous run's bit for bit: {len(want)} entries "
                  f"({sum(torch.is_tensor(v) for v in want.values())} tensors)")
        print(f"  {stored} stored parameters of >= 2 dims in bf16, each equal to bf16(master); checkpoints {ckpts} "
              f"load, the last equal to the final state bit for bit (model, mu, nu, masters)")
        print(f"  run wall {wall:.1f} s (host clock, synthetic data and {validations} validations included); peak "
              f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        del trainer, rec["built"][:]
    release_memory()
    return launches


def graphed_lfvila_phase(card: str) -> dict:
    """Phase 4o: LF-VILA stage-1 pretraining (the stage-1 preset at its
    batch 16, kernel off) at ``--steps_per_call 2`` for 4 steps against the
    eager run on the same seed and synthetic data: the per-step losses and
    gradient norms within phase 5b's bars (MTC clips that followed the
    capture instead of the seed would move them)."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila

    steps, k = GRAPHED_LFVILA["steps"], GRAPHED_LFVILA["k"]
    with open(os.path.join(REPO, STAGE_PRESETS[1])) as f:
        batch = json.load(f)["train_batch_size"]
    runs = {}
    for calls in (1, k):
        with tempfile.TemporaryDirectory() as out_dir, built_trainers(run_pretrain_lfvila, "GenericTrainer") as rec:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                run_pretrain_lfvila.main([
                    "--config", os.path.join(REPO, STAGE_PRESETS[1]), "--stage", "1", "--dummy_data", "1",
                    "--device_ingest", "1", "--train_batch_size", str(batch), "--num_train_steps", str(steps),
                    "--log_steps", "1", "--save_steps", "1000", "--steps_per_call", str(calls), "--device", "cuda",
                    "--output_dir", out_dir,
                ])
                torch.cuda.synchronize()
                launches = launch_counts()
            runs[calls] = dict(tags=scalars(out_dir), launches=launches, wall=time.perf_counter() - t0,
                               peak=torch.cuda.max_memory_allocated() / 2**30)
            if calls > 1:
                runs[calls]["captured"] = capture_launches(rec["built"][0].train_step)
            check(launches == expected(), f"K = {calls}: kernel launches {launches} (the kernel is off)")
            check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
            del rec["built"][:]
        release_memory()
    eager, graphed = runs[1]["tags"], runs[k]["tags"]
    for tag in ("train/loss", "train/ct_time_loss", "train/ct_global_loss", "train/grad_norm"):
        a, b = eager[tag], graphed[tag]
        check(len(a) == len(b) == steps and all(math.isfinite(x) for x in a + b), f"{tag}: {a} {b}")
        diff = max(abs(x - y) for x, y in zip(a, b))
        print(f"  {tag:22s} eager {[round(x, 5) for x in a]}\n  {'':22s} K = {k}  {[round(x, 5) for x in b]}; "
              f"max diff {diff:.3e}, bit-identical: {a == b}")
        if tag == "train/grad_norm":
            rel = max(abs(x / y - 1) for x, y in zip(b, a))
            check(rel <= 1e-3, f"{tag}: graphed vs eager rel {rel} (phase 5b's bar 1e-3)")
        else:
            check(diff <= 1e-4, f"{tag}: graphed vs eager {diff} (phase 5b's bar 1e-4)")
    check(len(set(graphed["train/ct_time_loss"])) == steps, "the MTC loss repeats across steps")
    print(f"  runner wall {runs[1]['wall']:.1f} s eager, {runs[k]['wall']:.1f} s at K = {k} (host clock, the model's "
          f"build and synthetic data included); peak {runs[1]['peak']:.2f} / {runs[k]['peak']:.2f} GiB; launches "
          f"none (the kernel is off, as JAX trains) [{card}]")
    return runs[k]["launches"]


def factorized_phase(card: str) -> dict:
    """Phase 4p: ``attention_mode="factorized"`` at B/32 serving (b=24): no
    proxy launch and no guarded plain call, features within phase 5's 1e-4 of
    the masked_full kernel path in fp32 (the bf16 difference printed), the
    guard still catching the model module's masked ``dot_attention`` on CUDA,
    and a training forward + backward with attention dropout on the card."""
    import torch
    from xpretrain_tpu_torch.models.clip_vip import model as clip_vip_model
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig
    from xpretrain_tpu_torch.ops import proxy_attention as pa
    from xpretrain_tpu_torch.tools.profile_train_step import synthetic_batch

    batch = synthetic_batch(EVAL_BATCH, "cuda", seed=5)
    inputs = (batch["video"], batch["text_input_ids"], batch["text_input_mask"])
    feats, fact_launches = {}, None
    for dtype in (torch.float32, torch.bfloat16):
        full = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=dtype), device="cuda")
        full.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
        fact = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=dtype, vip=VipConfig(attention_mode="factorized")),
                            device="cuda")
        fact.load_state_dict(full.state_dict())
        fact.eval()
        with plain_on_cuda_guard() as plain_cuda_calls, torch.inference_mode():
            reset_launches()
            got = fact(*inputs)
            torch.cuda.synchronize()
            launches = launch_counts()
        check(launches == expected(), f"factorized {dtype}: kernel launches {launches}")
        check(not plain_cuda_calls, f"factorized {dtype}: guarded plain calls {plain_cuda_calls[:4]}")
        fact_launches = fact_launches or launches
        before = pa.proxy_attention.launches
        with torch.inference_mode():
            want = full(*inputs)
        torch.cuda.synchronize()
        check(pa.proxy_attention.launches == before + VIDEO_LAYERS, "the masked_full path did not use the kernel")
        dt = str(dtype).split(".")[-1]
        feats[dt] = {key: (got[key].float() - want[key].float()).abs().max().item()
                     for key in ("vis_features", "text_features")}
        check(all(math.isfinite(x) for x in feats[dt].values()), f"factorized {dt}: features not finite")
        del full, fact, got, want
    print(f"  B/32 serving b={EVAL_BATCH}, factorized vs masked_full (the kernel), same weights: fp32 max_abs "
          f"{feats['float32']} (tol 1e-4), bf16 max_abs {feats['bfloat16']}; factorized launches {fact_launches}")
    check(feats["float32"]["vis_features"] <= 1e-4, f"factorized vs masked_full fp32: {feats['float32']}")
    # the guard lets the factorized path's common.dot_attention through, and
    # still records the model module's masked dot_attention on CUDA
    q = torch.randn(1, 2, 8, 16, device="cuda")
    with plain_on_cuda_guard() as plain_cuda_calls:
        clip_vip_model.dot_attention(q, q, q, 0.25)
    check(len(plain_cuda_calls) == 1, f"the guard missed the masked dot_attention: {plain_cuda_calls}")
    # training with attention dropout on the card (no kernel, so no raise)
    train = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.bfloat16, vip=VipConfig(attention_mode="factorized")),
                         device="cuda")
    train.init_weights(torch.Generator(device="cuda").manual_seed(0)).train()
    for module in train.modules():
        if hasattr(module, "dropout_rate"):
            module.dropout_rate = 0.1
    small = {key: value[:4] for key, value in batch.items()}
    out = train(small["video"], small["text_input_ids"], small["text_input_mask"],
                generator=torch.Generator(device="cuda").manual_seed(1))
    (out["vis_features"].float() @ out["text_features"].float().T).sum().backward()
    grads = [p.grad for p in train.parameters() if p.grad is not None]
    check(bool(grads) and all(bool(torch.isfinite(g).all()) for g in grads), "factorized dropout backward")
    print(f"  guard: the masked dot_attention on CUDA recorded, the factorized one let through; a bf16 training "
          f"forward + backward at b=4 with attention dropout 0.1: {len(grads)} finite gradients [{card}]")
    del train, out, grads
    release_memory()
    return fact_launches


def prefetch_phase(card: str) -> None:
    """Phase 4q: ``PrefetchLoader(depth=2)`` with ``batch_to_device("cuda")``
    over 16 synthetic B/32 batches (b=16 u8 clips and captions): each batch
    on the card equals its host batch bit for bit."""
    import numpy as np
    import torch
    from xpretrain_tpu_torch.data.loader import PrefetchLoader
    from xpretrain_tpu_torch.parallel.train_step import batch_to_device
    from xpretrain_tpu_torch.tools.profile_train_step import captions

    rng = np.random.default_rng(7)
    host = []
    for _ in range(PREFETCH["batches"]):
        ids, mask = captions(rng, PREFETCH["batch"])
        host.append({"video": rng.integers(0, 256, size=(PREFETCH["batch"], 12, 224, 224, 3), dtype=np.uint8),
                     "text_input_ids": ids, "text_input_mask": mask})
    nbytes = sum(v.nbytes for b in host for v in b.values())
    t0 = time.perf_counter()
    sums = []
    placed = []
    for item in PrefetchLoader(host, batch_to_device("cuda"), depth=PREFETCH["depth"]):
        check(all(v.is_cuda for v in item.values()), "a prefetched batch is not on the card")
        sums.append(item["video"].sum(dtype=torch.int64))  # consume on this stream, as a step would
        placed.append(item)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for i, (item, want) in enumerate(zip(placed, host)):
        for key, value in want.items():
            check(torch.equal(item[key].cpu(), torch.from_numpy(value)), f"batch {i} {key}: differs from the host's")
        check(sums[i].item() == int(want["video"].sum(dtype=np.int64)), f"batch {i}: the consumer read another batch")
    print(f"  {len(placed)} batches of {PREFETCH['batch']} B/32 u8 clips, depth {PREFETCH['depth']}, each bit-equal "
          f"to its host batch; {nbytes / 2**20:.0f} MiB in {wall:.2f} s ({nbytes / wall / 1e9:.2f} GB/s, host clock, "
          f"pinning included) [{card}]")
    del placed, host
    release_memory()


ATTENTION_DROPOUT = dict(rate=0.1, steps=2, k=2)  # phase 4s (and 6g's K): a rate, runner steps, steps a call


def with_attention_dropout(config, rate: float):
    """A ``CLIPVipConfig`` with ``rate`` as both towers' attention dropout."""
    return dataclasses.replace(config, text=dataclasses.replace(config.text, attention_dropout=rate),
                               vision=dataclasses.replace(config.vision, attention_dropout=rate))


@contextlib.contextmanager
def clipvip_model_cfg(edit):
    """While inside, ``run_retrieval_clipvip`` builds ``ClipVipTrainer(cfg,
    ..., model_cfg=edit(clip_vip_config_from(cfg)))``: JAX's trainer API
    for what no flag sets, as attention dropout."""
    from xpretrain_tpu_torch.cli import run_retrieval_clipvip
    from xpretrain_tpu_torch.train.trainer import clip_vip_config_from

    original = run_retrieval_clipvip.ClipVipTrainer

    class WithModelCfg(original):
        def __init__(self, cfg, *args, **kwargs):
            super().__init__(cfg, *args, model_cfg=edit(clip_vip_config_from(cfg)), **kwargs)

    run_retrieval_clipvip.ClipVipTrainer = WithModelCfg
    try:
        yield
    finally:
        run_retrieval_clipvip.ClipVipTrainer = original


@contextlib.contextmanager
def lfvila_model_cfg(edit):
    """While inside, ``run_tasks_lfvila`` builds its model from
    ``edit(lfvila_config_from(cfg))`` (the model API, as for CLIP-ViP)."""
    from xpretrain_tpu_torch.cli import run_tasks_lfvila

    original = run_tasks_lfvila.lfvila_config_from
    run_tasks_lfvila.lfvila_config_from = lambda cfg: edit(original(cfg))
    try:
        yield
    finally:
        run_tasks_lfvila.lfvila_config_from = original


def attention_dropout_phase(card: str) -> dict:
    """Phase 4s: training at attention dropout, where JAX leaves its kernels
    for the dense ``dot_attention`` branch (``clip_vip/model.py:216``,
    ``lf_vila/swin3d.py:270``). The MSR-VTT B/32 preset through
    ``run_retrieval_clipvip`` at both towers' attention dropout
    ``ATTENTION_DROPOUT["rate"]``, ``steps`` steps at its b=16 eagerly and at
    ``--steps_per_call k`` (= steps: one warm-up and one capture + replay),
    then the final validation: the guard records exactly 12 masked
    ``dot_attention`` calls on CUDA a traced training forward (the preset has
    no remat) and no other plain call; the proxy launches are the
    validation's alone (12 a batch); finite losses and R@K; the graphed run's
    losses and gradient norms equal the eager one's bit for bit. Then
    ``run_tasks_lfvila --task qa_mc`` on the window-kernel config with
    ``attn_drop_rate`` at the rate, ``QA_TRAIN``'s steps and eval: every
    kernel-gated block at the rate, the window launches the eval's alone (6
    a batch), finite losses. Returns each run's launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_retrieval_clipvip, run_tasks_lfvila
    from xpretrain_tpu_torch.models.clip_vip.model import ProxyAttention
    from xpretrain_tpu_torch.models.lf_vila.swin3d import WindowAttention3D

    rate, steps, k = ATTENTION_DROPOUT["rate"], ATTENTION_DROPOUT["steps"], ATTENTION_DROPOUT["k"]
    with open(os.path.join(REPO, PRESET)) as f:
        preset = json.load(f)
    n_val = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / preset["val_batch_size"])
    S = B32["M"] + B32["N"] * B32["L"]
    # one masked dot_attention a layer and traced forward: eager, each step;
    # at K = steps, the warm-up and the capture (the replays trace nothing)
    want_calls = [("dot_attention", (preset["train_batch_size"], B32["H"], S, B32["D"]))] * (VIDEO_LAYERS * steps)
    launches, tags = {}, {}
    for kk in (1, k):
        with tempfile.TemporaryDirectory() as out_dir, clipvip_model_cfg(lambda c: with_attention_dropout(c, rate)), \
                built_trainers(run_retrieval_clipvip, "ClipVipTrainer") as rec:
            release_memory()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            with plain_on_cuda_guard() as calls:
                reset_launches()
                report = run_retrieval_clipvip.main([
                    "--config", os.path.join(REPO, PRESET), "--dummy_data", "1", "--device_ingest", "1",
                    "--mode", "train", "--num_train_steps", str(steps), "--validate_at_start", "0",
                    "--valid_steps", "1000", "--save_steps", "1000", "--log_steps", "1", "--steps_per_call", str(kk),
                    "--device", "cuda", "--output_dir", out_dir,
                ])
                torch.cuda.synchronize()
                launches[kk] = launch_counts()
            wall = time.perf_counter() - t0
            model = rec["built"][0].model
            rates = {m.dropout_rate for m in model.modules() if isinstance(m, ProxyAttention)}
            check(rates == {rate} and not model.config.remat, f"4s: proxy attention dropout {rates}, remat "
                                                               f"{model.config.remat}")
            graphs = capture_launches(rec["built"][0].train_step) if kk > 1 else []
            tags[kk] = scalars(out_dir)
            del rec["built"][:], model
        tag = "eager" if kk == 1 else f"--steps_per_call {kk} ({len(graphs)} graph(s), launches recorded {graphs})"
        losses, norms = tags[kk].get("train/loss", []), tags[kk].get("train/grad_norm", [])
        print(f"  B/32 fine-tune at attention dropout {rate}, b={preset['train_batch_size']}, {tag}: losses {losses}, "
              f"grad norms {norms}; launches {launches[kk]} (the validation's {n_val} batches); masked dot_attention "
              f"on CUDA {len(calls)} calls (expected {len(want_calls)}: {VIDEO_LAYERS} layers x {steps} traced "
              f"forwards), other plain calls {[c for c in calls if c[0] != 'dot_attention']}; peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; run wall {wall:.1f} s [{card}]")
        check(calls == want_calls, f"4s {tag}: plain calls on CUDA {calls[:4]} ({len(calls)}), expected "
                                   f"{len(want_calls)} x {want_calls[0]}")
        check(launches[kk] == expected(proxy_attention_fwd=VIDEO_LAYERS * n_val),
              f"4s {tag}: launches {launches[kk]}, expected the validation's alone")
        check(len(losses) == steps and all(math.isfinite(x) for x in losses + norms), f"4s {tag}: losses")
        check(all(math.isfinite(report["t2v"][m]) for m in ("R1", "R5", "R10", "MedR")), f"4s {tag}: R@K")
    same = all(tags[1][n] == tags[k][n] for n in ("train/loss", "train/grad_norm"))
    print(f"  K = {k} against eager at attention dropout {rate}: losses and grad norms bit-identical {same}")
    check(same, f"4s: the graphed run {tags[k]['train/loss']} against eager {tags[1]['train/loss']}")

    def lfvila_dropout(model_cfg):
        return dataclasses.replace(model_cfg, video=dataclasses.replace(model_cfg.video, attn_drop_rate=rate))

    n_eval = math.ceil(QA_TRAIN["samples"] / QA_TRAIN["batch"])
    with tempfile.TemporaryDirectory() as out_dir, lfvila_model_cfg(lfvila_dropout), \
            built_trainers(run_tasks_lfvila, "GenericTrainer") as rec:
        dummy_size, run_tasks_lfvila.DUMMY_SIZE = run_tasks_lfvila.DUMMY_SIZE, QA_TRAIN["samples"]
        try:
            with timed_train_steps() as events, plain_on_cuda_guard() as calls:
                reset_launches()
                report = run_tasks_lfvila.main([
                    "--config", os.path.join(REPO, LFVILA_PRESET), *TASK_RUNS["qa_mc"], "--dummy_data", "1",
                    "--num_train_steps", str(QA_TRAIN["steps"]), "--train_batch_size", str(QA_TRAIN["batch"]),
                    "--val_batch_size", str(QA_TRAIN["batch"]), "--log_steps", "1", "--save_steps", "1000",
                    "--device", "cuda", "--output_dir", out_dir,
                ])
                torch.cuda.synchronize()
                launches["lfvila"] = launch_counts()
        finally:
            run_tasks_lfvila.DUMMY_SIZE = dummy_size
        gated = [(m.attn_drop, m.use_pallas) for m in rec["built"][0].model.modules()
                 if isinstance(m, WindowAttention3D) and m.use_pallas]
        del rec["built"][:]
        qa_tags = scalars(out_dir)
    losses = qa_tags.get("train/loss", []) + qa_tags.get("train/span_loss", [])
    print(f"  LF-VILA qa_mc on the window-kernel config at attn_drop_rate {rate}, b={QA_TRAIN['batch']}: "
          f"{len(gated)} kernel-gated blocks at {sorted({a for a, _ in gated})}; losses {qa_tags.get('train/loss')}, "
          f"span losses {qa_tags.get('train/span_loss')}; launches {launches['lfvila']} (the eval's {n_eval} batches); "
          f"plain calls on CUDA {len(calls)}; steps {[round(a.elapsed_time(b), 2) for a, b in events]} ms (CUDA "
          f"events); accuracy {report['accuracy']:.4f} [{card}]")
    check(len(gated) == WINDOW_BLOCKS and all(a == rate for a, _ in gated), f"4s: kernel-gated blocks {gated}")
    check(launches["lfvila"] == expected(window_attention_fwd=WINDOW_BLOCKS * n_eval),
          f"4s: LF-VILA launches {launches['lfvila']}, expected the eval's alone")
    check(not calls, f"4s: LF-VILA plain calls on CUDA {calls[:4]}")
    check(len(losses) == 2 * QA_TRAIN["steps"] and all(math.isfinite(x) for x in losses), "4s: LF-VILA losses")
    check(math.isfinite(report["accuracy"]) and 0.0 <= report["accuracy"] <= 1.0, "4s: LF-VILA accuracy")
    release_memory()
    return {"clipvip": launches[1], "clipvip_graphed": launches[k], "lfvila": launches["lfvila"]}


def graph_equals_eager_phase(card: str) -> None:
    """Phase 5f: the B/32 bf16 train step at b=32, 4 steps graphed (K = 4)
    against 4 eager steps on the same batches and seeds, once plain and once
    with gradient accumulation 2: parameters, moments and per-step losses
    compared bit for bit (if they differ: the largest difference, held to
    phase 5b's bars). Then K more steps, all replays, under torch.profiler:
    the launch counters against the proxy kernels the device ran, by name,
    and the peak memory of the graphed steps."""
    import torch

    k, lr = GRAPH_K, 1e-5
    batches, stacked = b32_train_batches(k)
    for accum in (1, 2):
        eager_state, graphed_state = b32_train_state(False, accum, lr), b32_train_state(False, accum, lr)
        eager, graphed = b32_steps(k)
        eager_losses = [eager(eager_state, b, 11 + i)[1]["loss"] for i, b in enumerate(batches)]
        release_memory()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, metrics = graphed(graphed_state, stacked, 11)
        torch.cuda.synchronize()
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(launches == expected(proxy_attention_fwd=VIDEO_LAYERS * k, proxy_attention_bwd=VIDEO_LAYERS * k),
              f"accum {accum}: graphed launches {launches}")
        check(ADAMW_SEEN["updates"] == k // accum and launches["adamw_multi_tensor"] > 0,
              f"accum {accum}: AdamW updates on the card {ADAMW_SEEN}, {k // accum} expected")
        captures = capture_launches(graphed)
        check(len(captures) == accum, f"accum {accum}: {len(captures)} graphs (one per micro-step index)")
        pairs = {"params": list(zip(eager_state.model.parameters(), graphed_state.model.parameters())),
                 "mu": list(zip(eager_state.optimizer.mu, graphed_state.optimizer.mu)),
                 "nu": list(zip(eager_state.optimizer.nu, graphed_state.optimizer.nu))}
        same = {name: all(torch.equal(a, b) for a, b in group) for name, group in pairs.items()}
        loss_diff = (metrics["loss"] - torch.stack(eager_losses)).abs().max().item()
        param_diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs["params"])
        print(f"  accumulation {accum}: {k} steps graphed ({len(captures)} graph(s), launches {launches}) vs eager: "
              f"bit-identical {same}, losses max diff {loss_diff:.3e}, params max diff {param_diff:.3e} [{card}]")
        if not all(same.values()):
            check(loss_diff <= 1e-4, f"graphed vs eager loss {loss_diff} (phase 5b's bar 1e-4)")
            check(param_diff <= 2 * lr * (k // accum), f"graphed vs eager params {param_diff} (2 lr an update)")
        check(graphed_state.optimizer.count == eager_state.optimizer.count == k // accum, "update counts")
        replayed = replays_against_device(lambda: graphed(graphed_state, stacked, 11 + k))
        print(f"  accumulation {accum}: {k} more steps, every one a replay: counted {replayed['counted']}, the "
              f"device ran {replayed['device']} (torch.profiler kernel names; profiled calls {replayed['attempts']}); "
              f"peak {peak:.2f} GiB allocated over the first {k} graphed steps (warm-up and capture included) "
              f"[{card}]")
        del eager_state, graphed_state, eager, graphed, pairs
        release_memory()
    del batches, stacked
    release_memory()


# device kernel names (substrings) of the proxy-attention wrappers' launches:
# one forward kernel a forward launch, a dq and a dkv kernel a backward launch
PROXY_DEVICE_KERNELS = {"forward": ("fwd_mma_kernel", "proxy_attention_fwd_kernel"),
                        "backward dq": ("dq_mma_kernel", "bwd_dq_kernel"),
                        "backward dkv": ("dkv_mma_kernel", "bwd_dkv_kernel")}


PROFILE_ATTEMPTS = 3  # profiled windows a replay check may take: the profiler can drop kernel records, never add one


def replays_against_device(call) -> dict:
    """``call()`` under ``torch.profiler``: the proxy-attention and AdamW
    launches the wrappers counted against those kernels the device ran, by
    name (a
    graph's replay adds what its capture recorded, so this holds the added
    counts to what ran). Each profiled window runs ``call()`` twice, a
    sleep kernel between the two, and counts the second call's kernels: late
    in a whole run the profiler lost the first few dozen kernel records of a
    window's first graph replay (the first proxy forward among them in phase
    8b; all records in a fresh process), while the rest of the window was
    whole. Fails on no launch, or when none of ``PROFILE_ATTEMPTS`` windows
    shows the counted kernels; every attempt is returned."""
    import torch

    attempts = []
    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            call()  # the window's first replays, whose records the profiler may lose
            torch.cuda._sleep(1_000_000)  # the marker: the second call's kernels all run after it
            reset_launches()
            call()
            torch.cuda.synchronize()
        counted = launch_counts()
        events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
        check(bool(marks), f"no sleep kernel among the profiled kernels: {sorted({e.name for e in events})[:20]}")
        after = events[marks[-1] + 1:]
        device = {part: sum(any(n in e.name for n in names) for e in after)
                  for part, names in PROXY_DEVICE_KERNELS.items()}
        kernels = {}
        for e in after:
            kernels[e.name] = kernels.get(e.name, 0) + 1
        device["adamw"] = sum("xpt_adamw_multi_tensor_apply_kernel" in e.name for e in after)
        check(counted["proxy_attention_fwd"] > 0, f"no proxy launch counted: {counted}")
        attempts.append({"device": device, "kernels": len(after), "first_call_kernels": marks[-1]})
        if device == {"forward": counted["proxy_attention_fwd"], "backward dq": counted["proxy_attention_bwd"],
                      "backward dkv": counted["proxy_attention_bwd"], "adamw": counted["adamw_multi_tensor"]}:
            return {"counted": {key: n for key, n in counted.items() if n}, "device": device, "kernels": kernels,
                    "attempts": attempts}
    fail(f"counted {counted} against the device's proxy kernels in {PROFILE_ATTEMPTS} profiled calls: {attempts}")


def profile_per_step(fn, steps: int) -> dict:
    """One call of ``fn`` (``steps`` train steps) under ``torch.profiler``:
    device busy ms, device kernels and host launch calls, each per step."""
    import torch
    from xpretrain_tpu_torch.train.profiling import device_us, key_average_rows

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = key_average_rows(prof)
    kernels = sum(r["count"] for r in rows if r["device_type"] == "CUDA")
    host = sum(r["count"] for r in rows if r["device_type"] == "CPU" and r["name"] in HOST_LAUNCHES)
    return {"busy_ms": device_us(rows) / 1e3 / steps, "kernels": kernels / steps, "host_launches": host / steps}


def time_steps(fns: dict, steps: int, card: str, what: str, window_s: float = 1.0) -> dict:
    """For each of ``fns`` (name -> a call of ``steps`` train steps): ms a
    step over 5 windows of about ``window_s`` (CUDA events), device busy
    time, idle share, kernels and host launches a step, and peak GiB
    allocated from the first call on (a graph's capture included)."""
    import torch
    from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms, median, spread, window_ms

    out = {}
    for name, fn in fns.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()  # the peak holds the capture's private pool
        fn()
        fn()  # warm-up (a K-step function's first call warms up and captures)
        torch.cuda.synchronize()
        iters = max(1, round(window_s * 1e3 / cuda_time_ms(fn, iters=1, warmup=0)))
        windows = [ms / steps for ms in window_ms(fn, iters=iters)]
        peak = torch.cuda.max_memory_allocated() / 2**30
        prof = profile_per_step(fn, steps)
        idle = 1 - prof["busy_ms"] / median(windows)
        out[name] = {"step_ms": windows, "peak_gib": peak, "idle": idle, **prof}
        print(f"  {what} {name}: {spread(windows)} a step; windows {windows} (CUDA events, {iters} calls of "
              f"{steps} steps each); device busy {prof['busy_ms']:.3f} ms a step, idle share {idle:.3f}; "
              f"{prof['kernels']:.0f} device kernels and {prof['host_launches']:.1f} host launch calls a step "
              f"(torch.profiler, one call); peak {peak:.2f} GiB [{card}]")
        check(all(math.isfinite(x) for x in windows) and prof["busy_ms"] > 0, f"{what} {name}: timing")
    return out


def graph_timing_phase(card: str) -> dict:
    """Phase 6f: the B/32 bf16 train step at b=32, eager and graphed (K = 4),
    each with fp32 and with bf16 parameter storage; then LF-VILA stage 1 (the
    preset at b=16, kernel off) eager and at K = 2, through the trainer the
    runner builds."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila
    from xpretrain_tpu_torch.parallel.train_step import TrainState, make_model_train_step

    k = GRAPH_K
    batches, stacked = b32_train_batches(k)
    results = {}
    for storage in ("fp32", "bf16"):
        state = b32_train_state(storage == "bf16", lr=1e-6)
        eager, graphed = b32_steps(k)
        results.update({f"b32 {storage} storage {mode}": row for mode, row in time_steps({
            "eager": lambda: [eager(state, b, 0) for b in batches],
            f"graphed K={k}": lambda: graphed(state, stacked, 0),
        }, k, card, f"B/32 bf16 train step b=32, {storage} storage,", window_s=STEP_WINDOW_S).items()})
        del state, eager, graphed
        release_memory()
    del batches, stacked
    release_memory()

    with open(os.path.join(REPO, STAGE_PRESETS[1])) as f:
        batch = json.load(f)["train_batch_size"]
    with tempfile.TemporaryDirectory() as out_dir, built_trainers(run_pretrain_lfvila, "GenericTrainer") as rec:
        rec["skip"] = True
        run_pretrain_lfvila.main([
            "--config", os.path.join(REPO, STAGE_PRESETS[1]), "--stage", "1", "--dummy_data", "1",
            "--device_ingest", "1", "--train_batch_size", str(batch), "--num_train_steps", "1000",
            "--device", "cuda", "--output_dir", out_dir,
        ])
        trainer = rec["built"][0]
        lk = GRAPHED_LFVILA["k"]
        data = [trainer.place_batch(next(trainer.train_loader)) for _ in range(lk)]
        lf_stacked = {key: torch.stack([b[key] for b in data]) for key in data[0]}
        state = TrainState(step=0, model=trainer.model, optimizer=trainer.optimizer)
        graphed = make_model_train_step(trainer.apply_fn, "cuda", metric_keys=trainer.metric_keys, steps_per_call=lk)
        results.update({f"lfvila stage 1 {mode}": row for mode, row in time_steps({
            "eager": lambda: [trainer.train_step(state, b, 0) for b in data],
            f"graphed K={lk}": lambda: graphed(state, lf_stacked, 0),
        }, lk, card, f"LF-VILA stage-1 bf16 train step b={batch},", window_s=0.6).items()})
        del trainer, rec["built"][:], state, graphed, data, lf_stacked
    release_memory()
    return results



def dropout_timing_phase(card: str) -> dict:
    """Phase 6g: the graphed B/32 bf16 train step at b=32 (K =
    ``ATTENTION_DROPOUT["k"]``, fp32 storage) at attention dropout 0 and at
    the rate, 6f's measure (5 windows of CUDA events, device busy, peak GiB
    from the first call on): what JAX's dense dropout branch costs."""
    k, rate = ATTENTION_DROPOUT["k"], ATTENTION_DROPOUT["rate"]
    batches, stacked = b32_train_batches(k)
    results = {}
    for p in (0.0, rate):
        state = b32_train_state(False, lr=1e-6, attention_dropout=p)
        graphed = b32_steps(k)[1]
        results[p] = time_steps({f"graphed K={k}": lambda: graphed(state, stacked, 0)}, k, card,
                                f"B/32 bf16 train step b=32, attention dropout {p},",
                                window_s=STEP_WINDOW_S)[f"graphed K={k}"]
        del state, graphed
        release_memory()
    del batches, stacked
    release_memory()
    base, drop = (results[p] for p in (0.0, rate))
    print(f"  attention dropout {rate} against 0: {drop['step_ms']} against {base['step_ms']} ms a step, peak "
          f"{drop['peak_gib']:.2f} against {base['peak_gib']:.2f} GiB [{card}]")
    return results


def _max_abs(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def clipvip_artifact_phase(card: str, folder: str) -> tuple[dict, dict]:
    """Phase 7a: export B/32 (bf16, kernel attention) through the CLI's code
    path, load it, call it at ``ARTIFACT_BATCHES`` against the live towers on
    the same weights; a plain artifact beside it; both towers timed at b=24.
    Returns (the launches of the kernel artifact's calls, the live model and
    its b=24 batch for 7e)."""
    import torch
    from xpretrain_tpu_torch.cli import export_serving_clipvip
    from xpretrain_tpu_torch.serving import export_retrieval_towers, load_artifact
    from xpretrain_tpu_torch.serving.towers import RetrievalTowers
    from xpretrain_tpu_torch.tools.profile_train_step import spread, synthetic_batch, window_ms

    built, build = [], export_serving_clipvip.build_model
    export_serving_clipvip.build_model = lambda cfg, device: built.append(build(cfg, device)) or built[-1]
    path = os.path.join(folder, "clipvip_b32.xpsa")
    try:
        t0 = time.perf_counter()
        with plain_on_cuda_guard() as plain_cuda_calls:
            meta = export_serving_clipvip.main([
                "--clip_size", "base_32", "--num_frm", "12", "--crop_img_size", "224", "--max_txt_len", "70",
                "--bf16", "1", "--device", "cuda", "--output", path, "--output_dir", os.path.join(folder, "cli"),
            ])
        export_s = time.perf_counter() - t0
    finally:
        export_serving_clipvip.build_model = build
    check(not plain_cuda_calls, f"the export traced a plain version on CUDA: {plain_cuda_calls[:4]}")
    check((meta["device"], meta["attention"]) == ("cuda", "kernel"), f"artifact meta {meta}")
    size = os.path.getsize(path) / 2**20
    t0 = time.perf_counter()
    art = load_artifact(path)
    load_s = time.perf_counter() - t0
    os.remove(path)
    print(f"  exported B/32 (bf16, kernel attention) through export_serving_clipvip in {export_s:.1f} s (model "
          f"build, both traces and the save), {size:.1f} MiB, loaded in {load_s:.1f} s (host clock) [{card}]")
    model = built[0]
    batches = {b: synthetic_batch(b, "cuda", seed=b) for b in ARTIFACT_BATCHES}
    got = {}
    with plain_on_cuda_guard() as plain_cuda_calls:
        reset_launches()
        for b, batch in batches.items():
            before = launch_counts()
            got[b] = (art.encode_video(batch["video"]),
                      art.encode_text(batch["text_input_ids"], batch["text_input_mask"]))
            torch.cuda.synchronize()
            after = launch_counts()
            check({k: after[k] - before[k] for k in after} == expected(proxy_attention_fwd=VIDEO_LAYERS),
                  f"b={b}: the loaded program's launches {after} (before {before})")
        launches = launch_counts()
    check(not plain_cuda_calls, f"the artifact ran a plain version on CUDA: {plain_cuda_calls[:4]}")
    towers = RetrievalTowers(model, "cuda")
    for b, batch in batches.items():
        want = (towers.encode_video(batch["video"]),
                towers.encode_text(batch["text_input_ids"], batch["text_input_mask"]))
        errs = [_max_abs(g, w) for g, w in zip(got[b], want)]
        print(f"  b={b:2d}: video {tuple(got[b][0].shape)} text {tuple(got[b][1].shape)}, artifact vs live towers "
              f"max_abs video {errs[0]:.3e} text {errs[1]:.3e} (tol {ARTIFACT_TOL:.0e}); {VIDEO_LAYERS} proxy "
              f"launches inside the loaded program")
        check(all(math.isfinite(e) and e <= ARTIFACT_TOL for e in errs), f"b={b}: artifact vs live {errs}")
    print(f"  launches of the artifact's calls {launches}")

    t0 = time.perf_counter()
    plain = export_retrieval_towers(model, frames=12, image_size=224, seq_len=70, attention="plain")
    plain_s = time.perf_counter() - t0
    b24 = batches[EVAL_BATCH]
    reset_launches()
    plain_v = plain.encode_video(b24["video"])
    torch.cuda.synchronize()
    check(launch_counts() == expected(), f"the plain artifact launched {launch_counts()}")
    err = _max_abs(plain_v, got[EVAL_BATCH][0])
    print(f"  plain artifact (exported in {plain_s:.1f} s): no launch, b=24 video features vs the kernel "
          f"artifact's max_abs {err:.3e} (tol {TOL['bfloat16']:.0e}, the forward kernel's bf16 bar)")
    check(math.isfinite(err) and err <= TOL["bfloat16"], f"plain vs kernel artifact {err}")
    del plain, plain_v

    video, ids, mask = b24["video"], b24["text_input_ids"], b24["text_input_mask"]
    runs = {"live": window_ms(lambda: (towers.encode_video(video), towers.encode_text(ids, mask)),
                              iters=ARTIFACT_TIMED_ITERS),
            "artifact": window_ms(lambda: (art.encode_video(video), art.encode_text(ids, mask)),
                                  iters=ARTIFACT_TIMED_ITERS)}
    for name, ms in runs.items():
        print(f"  B/32 bf16 video+text b=24 through the {name} towers: {spread(ms)}; windows {ms} (CUDA events, "
              f"{ARTIFACT_TIMED_ITERS} calls per window, inputs on the card) [{card}]")
    del art, towers, got
    return launches, (model, b24)


def lfvila_artifact_phase(card: str, preset: dict, folder: str) -> dict:
    """Phase 7b: LF-VILA at the stage-1 preset's widths and depth, fp32, the
    window kernel on: the artifact against the live towers on fp32 frames
    [2, 3, 32, 192, 320] and 4 sentences of 50 tokens, 6 window launches a
    video call inside the loaded program."""
    import torch
    from xpretrain_tpu_torch.cli import run_tasks_lfvila
    from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval
    from xpretrain_tpu_torch.serving import export_lfvila_retrieval_towers, load_artifact, save_artifact
    from xpretrain_tpu_torch.serving.towers import LfVilaTowers

    model = LfVilaRetrieval(run_tasks_lfvila.lfvila_config_from({**preset, "bf16": 0}), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    t0 = time.perf_counter()
    with plain_on_cuda_guard() as plain_cuda_calls:
        art = export_lfvila_retrieval_towers(model, frames=32, image_size=(192, 320), n_sent=4, sent_len=50)
    export_s = time.perf_counter() - t0
    check(not plain_cuda_calls, f"the export traced a plain version on CUDA: {plain_cuda_calls[:4]}")
    check(art.meta["attention"] == "kernel", f"artifact meta {art.meta}")
    path = os.path.join(folder, "lfvila.xpsa")
    t0 = time.perf_counter()
    save_artifact(path, art)
    t1 = time.perf_counter()
    art = load_artifact(path)
    save_s, load_s, size = t1 - t0, time.perf_counter() - t1, os.path.getsize(path) / 2**20
    os.remove(path)
    g = torch.Generator(device="cuda").manual_seed(7)
    frames = torch.randn(2, 3, 32, 192, 320, device="cuda", generator=g)
    ids = torch.randint(1, 30522, (2, 4, 50), device="cuda", generator=g)
    mask = (torch.arange(50, device="cuda")[None, None] < torch.randint(5, 51, (2, 4, 1), device="cuda",
                                                                          generator=g)).long()
    with plain_on_cuda_guard() as plain_cuda_calls:
        reset_launches()
        got = (art.encode_video(frames), art.encode_text(ids, mask))
        torch.cuda.synchronize()
        launches = launch_counts()
    check(not plain_cuda_calls, f"the artifact ran a plain version on CUDA: {plain_cuda_calls[:4]}")
    check(launches == expected(window_attention_fwd=WINDOW_BLOCKS), f"LF-VILA artifact launches {launches}")
    towers = LfVilaTowers(model, "cuda")
    errs = [_max_abs(a, w) for a, w in zip(got, (towers.encode_video(frames), towers.encode_text(ids, mask)))]
    print(f"  LF-VILA stage-1 preset fp32, window kernel on: exported in {export_s:.1f} s, saved in {save_s:.1f} s "
          f"({size:.1f} MiB), loaded in {load_s:.1f} s (host clock); b=2 artifact vs live towers max_abs video "
          f"{errs[0]:.3e} text {errs[1]:.3e} (tol {ARTIFACT_TOL:.0e}); launches {launches} [{card}]")
    check(all(math.isfinite(e) and e <= ARTIFACT_TOL for e in errs), f"LF-VILA artifact vs live {errs}")
    del model, art, towers
    release_memory()
    return launches


def hdvila_artifact_phase(card: str) -> None:
    """Phase 7c: HD-VILA at the stage-1 preset's widths and depth, fp32: the
    exported towers on uint8 middles and neighbours (b=1) against the live
    towers; the frozen-BN op once per FrozenBatchNorm, no other kernel. The
    programs are called as exported, not
    through a file (the CPU tests round-trip every family's file; this
    saves ~30 s of writing and reading 1.1 GB)."""
    import torch
    from xpretrain_tpu_torch.models.hd_vila.resnet import FrozenBatchNorm
    from xpretrain_tpu_torch.serving import export_hdvila_retrieval_towers
    from xpretrain_tpu_torch.serving.towers import HdVilaTowers

    p = hdvila_preset(1)
    h, w = p["crop_size"]
    model = hdvila_full_width(1, bf16=False, device="cuda").eval()
    t0 = time.perf_counter()
    art = export_hdvila_retrieval_towers(model, n_clips=2, n_lo_frames=p["num_frm"] - 1, hi_size=(h, w),
                                         lo_size=(h // 4, w // 4), seq_len=p["max_txt_len"])
    export_s = time.perf_counter() - t0
    size = sum(t.numel() * t.element_size() for program in (art.video, art.text)
               for t in (*program.state_dict.values(), *program.constants.values())) / 2**20
    batch = hdvila_batch(1, batch=1, clips=2, device="cuda", seed=8)
    reset_launches()
    got = (art.encode_video(batch["img_middle"], batch["img_other"]),
           art.encode_text(batch["text_input_ids"], batch["text_input_mask"]))
    torch.cuda.synchronize()
    bns = sum(isinstance(m, FrozenBatchNorm) for m in model.modules())
    check(launch_counts() == expected(frozen_bn_act=bns), f"the HD-VILA artifact launched {launch_counts()}, "
          f"expected {bns} frozen-BN launches")
    towers = HdVilaTowers(model, "cuda")
    want = (towers.encode_video(batch["img_middle"], batch["img_other"]),
            towers.encode_text(batch["text_input_ids"], batch["text_input_mask"]))
    errs = [_max_abs(a, b) for a, b in zip(got, want)]
    print(f"  HD-VILA stage-1 preset fp32 (uint8 frames): exported in {export_s:.1f} s (host clock), {size:.1f} MiB "
          f"of weights and constants in the two programs; b=1 artifact vs live towers max_abs video "
          f"{errs[0]:.3e} text {errs[1]:.3e} (tol {ARTIFACT_TOL:.0e}); {bns} frozen-BN launches a video call and "
          f"no other kernel [{card}]")
    check(all(math.isfinite(e) and e <= ARTIFACT_TOL for e in errs), f"HD-VILA artifact vs live {errs}")
    del model, art, towers
    release_memory()


def patch_embed_export_phase(card: str, folder: str) -> dict:
    """Phase 7d: ``xpt::patch_embed_u8`` through ``torch.export``: a module
    calling ``fused_patch_embed(use_kernel=True)`` at the B/32 serving
    frames, exported, saved, loaded, against the eager kernel bit for bit,
    one launch a call."""
    import torch
    from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
    from xpretrain_tpu_torch.ops import patchify as pp

    class PatchEmbed(torch.nn.Module):
        def __init__(self, kernel):
            super().__init__()
            self.kernel = torch.nn.Parameter(kernel, requires_grad=False)

        def forward(self, frames):
            return pp.fused_patch_embed(frames, self.kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16, use_kernel=True)

    frames, kernel = patch_inputs(PATCH_SHAPES["b32"], seed=9)
    module = PatchEmbed(kernel)
    with torch.no_grad():
        program = torch.export.export(module, (frames,))
    ops = sum(1 for n in program.graph.nodes if "xpt.patch_embed_u8" in str(n.target))
    check(ops == 1, f"{ops} xpt::patch_embed_u8 nodes in the exported program")
    path = os.path.join(folder, "patch_embed.pt2")
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()
    os.remove(path)
    reset_launches()
    with torch.no_grad():
        got = loaded(frames)
    torch.cuda.synchronize()
    launches = launch_counts()
    check(launches == expected(patch_embed_u8=1), f"patch-embed program launches {launches}")
    want = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16, use_kernel=True)
    same = torch.equal(got, want)
    print(f"  fused_patch_embed(use_kernel=True) exported and loaded: one xpt::patch_embed_u8 node, "
          f"{tuple(got.shape)} {got.dtype} bit-equal to the eager kernel: {same}; launches {launches}")
    check(same, "the exported patch embed differs from the eager kernel")
    return launches


def int8_phase(card: str, model, batch: dict) -> None:
    """Phase 7e: B/32 (bf16) under ``int8_serving`` at b=24: the embedding
    cosine against the bf16 path (``INT8_COS``, on the batch's flattened
    features as JAX's ``tests/test_quant.py:_cos`` takes it), and both
    forwards timed."""
    import torch
    from xpretrain_tpu_torch.ops.quant import int8_serving
    from xpretrain_tpu_torch.tools.profile_train_step import spread, window_ms

    video, ids, mask = batch["video"], batch["text_input_ids"], batch["text_input_mask"]

    def forward():
        return model.forward_video(video), model.forward_text(ids, mask)

    with torch.inference_mode():
        ref = forward()
        bf16 = window_ms(forward, iters=ARTIFACT_TIMED_ITERS)
        with int8_serving():
            out = forward()
            int8 = window_ms(forward, iters=ARTIFACT_TIMED_ITERS)
    # the embedding cosine as JAX's tests/test_quant.py computes it (the flattened features of the batch,
    # which for unit rows is the mean row cosine); each tower's lowest row cosine printed beside it
    cos = [torch.nn.functional.cosine_similarity(a.double().flatten(), b.double().flatten(), dim=0).item()
           for a, b in zip(out, ref)]
    low = [torch.nn.functional.cosine_similarity(a.double(), b.double(), dim=-1).min().item()
           for a, b in zip(out, ref)]
    print(f"  w8a8 B/32 b=24: embedding cosine vs bf16 video {cos[0]:.6f} text {cos[1]:.6f} (bar {INT8_COS}); "
          f"lowest row video {low[0]:.6f} text {low[1]:.6f}")
    print(f"  B/32 video+text b=24 bf16: {spread(bf16)}; windows {bf16} [{card}]")
    print(f"  B/32 video+text b=24 w8a8 (int8_serving, torch._int_mm): {spread(int8)}; windows {int8} (CUDA events, "
          f"{ARTIFACT_TIMED_ITERS} calls per window) [{card}]")
    check(all(c >= INT8_COS for c in cos), f"int8 cosine {cos} below {INT8_COS}")


# ---------------------------------------------------------------------------
# The data-parallel layer (phases 8a-8c): the runners under a one-rank NCCL
# group, set up as torchrun would, against the same runs without a group
# ---------------------------------------------------------------------------

DP_LFVILA = dict(batch=8, steps=3, eval_samples=16, depths=[1, 1, 2, 1, 1, 1], bert_layers=(2, 4))
# phase 9: the proxy kernels at the B/32 train step's local shapes under --tp 2 and 4 (6 and 3 heads a rank), and
# the window kernel at one rank's stage-3 windows under --cp 2 (16 of the 32 frames at 192x320, b=8)
TP_PROXY_SHAPES = {f"b32_train_tp{tp}": dict(B32_TRAIN, H=B32_TRAIN["H"] // tp) for tp in (2, 4)}
CP_WINDOW_SHAPES = {
    "s3_shifted_cp2": (32, 16, 240, 32, ("shifted", (16, 6, 10), (16, 3, 5), (0, 1, 2))),
    "s3_cp2": (32, 16, 240, 32, None),
}
LAYOUT_STEPS = 2  # phase 9b: eager B/32 steps with and without the TP plan
DP_GRAPH_K = 2  # phase 8b: steps a call of 8a's graphed step


def finetune_argv(out_dir: str) -> list[str]:
    """Phase 4b's ``run_retrieval_clipvip`` arguments (8a runs them again
    under a group)."""
    return ["--config", os.path.join(REPO, PRESET), "--dummy_data", "1", "--device_ingest", "1",
            "--mode", "train", "--num_train_steps", str(TRAIN_STEPS),
            "--valid_steps", str(TRAIN_EVERY), "--save_steps", str(TRAIN_EVERY), "--log_steps", "1",
            "--zero2", "1", "--device", "cuda", "--output_dir", out_dir]


def finished_run(out_dir: str, report, launches: dict) -> dict:
    """What a training run left in ``out_dir``, on the host: its logged
    scalars, its last checkpoint (model and optimizer state), its report
    and launch counts."""
    import torch

    ckpt = os.path.join(out_dir, "ckpt")
    last = max(int(name.split(".")[0]) for name in os.listdir(ckpt))
    state = torch.load(os.path.join(ckpt, f"{last}.pt"), map_location="cpu", weights_only=True)
    return {"tags": scalars(out_dir), "state": state, "report": report, "launches": launches}


def _tensors(tree, prefix: str = "") -> dict:
    """The tensors of a nested dict, by '/'-joined key."""
    import torch

    out = {}
    for key, value in (tree.items() if isinstance(tree, dict) else ()):
        if isinstance(value, torch.Tensor):
            out[prefix + str(key)] = value
        elif isinstance(value, dict):
            out.update(_tensors(value, f"{prefix}{key}/"))
    return out


def measured_report(report) -> dict:
    """A report's numbers without its wall-clock block (``perf``)."""
    return {k: v for k, v in (report or {}).items() if k != "perf"}


def hold_to_ungrouped(tag: str, got: dict, want: dict, card: str) -> bool:
    """A run under the one-rank group against the same run without one:
    logged losses and gradient norms, every tensor of the last checkpoint
    (parameters, moments, masters) and the report, bit for bit; where they
    differ, the largest differences within phase 5b's bars (loss 1e-4,
    gradient norm 1e-3 relative). Launch counts must be equal. Returns
    whether all was bit-identical."""
    compared = sorted(t for t in want["tags"] if t.startswith("train/") and ("loss" in t or t == "train/grad_norm"))
    check(bool(compared), f"{tag}: no losses logged")
    tags_same = all(got["tags"].get(t) == want["tags"][t] for t in compared)
    a, b = _tensors(got["state"]), _tensors(want["state"])
    check(set(a) == set(b), f"{tag}: checkpoint keys differ: {sorted(set(a) ^ set(b))[:6]}")
    state_same = all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and bool((a[k] == b[k]).all())
                     for k in b)
    report_same = measured_report(got["report"]) == measured_report(want["report"])
    worst_state = max(((a[k].double() - b[k].double()).abs().max().item() for k in b if a[k].numel()), default=0.0)
    worst = {}
    for name in compared:
        x, y = want["tags"][name], got["tags"].get(name, [])
        check(len(x) == len(y) and all(math.isfinite(v) for v in y), f"{tag} {name}: without {x}, with {y}")
        worst[name] = (max(abs(v / u - 1) for u, v in zip(x, y)) if name == "train/grad_norm"
                       else max(abs(u - v) for u, v in zip(x, y)))
    same = tags_same and state_same and report_same
    print(f"  {tag}: against the run without a group: bit-identical losses/grad norms {tags_same}, checkpoint "
          f"tensors {state_same} ({len(b)} tensors, largest difference {worst_state:.3e}), report {report_same}; "
          f"launches {got['launches']} (without {want['launches']}) [{card}]")
    if not same:
        print(f"  {tag}: largest differences {{{', '.join(f'{k}: {v:.3e}' for k, v in worst.items())}}}")
        for name, value in worst.items():
            bar = 1e-3 if name == "train/grad_norm" else 1e-4
            check(value <= bar, f"{tag} {name}: {value} against the run without a group (phase 5b's bar {bar})")
    check(got["launches"] == want["launches"], f"{tag}: launches {got['launches']}, without a group "
                                               f"{want['launches']}")
    return same


@contextlib.contextmanager
def one_rank_nccl_group():
    """torchrun's environment for one rank on this card (a free
    ``MASTER_PORT``); the runner's ``parse_args`` joins the group. On exit
    the group is destroyed and the environment restored."""
    import socket

    from xpretrain_tpu_torch.parallel import mesh

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    try:
        yield
    finally:
        release_memory()
        mesh.destroy_distributed()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def data_parallel_finetune_phase(card: str, reference: dict) -> dict:
    """Phase 8a, inside :func:`one_rank_nccl_group`: phase 4b's run of
    ``run_retrieval_clipvip`` (6 steps, ZeRO-2, validations) eagerly, then at
    ``--steps_per_call 2`` (the graph captures the NCCL collectives), each
    held to 4b's run without a group. Returns each run's launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_retrieval_clipvip
    from xpretrain_tpu_torch.parallel import mesh

    launches = {}
    for k in (1, 2):
        with tempfile.TemporaryDirectory() as out_dir, built_trainers(run_retrieval_clipvip,
                                                                       "ClipVipTrainer") as rec:
            release_memory()
            t0 = time.perf_counter()
            with plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_retrieval_clipvip.main(finetune_argv(out_dir) + ["--steps_per_call", str(k)])
                torch.cuda.synchronize()
                counts = launch_counts()
            wall = time.perf_counter() - t0
            group = mesh.current_mesh()
            check(group is not None and group.backend == "nccl" and group.world_size == 1
                  and torch.distributed.get_backend() == "nccl", f"the runner joined no one-rank NCCL group: {group}")
            optimizer = rec["built"][0].optimizer
            sharded = len(optimizer.shards)
            check(sharded > 0 and optimizer.mesh is group, "--zero2 1 sharded no optimizer leaf under the group")
            graphs = capture_launches(rec["built"][0].train_step) if k > 1 else []
            tag = "eager" if k == 1 else f"--steps_per_call {k} ({len(graphs)} graph(s), launches recorded {graphs})"
            print(f"  {tag}: group {group.backend} rank {group.rank} of {group.world_size} on {group.device}, "
                  f"{sharded} optimizer leaves ZeRO-2 sharded (one block: the whole leaf); run wall {wall:.1f} s "
                  f"[{card}]")
            check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
            hold_to_ungrouped(f"8a {tag}", finished_run(out_dir, report, counts), reference, card)
            launches[k] = counts
            del rec["built"][:], optimizer
    return launches


def data_parallel_graph_phase(card: str) -> None:
    """Phase 8b: the B/32 bf16 train step at b=32 (5f's and 6f's batch),
    ZeRO-2, at K = 2 under the one-rank group: 2 replayed steps under
    ``torch.profiler`` (the proxy kernels by name against the counters, as in
    5f, and the NCCL kernels and copies the collectives left in the graph),
    then the step's ms (5 windows of CUDA events) with the group, and after
    the group is destroyed, without it."""
    import torch
    from xpretrain_tpu_torch.optim.optimizer import zero2_shard
    from xpretrain_tpu_torch.parallel import mesh

    batches, stacked = b32_train_batches(DP_GRAPH_K)

    def graphed_state():
        state = b32_train_state(False, lr=1e-6)
        state.optimizer = zero2_shard(state.optimizer)
        return state, b32_steps(DP_GRAPH_K)[1]

    state, graphed = graphed_state()
    graphed(state, stacked, 0)  # warm-up (its collectives create nothing new: the group exists) and capture
    replayed = replays_against_device(lambda: graphed(state, stacked, 1))
    nccl = {name: n for name, n in replayed["kernels"].items() if "nccl" in name.lower() or "onerank" in name.lower()}
    copies = {name: n for name, n in replayed["kernels"].items() if "memcpy dtod" in name.lower()}
    print(f"  {DP_GRAPH_K} replayed steps under torch.profiler: {sum(replayed['kernels'].values())} device kernels; "
          f"proxy launches counted {replayed['counted']}, the device ran {replayed['device']} (profiled calls "
          f"{replayed['attempts']}); NCCL kernels {nccl}; "
          f"device-to-device copies {copies} [{card}]")
    check(bool(nccl), f"no NCCL kernel in the replayed graph: {sorted(replayed['kernels'])[:40]}")
    timed = time_steps({"one-rank NCCL group, ZeRO-2": lambda: graphed(state, stacked, 0)}, DP_GRAPH_K, card,
                       f"B/32 bf16 train step b=32 at K={DP_GRAPH_K},")
    del state, graphed
    release_memory()
    mesh.destroy_distributed()
    state, graphed = graphed_state()
    graphed(state, stacked, 0)  # warm-up and capture, before the peak is reset, as for the group's
    timed.update(time_steps({"no group": lambda: graphed(state, stacked, 0)}, DP_GRAPH_K, card,
                            f"B/32 bf16 train step b=32 at K={DP_GRAPH_K},"))
    from xpretrain_tpu_torch.tools.profile_train_step import median

    with_group, without = (median(timed[k]["step_ms"]) for k in ("one-rank NCCL group, ZeRO-2", "no group"))
    print(f"  the collectives at world size 1 cost {with_group - without:.4f} ms a step (median {with_group:.4f} "
          f"against {without:.4f} ms) [{card}]")
    del state, graphed, batches, stacked
    release_memory()


def dp_lfvila_config(folder: str, kernel: bool) -> str:
    """The stage-1 preset at full width, its depth cut (one block a Swin3D
    stage but two at stage 2, 2 + 2 BERT layers), written to ``folder``; the
    window kernel on for the eval config."""
    with open(os.path.join(REPO, STAGE_PRESETS[1])) as f:
        cfg = json.load(f)
    cfg["video_encoder"]["depths"] = DP_LFVILA["depths"]
    cfg["num_local_layers"], cfg["stage1_layers"] = DP_LFVILA["bert_layers"]
    if kernel:
        cfg["video_encoder"]["use_pallas_attention"] = True
    path = os.path.join(folder, f"lfvila_dp_{'kernel' if kernel else 'train'}.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def data_parallel_lfvila_runs(card: str, folder: str, tag: str) -> dict:
    """Phase 8c's two runs, with or without the group as the caller set up:
    ``run_pretrain_lfvila --stage 1`` (MTC and InfoNCE over the global batch,
    ZeRO-2) for 3 steps with a save, then ``run_tasks_lfvila --task
    retrieval`` without a train step on the kernel config. Returns
    {"train": finished_run, "eval": (report, launches)}."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila, run_tasks_lfvila

    out = {}
    with tempfile.TemporaryDirectory() as out_dir:
        release_memory()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            run_pretrain_lfvila.main([
                "--config", dp_lfvila_config(folder, kernel=False), "--stage", "1", "--dummy_data", "1",
                "--device_ingest", "1", "--train_batch_size", str(DP_LFVILA["batch"]),
                "--num_train_steps", str(DP_LFVILA["steps"]), "--log_steps", "1",
                "--save_steps", str(DP_LFVILA["steps"]), "--zero2", "1", "--device", "cuda", "--output_dir", out_dir])
            torch.cuda.synchronize()
            out["train"] = finished_run(out_dir, None, launch_counts())
        check(not plain_cuda_calls, f"{tag}: the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    with tempfile.TemporaryDirectory() as out_dir:
        size = run_tasks_lfvila.DUMMY_SIZE
        run_tasks_lfvila.DUMMY_SIZE = DP_LFVILA["eval_samples"]
        try:
            with plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_tasks_lfvila.main([
                    "--task", "retrieval", "--config", dp_lfvila_config(folder, kernel=True), "--dummy_data", "1",
                    "--num_train_steps", "0", "--val_batch_size", str(DP_LFVILA["batch"]), "--device", "cuda",
                    "--output_dir", out_dir])
                torch.cuda.synchronize()
                out["eval"] = (report, launch_counts())
        finally:
            run_tasks_lfvila.DUMMY_SIZE = size
        check(not plain_cuda_calls, f"{tag}: the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    return out


def data_parallel_lfvila_phase(card: str) -> dict:
    """Phase 8c: :func:`data_parallel_lfvila_runs` without a group, then
    under the one-rank NCCL group: the training run held as 8a's, the eval's
    report equal and its window launches equal (and > 0). Returns the
    group's launch counts, training and eval."""
    from xpretrain_tpu_torch.parallel import mesh

    with tempfile.TemporaryDirectory() as folder:
        without = data_parallel_lfvila_runs(card, folder, "without a group")
        with one_rank_nccl_group():
            grouped = data_parallel_lfvila_runs(card, folder, "one-rank group")
            check(mesh.current_mesh() is not None, "run_pretrain_lfvila joined no group")
    hold_to_ungrouped("8c LF-VILA stage 1", grouped["train"], without["train"], card)
    (report, launches), (want_report, want_launches) = grouped["eval"], without["eval"]
    same = measured_report(report) == measured_report(want_report)
    print(f"  8c LF-VILA retrieval eval, window kernel on, {DP_LFVILA['eval_samples']} clips: t2v "
          f"{ {k: report['t2v'][k] for k in ('R1', 'R5', 'R10')} }; launches {launches} (without a group "
          f"{want_launches}); report equal to the one without a group: {same} [{card}]")
    check(same, "8c: the eval report differs from the one without a group")
    check(launches == want_launches and launches["window_attention_fwd"] > 0,
          f"8c eval launches {launches}, without a group {want_launches}")
    return {"train": grouped["train"]["launches"], "eval": launches}


def zero3_finetune_phase(card: str, reference: dict) -> dict:
    """Phase 9a, inside :func:`one_rank_nccl_group`: phase 4b's run of
    ``run_retrieval_clipvip`` at ``--zero3 1`` (each parameter of >= 16384
    elements in its one data rank's block, the whole leaf, gathered by
    all-gathers of one rank), eagerly and at ``--steps_per_call 2``, each
    held to 4b's run without a group and required bit-identical. Returns
    each run's launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_retrieval_clipvip
    from xpretrain_tpu_torch.parallel import mesh

    launches = {}
    for k in (1, DP_GRAPH_K):
        with tempfile.TemporaryDirectory() as out_dir, built_trainers(run_retrieval_clipvip,
                                                                       "ClipVipTrainer") as rec:
            release_memory()
            t0 = time.perf_counter()
            with plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_retrieval_clipvip.main(finetune_argv(out_dir) + ["--zero3", "1", "--steps_per_call",
                                                                              str(k)])
                torch.cuda.synchronize()
                counts = launch_counts()
            wall = time.perf_counter() - t0
            group = mesh.current_mesh()
            trainer = rec["built"][0]
            zero3 = sum(lay.dp_dim is not None for lay in trainer.layouts.values())
            check(group is not None and group.backend == "nccl" and zero3 > 0,
                  f"--zero3 1 under the group sharded no parameter ({group})")
            graphs = capture_launches(trainer.train_step) if k > 1 else []
            tag = "eager" if k == 1 else f"--steps_per_call {k} ({len(graphs)} graph(s), launches recorded {graphs})"
            print(f"  {tag}: group {group.backend} rank {group.rank} of {group.world_size}, {zero3} of "
                  f"{len(trainer.optimizer.names)} parameters ZeRO-3 sharded; run wall {wall:.1f} s [{card}]")
            check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
            same = hold_to_ungrouped(f"9a {tag}", finished_run(out_dir, report, counts), reference, card)
            check(same, f"9a {tag}: not bit-identical to 4b's run")
            launches[k] = counts
            del rec["built"][:], trainer
    return launches


def tp_plan_phase(card: str) -> dict:
    """Phase 9b: ``LAYOUT_STEPS`` eager B/32 bf16 train steps at b=32 without
    a group, then with the plan ``--tp N`` applies
    (``parallel/tensor_parallel.py:apply_tensor_parallel``) over a 1 x 1
    (data, model) mesh of the one-rank NCCL group: losses, grad norms and
    every parameter bit-identical, launches equal. Then the proxy kernels at
    the local shapes of ``--tp 2`` and ``4`` with phases 3 and 3b's bars, and
    the graphed step's time at world size 1 under the TP plan and under
    ZeRO-3 (8b's measure). Returns the TP run's launch counts."""
    import torch
    from xpretrain_tpu_torch.config import ConfigDict
    from xpretrain_tpu_torch.parallel import fsdp, mesh
    from xpretrain_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel

    batches, stacked = b32_train_batches(LAYOUT_STEPS)
    step = b32_steps(1)[0]

    def run(state):
        reset_launches()
        rows = [step(state, b, i)[1] for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        counts = launch_counts()
        params = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        return [{k: float(v) for k, v in r.items()} for r in rows], params, counts

    mesh.destroy_distributed()
    want_rows, want_params, want_counts = run(b32_train_state(False, lr=1e-6))
    release_memory()
    group = mesh.maybe_init_distributed("cuda")
    group = mesh.init_model_axis(1)
    check(group.has_model_axis and group.model_size == 1 and group.world_size == 1, f"the 1 x 1 mesh: {group}")
    layouts = {}
    state = b32_train_state(False, lr=1e-6, layout=lambda m: layouts.update(apply_tensor_parallel(m, group))
                            or layouts)
    got_rows, got_params, got_counts = run(state)
    tp_leaves = sum(lay.tp_dim is not None for lay in layouts.values())
    same_rows = got_rows == want_rows
    same_params = all(torch.equal(got_params[n], want_params[n]) for n in want_params)
    worst = max((got_params[n].float() - want_params[n].float()).abs().max().item() for n in want_params)
    print(f"  TP plan at mp=1: {tp_leaves} parameters column/row-sharded (one block each), "
          f"{sum(lay.model_partial for lay in layouts.values())} model-partial; losses "
          f"{[r['loss'] for r in got_rows]} (without a group {[r['loss'] for r in want_rows]}); metrics "
          f"bit-identical {same_rows}, parameters bit-identical {same_params} (largest difference {worst:.3e}); "
          f"launches {got_counts} (without {want_counts}) [{card}]")
    check(tp_leaves > 0 and same_rows and same_params, "9b: the TP plan at mp=1 is not bit-identical to the step")
    check(got_counts == want_counts and got_counts["proxy_attention_fwd"] > 0, "9b: launches differ")
    del state, got_params, want_params
    release_memory()
    for name, s in TP_PROXY_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            check_proxy_fwd(name, s, dtype)
            check_proxy_bwd(name, s, dtype)
    # records: the graphed step's time at world size 1 under each layout (8b's measure)
    timed = {}
    for tag, layout in (("TP plan, mp=1", lambda m: apply_tensor_parallel(m, group)),
                        ("ZeRO-3, dp=1", lambda m: fsdp.apply_layouts(ConfigDict(zero3=1), m))):
        state = b32_train_state(False, lr=1e-6, layout=layout)
        graphed = b32_steps(DP_GRAPH_K)[1]
        graphed(state, stacked, 0)  # warm-up and capture
        timed.update(time_steps({tag: lambda: graphed(state, stacked, 0)}, DP_GRAPH_K, card,
                                f"B/32 bf16 train step b=32 at K={DP_GRAPH_K},"))
        del state, graphed
        release_memory()
    del batches, stacked
    return got_counts


def cp_towers_phase(card: str, preset: dict) -> dict:
    """Phase 9c, on 9b's 1 x 1 mesh: the LF-VILA towers of 4c (bf16, window
    kernel on) built as ``--cp`` builds them (``context_parallel_axis``), at
    b=8 on one batch, against the same towers without it: bit-identical
    video and text features, ``WINDOW_BLOCKS`` window launches a video
    call; then the window kernel at one rank's stage-3 windows under ``--cp
    2`` with phase 3c's bars. Returns the cp call's launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_tasks_lfvila
    from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval
    from xpretrain_tpu_torch.parallel import mesh

    group = mesh.current_mesh()
    check(group is not None and group.has_model_axis, "9c runs on 9b's mesh")
    models = {}
    for tag, cfg in (("plain", preset), ("cp", {**preset, "cp": 2})):
        model = LfVilaRetrieval(run_tasks_lfvila.lfvila_config_from(cfg), device="cuda")
        models[tag] = model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    check(models["cp"].video_encoder.context_mesh() is group, "the cp towers do not shard time")
    g = torch.Generator(device="cuda").manual_seed(1)
    b = LFVILA_BATCH
    frames = torch.randn(b, 3, 32, 192, 320, device="cuda", generator=g)
    ids = torch.randint(1, 30522, (b, 4, 70), device="cuda", generator=g)
    mask = (torch.arange(70, device="cuda")[None, None] < torch.randint(5, 70, (b, 4, 1), device="cuda",
                                                                         generator=g)).long()
    out = {}
    with torch.inference_mode():
        for tag, model in models.items():
            reset_launches()
            out[tag] = (model.forward_video(frames), model.forward_text(ids, mask))
            torch.cuda.synchronize()
            out[tag] += (launch_counts(),)
    same = all(torch.equal(a, b_) for a, b_ in zip(out["cp"][:2], out["plain"][:2]))
    print(f"  towers at b={b}: video {tuple(out['cp'][0].shape)} and text {tuple(out['cp'][1].shape)} features "
          f"through the cp path at model size 1 bit-identical to the towers without it: {same}; launches "
          f"{out['cp'][2]} (without {out['plain'][2]}) [{card}]")
    check(same, "9c: the cp towers differ from the towers without the cp path")
    counts = out["cp"][2]
    check(counts == out["plain"][2] == expected(window_attention_fwd=WINDOW_BLOCKS), "9c: window launches")
    del models, frames, out
    release_memory()
    for name, shape in CP_WINDOW_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            check_window(name, shape, dtype)
    return counts


# ---------------------------------------------------------------------------
# Phase 10: the JAX modules that reach no Pallas kernel (ring attention, the
# GPipe pipeline, the MoE FFN) at full width over a one-rank NCCL group: each
# axis of one rank, where lax.ppermute is the identity
# ---------------------------------------------------------------------------

RING = dict(B=4, H=16, S=2048, D=64)  # BERT-large's heads over 2048 tokens
RING_GRAD_REL = 3e-5  # fp32 gradients, relative to max|g| (JAX's bar, tests/test_ring_attention.py:80)
PIPE = dict(batch=16, seq=50, microbatches=4)  # BERT-large at hdvila_pretrain_stage2.json's max_txt_len
# B/32's MLP widths over the vision tokens of 8 clips (12 frames x 49 patches + 4 proxy tokens each)
MOE = dict(clips=8, tokens=592, d=768, d_ff=3072, experts=8, capacity_factor=1.25)
PHASE10_ITERS = 5  # calls per CUDA-event timing


def sync(device: str) -> None:
    """Wait for the card (phase 10's functions also run on the CPU)."""
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1e-30)).item()


def dense_attention(q, k, v, mask):
    """The plain version of ring attention at one rank: one fp32 softmax over
    all keys, the mask a -1e30 key bias, the output in q's dtype."""
    import torch

    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    s = s + ((1.0 - mask.float()) * -1e30)[:, None, None, :]
    return torch.matmul(torch.softmax(s, dim=-1), v.float()).to(q.dtype)


def axis_mesh(shape: tuple, names: tuple, device: str):
    """``create_mesh(shape, names)`` under the run's group, as phase 10 forms
    each mesh, which must leave the run's mesh as it is (JAX's
    ``create_mesh`` only builds a ``Mesh``): the current mesh the same object
    and a ``gather_rows`` of the run's mesh the same rows, before and after.
    Returns the new mesh."""
    import torch
    from xpretrain_tpu_torch.parallel import mesh

    run = mesh.current_mesh()
    rows = torch.arange(6, dtype=torch.float32, device=device).reshape(2, 3)
    before = mesh.gather_rows(rows)
    made = mesh.create_mesh(shape, names)
    after = mesh.gather_rows(rows)
    kept = mesh.current_mesh() is run
    print(f"  create_mesh({shape}, {names}) under the run's {run.backend} group: the run's mesh the same object "
          f"{kept}, gather_rows of it the same rows before and after {torch.equal(before, after)} "
          f"{tuple(after.shape)}; the new mesh's {names[-1]} axis of {made.model_size}")
    check(kept and made is not run and made.model_axis == names[-1] and torch.equal(before, after),
          f"create_mesh{shape, names} changed the run's mesh: {run} -> {mesh.current_mesh()}")
    return made


def one_process_mesh_phase(card: str, device: str = "cuda", shape: dict = RING) -> dict:
    """Phase 7f, in a process with no group (before phase 8 forms one):
    JAX's one-device call sequence, ``create_mesh((1,), ("seq",))``, returns
    a one-rank mesh on ``cuda:0`` (``device`` when it is not cuda) and leaves
    no current mesh; ring attention through it at 10a's shapes, fp32 and
    bf16, equals the ``mesh=None`` call bit for bit, the gradients of
    ``sum(out * w)`` included. Returns the launch counts of the ring's runs
    (none of the six kernels)."""
    import torch
    from xpretrain_tpu_torch.ops.ring_attention import make_ring_attention, sequence_block
    from xpretrain_tpu_torch.parallel import mesh

    check(mesh.current_mesh() is None, f"7f runs without a group: {mesh.current_mesh()}")
    seq = mesh.create_mesh((1,), ("seq",), devices=None if device == "cuda" else [device])
    want_device = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    check(mesh.current_mesh() is None and seq.device == want_device
          and (seq.world_size, seq.model_size, seq.model_axis) == (1, 1, "seq"), f"7f: {seq}")
    B, H, S, D = (shape[n] for n in ("B", "H", "S", "D"))
    g = torch.Generator(device=device).manual_seed(0)
    base = [torch.randn(B, H, S, D, device=device, generator=g) for _ in range(4)]
    mask = (torch.arange(S, device=device)[None] < torch.randint(S // 4, S + 1, (B, 1), device=device,
                                                                  generator=g)).long()
    counts = expected()
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, w = (t.to(dtype) for t in base)
        runs = {}
        for tag, m in (("mesh", seq), ("none", None)):
            args = [sequence_block(t, m).clone().requires_grad_(True) for t in (q, k, v)]
            with plain_on_cuda_guard() as plain_calls:
                reset_launches()
                out = make_ring_attention(m)(*args, sequence_block(mask, m, dim=1))
                (out.float() * w.float()).sum().backward()
                sync(device)
                run = launch_counts()
            check(not plain_calls and run == expected(), f"7f: plain calls {plain_calls}, launches {run}")
            counts = {n: counts[n] + run[n] for n in counts}
            runs[tag] = [out.detach()] + [a.grad for a in args]
        same = all(torch.equal(a, b) for a, b in zip(runs["mesh"], runs["none"]))
        print(f"  ring attention {str(dtype).replace('torch.', '')} [{B}, {H}, {S}, {D}] on create_mesh((1,), "
              f"('seq',)) ({seq.device}, backend {seq.backend!r}; current mesh {mesh.current_mesh()}) against "
              f"mesh=None: output and dq, dk, dv bit-identical {same} [{card}]")
        check(same and bool(torch.isfinite(runs["mesh"][0]).all()), "7f: the one-rank mesh against mesh=None")
        del runs
    check(mesh.current_mesh() is None, "7f: a current mesh appeared")
    return counts


def ring_attention_phase(card: str, device: str = "cuda", shape: dict = RING) -> dict:
    """Phase 10a: ``make_ring_attention`` on a (data, seq) mesh of one rank
    at [B, H, S, D] with a padding mask, fp32 and bf16, forward and the
    gradients of ``sum(out * w)``, against :func:`dense_attention` on the
    same inputs (fp32: 2e-5 and 3e-5·max|g|; bf16: 2e-2 and 2e-2·max|g|);
    both timed. Returns the launch counts of the ring's runs."""
    import torch
    from xpretrain_tpu_torch.ops.ring_attention import make_ring_attention, sequence_block
    from xpretrain_tpu_torch.parallel import mesh
    from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

    check(mesh.maybe_init_distributed(device) is not None, "phase 10 runs under a one-rank group")
    group = axis_mesh((1, 1), ("data", "seq"), device)
    ring = make_ring_attention(group, seq_axis="seq", data_axis="data")
    B, H, S, D = (shape[n] for n in ("B", "H", "S", "D"))
    g = torch.Generator(device=device).manual_seed(0)
    base = [torch.randn(B, H, S, D, device=device, generator=g) for _ in range(4)]
    lengths = torch.randint(S // 4, S + 1, (B, 1), device=device, generator=g)
    mask = (torch.arange(S, device=device)[None] < lengths).long()
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        q, k, v, w = (t.to(dtype) for t in base)
        outs, grads = {}, {}
        for tag, fn in (("ring", ring), ("dense", dense_attention)):
            args = [sequence_block(t, group).clone().requires_grad_(True) for t in (q, k, v)]
            with plain_on_cuda_guard() as plain_calls:
                reset_launches()
                out = fn(*args, sequence_block(mask, group, dim=1))
                (out.float() * w.float()).sum().backward()
                sync(device)
                if tag == "ring":
                    counts[name] = launch_counts()
            check(not plain_calls, f"10a: plain kernel versions on CUDA: {plain_calls}")
            outs[tag], grads[tag] = out.detach(), [a.grad for a in args]
        bar = TOL[name]
        err = (outs["ring"].float() - outs["dense"].float()).abs().max().item()
        gerr = [_rel_err(a, b) for a, b in zip(grads["ring"], grads["dense"])]
        gbar = RING_GRAD_REL if dtype == torch.float32 else TOL[name]
        same = torch.equal(outs["ring"], outs["dense"])
        print(f"  ring attention {name} [{B}, {H}, {S}, {D}], padding mask: max abs {err:.3e} vs the dense "
              f"softmax (bar {bar}), bit-identical {same}; dq, dk, dv {', '.join(f'{e:.3e}' for e in gerr)} of "
              f"max|g| (bar {gbar}); launches {counts[name]} [{card}]")
        check(tuple(outs["ring"].shape) == (B, H, S, D) and bool(torch.isfinite(outs["ring"]).all()),
              f"10a {name}: output")
        check(err <= bar and all(e <= gbar for e in gerr), f"10a {name}: ring attention against the dense softmax")
        check(counts[name] == expected(), f"10a: launches {counts[name]}")
        if device == "cuda":
            qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
            times = {}
            for tag, fn in (("dense", dense_attention), ("ring", ring), ("ring ", ring), ("dense ", dense_attention)):
                fwd = cuda_time_ms(lambda: fn(q, k, v, mask), iters=PHASE10_ITERS, warmup=1)
                both = cuda_time_ms(lambda: (fn(*qkv, mask).float() * w.float()).sum().backward(),
                                    iters=PHASE10_ITERS, warmup=1)
                times.setdefault(tag.strip(), []).append((fwd, both))
            print(f"  ring attention {name}: forward "
                  f"{', '.join(f'{t} {mean([f for f, _ in x]):.4f}' for t, x in times.items())} ms; forward + "
                  f"backward {', '.join(f'{t} {mean([b for _, b in x]):.4f}' for t, x in times.items())} ms "
                  f"(CUDA events, {PHASE10_ITERS} calls, in turns dense, ring, ring, dense) [{card}]")
        del outs, grads
    return counts["bfloat16"]


def pipeline_phase(card: str, device: str = "cuda", cfg=None, shape: dict = PIPE) -> dict:
    """Phase 10b: ``pipelined_bert_encoder`` on a (data, pipe) mesh of one
    rank (BERT-large unless ``cfg``, fp32, M microbatches) against
    ``StagedBertEncoder`` on the same weights: the output within 2e-5, the
    stacked gradients of ``sum(out * w)`` within 3e-5 of the layers' largest
    gradient and the input's within 3e-5 of its own
    (bit-identity reported); both timed. Returns the pipeline's launch
    counts."""
    import torch
    from xpretrain_tpu_torch.models.bert import BertConfig, StagedBertEncoder
    from xpretrain_tpu_torch.models.common import expand_padding_mask
    from xpretrain_tpu_torch.parallel import mesh
    from xpretrain_tpu_torch.parallel.pipeline import (
        pipeline_param_shardings,
        pipelined_bert_encoder,
        stack_layer_params,
    )
    from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

    cfg = cfg or BertConfig.bert_large()
    check(mesh.maybe_init_distributed(device) is not None, "phase 10 runs under a one-rank group")
    group = axis_mesh((1, 1), ("data", "pipe"), device)
    g = torch.Generator(device=device).manual_seed(0)
    encoder = StagedBertEncoder(cfg, device=device).eval()
    with torch.no_grad():
        for p in encoder.parameters():
            if p.dim() >= 2:
                p.normal_(0.0, 0.02, generator=g)
    L, b, s = cfg.num_hidden_layers, shape["batch"], shape["seq"]
    stacked = {n: t.detach().clone().requires_grad_(True)
               for n, t in stack_layer_params(encoder.state_dict(), L).items()}
    stage = pipeline_param_shardings(stacked, group, "pipe")
    run = pipelined_bert_encoder(cfg, group, pipe_axis="pipe", data_axis="data",
                                 n_microbatches=shape["microbatches"])
    hidden = torch.randn(b, s, cfg.hidden_size, device=device, generator=g)
    lengths = torch.randint(s // 4, s + 1, (b, 1), device=device, generator=g)
    mask = expand_padding_mask((torch.arange(s, device=device)[None] < lengths).long())
    w = torch.randn(b, s, cfg.hidden_size, device=device, generator=g)
    x_pipe, x_seq = hidden.clone().requires_grad_(True), hidden.clone().requires_grad_(True)
    with plain_on_cuda_guard() as plain_calls:
        reset_launches()
        got = run(stage, x_pipe, mask)
        (got * w).sum().backward()
        sync(device)
        counts = launch_counts()
    check(not plain_calls, f"10b: plain kernel versions on CUDA: {plain_calls}")
    want = encoder(x_seq, mask)
    (want * w).sum().backward()
    err = (got - want).abs().max().item()
    want_g = stack_layer_params({n: p.grad for n, p in encoder.named_parameters()}, L)
    # relative to the largest gradient of all the layers: a key bias's own is
    # rounding alone (the softmax ignores a constant added to a query's scores)
    gmax = max(want_g[n].abs().max().item() for n in stacked)
    gerr = max((stacked[n].grad - want_g[n]).abs().max().item() for n in stacked) / gmax
    xerr = _rel_err(x_pipe.grad, x_seq.grad)
    same = torch.equal(got, want) and all(torch.equal(stacked[n].grad, want_g[n]) for n in stacked)
    print(f"  pipeline of BERT ({L} layers, {cfg.hidden_size} wide) at pipe=1, M={shape['microbatches']}, "
          f"b={b}, S={s}, fp32: max abs {err:.3e} vs StagedBertEncoder (bar 2e-5); stacked gradients "
          f"{gerr:.3e} of the layers' max|g| and input gradient {xerr:.3e} of its max|g| (bar 3e-5); bit-identical {same}; launches "
          f"{counts} [{card}]")
    check(tuple(got.shape) == (b, s, cfg.hidden_size) and bool(torch.isfinite(got).all()), "10b: output")
    check(err <= 2e-5 and gerr <= 3e-5 and xerr <= 3e-5, "10b: the pipeline against the sequential encoder")
    check(counts == expected(), f"10b: launches {counts}")
    if device == "cuda":
        times = {}
        for tag, fn in (("sequential", lambda x: encoder(x, mask)), ("pipeline", lambda x: run(stage, x, mask)),
                        ("pipeline ", lambda x: run(stage, x, mask)), ("sequential ", lambda x: encoder(x, mask))):
            x = hidden.clone().requires_grad_(True)
            with torch.no_grad():
                fwd = cuda_time_ms(lambda: fn(hidden), iters=PHASE10_ITERS, warmup=1)
            both = cuda_time_ms(lambda: (fn(x) * w).sum().backward(), iters=PHASE10_ITERS, warmup=1)
            times.setdefault(tag.strip(), []).append((fwd, both))
        print(f"  BERT-large b={b}: forward {', '.join(f'{t} {mean([f for f, _ in x]):.4f}' for t, x in times.items())}"
              f" ms; forward + backward {', '.join(f'{t} {mean([v for _, v in x]):.4f}' for t, x in times.items())}"
              f" ms (CUDA events, {PHASE10_ITERS} calls, in turns) [{card}]")
    del encoder, stacked, stage
    return counts


def moe_loop_reference(ffn, x):
    """The per-expert loop of ``tests/test_moe.py:_dense_reference`` with no
    drop: each token's top-k experts by router prob, gates renormalized for
    k > 1, y = sum of gate · MLP_e(x), fp32."""
    import torch

    probs = torch.softmax(x.float() @ ffn.router, dim=-1)
    gates, picks = torch.topk(probs, ffn.num_selected, dim=-1)
    if ffn.num_selected > 1:
        gates = gates / gates.sum(dim=-1, keepdim=True)
    y = torch.zeros_like(x)
    for e in range(ffn.num_experts):
        for j in range(ffn.num_selected):
            rows = (picks[:, j] == e).nonzero()[:, 0]
            h = ffn.activation(x[rows] @ ffn.w1[e] + ffn.b1[e])
            y.index_add_(0, rows, gates[rows, j:j + 1] * (h @ ffn.w2[e] + ffn.b2[e]))
    return y


def moe_phase(card: str, device: str = "cuda", shape: dict = MOE) -> dict:
    """Phase 10c: ``MoeFfn`` on a (data, expert) mesh of one rank, top-1 and
    top-2, fp32 and bf16, on [clips x tokens, d] tokens: at the capacity
    factor, a finite output, tokens dropped and the drops of the card's
    routing equal to the same routing on the CPU, every expert trained by
    ``mean(y**2) + 0.01 ·
    aux``, the expert leaves on the card; at ample capacity (C = k·T, no
    drop) the fp32 output within 2e-5 of :func:`moe_loop_reference`; ms of a
    forward + backward and the run's peak GiB (above what was allocated
    before it). Returns the launch counts of the runs
    at the capacity factor."""
    import torch
    from xpretrain_tpu_torch.parallel import mesh
    from xpretrain_tpu_torch.parallel.moe import MoeFfn, _topk_dispatch
    from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

    check(mesh.maybe_init_distributed(device) is not None, "phase 10 runs under a one-rank group")
    group = axis_mesh((1, 1), ("data", "expert"), device)
    T, d, E = shape["clips"] * shape["tokens"], shape["d"], shape["experts"]
    g = torch.Generator(device=device).manual_seed(0)
    # a component shared by a clip's tokens (as its patches share content) makes
    # the router's loads uneven, so the capacity binds
    x = (torch.randn(shape["clips"], 1, d, device=device, generator=g)
         + torch.randn(shape["clips"], shape["tokens"], d, device=device, generator=g))
    counts = expected()
    for k in (1, 2):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            ffn = MoeFfn(d, E, shape["d_ff"], num_selected=k, capacity_factor=shape["capacity_factor"],
                         expert_axis="expert", mesh=group, dtype=dtype, device=device,
                         generator=torch.Generator(device=device).manual_seed(k))
            check(all(p.device.type == device for p in ffn.parameters()), "10c: a leaf off the card")
            capacity = max(1, int(math.ceil(k * T / E * shape["capacity_factor"])))
            if device == "cuda":
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated() if device == "cuda" else 0
            with plain_on_cuda_guard() as plain_calls:
                reset_launches()
                y, aux = ffn(x)
                ((y.float() ** 2).mean() + 0.01 * aux).backward()
                sync(device)
                run_counts = launch_counts()
            check(not plain_calls, f"10c: plain kernel versions on CUDA: {plain_calls}")
            counts = {n: counts[n] + run_counts[n] for n in counts}
            # the run's own peak: above what was allocated before it (earlier phases' leftovers included there)
            peak = (torch.cuda.max_memory_allocated() - before) / 2**30 if device == "cuda" else float("nan")
            trained = (ffn.w1.grad.abs().sum(dim=(1, 2)) > 0) & (ffn.w2.grad.abs().sum(dim=(1, 2)) > 0)
            with torch.no_grad():
                probs = torch.softmax(x.reshape(T, d).float() @ ffn.router, dim=-1)
                here = _topk_dispatch(probs, k, capacity, group)[0]
                cpu = _topk_dispatch(probs.cpu(), k, capacity)[0]
            same_routing = torch.equal(here.cpu(), cpu)
            dropped = T * k - int(here.sum().item())
            print(f"  MoE top-{k} {name}, {E} experts of d_ff {shape['d_ff']} at d={d}, T={T}, capacity factor "
                  f"{shape['capacity_factor']} (C={capacity}): y {tuple(y.shape)}, aux {aux.item():.6f}; "
                  f"{dropped} of {T * k} token choices dropped, dispatch equal to the CPU's routing of the same "
                  f"probs: {same_routing}; experts trained {int(trained.sum())}/{E}; peak {peak:.2f} GiB above the "
                  f"{before / 2**30:.2f} allocated before the run; "
                  f"launches {run_counts} [{card}]")
            check(tuple(y.shape) == tuple(x.shape) and y.dtype == dtype and bool(torch.isfinite(y).all())
                  and math.isfinite(aux.item()), f"10c top-{k} {name}: output")
            check(same_routing and dropped > 0 and bool(trained.all()) and bool(ffn.router.grad.abs().sum() > 0),
                  f"10c top-{k} {name}: routing, drops or gradients")
            check(run_counts == expected(), f"10c: launches {run_counts}")
            if dtype == torch.float32:
                ample = MoeFfn(d, E, shape["d_ff"], num_selected=k, capacity_factor=float(E), expert_axis="expert",
                               mesh=group, device=device)
                ample.load_state_dict(ffn.state_dict())
                with torch.no_grad():
                    y_ample, _ = ample(x)
                    want = moe_loop_reference(ample, x.reshape(T, d)).reshape(x.shape)
                err = (y_ample - want).abs().max().item()
                print(f"  MoE top-{k} fp32 at ample capacity (C={k * T}): max abs {err:.3e} vs the per-expert "
                      f"loop (bar 2e-5) [{card}]")
                check(err <= 2e-5, f"10c top-{k}: MoE against the per-expert loop")
                del ample, y_ample, want
            if device == "cuda":
                xs = x.clone().requires_grad_(True)
                ms = cuda_time_ms(lambda: (lambda yy, aa: ((yy.float() ** 2).mean() + 0.01 * aa).backward())(
                    *ffn(xs)), iters=PHASE10_ITERS, warmup=1)
                fwd = cuda_time_ms(lambda: ffn(x), iters=PHASE10_ITERS, warmup=1)
                print(f"  MoE top-{k} {name}: forward {fwd:.4f} ms, forward + backward {ms:.4f} ms (CUDA events, "
                      f"{PHASE10_ITERS} calls) [{card}]")
            del ffn, y, aux, here, cpu, probs
            if device == "cuda":
                release_memory()
    return counts


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device: this smoke test runs on an NVIDIA card only")
    sys.path.insert(0, REPO)
    try:
        from xpretrain_tpu_torch.cli import run_retrieval_clipvip, run_tasks_lfvila
        from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, normalize
        from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel
        from xpretrain_tpu_torch.models.common import dot_attention
        from xpretrain_tpu_torch.ops import _kernels
        from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval
        from xpretrain_tpu_torch.optim import adamw_kernel
        from xpretrain_tpu_torch.ops import patchify as pp
        from xpretrain_tpu_torch.ops import proxy_attention as pa
        from xpretrain_tpu_torch.ops import window_attention as wa
        from xpretrain_tpu_torch.parallel.train_step import batch_to_device
        from xpretrain_tpu_torch.serving.towers import LfVilaTowers, RetrievalTowers
        from xpretrain_tpu_torch.tools.profile_train_step import (
            captions, device_ms, median, spread, synthetic_batch, time_train_step, train_step_parts, window_ms,
        )
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    import numpy as np

    with phase("1 card"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    with phase("2 build"):
        t0 = time.perf_counter()
        _kernels.load_library()
        lib = _kernels.library_path()
        sources = ", ".join(sorted({src for src, _ in KERNELS.values()}))
        print(f"built {lib.relative_to(REPO)} from {sources} "
              f"({' '.join(_kernels.NVCC_FLAGS[:2])}) in {time.perf_counter() - t0:.1f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        # bf16 runs on the tensor cores, fp32 on the CUDA cores; the attention
        # kernels at the main paths' head dims
        resources = _kernels.kernel_resources(B32["D"], WINDOW_SHAPES["s3"][3])
        for row in resources:
            dynamic = f"{row['dynamic_smem']} B dynamic" if "dynamic_smem" in row else "dynamic by tile"
            print(f"  {row['kernel']:44s} {row['dtype']:8s}: {row['registers']} registers, "
                  f"spills {row.get('spill_stores', 0)}/{row.get('spill_loads', 0)} B (stores/loads), "
                  f"shared memory {row['static_smem']} B static + {dynamic}, {row['hmma']} HMMA in its SASS")
        check(all(row["hmma"] > 0 for row in resources if row["tensor_cores"]),
              "a bf16 tensor-core kernel has no tensor-core instruction")

    with phase("3 kernel vs plain"):
        errors = {}
        for name, s in CHECK_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                errors[(name, str(dtype).split(".")[-1])] = check_proxy_fwd(name, s, dtype)

    with phase("3b backward kernel vs plain"):
        bwd_errors = {}
        for name, s in {**CHECK_SHAPES, "b32_train": B32_TRAIN}.items():
            for dtype in (torch.float32, torch.bfloat16):
                for mode, err in check_proxy_bwd(name, s, dtype).items():
                    bwd_errors[(name, str(dtype).split(".")[-1], mode)] = err
        # gradcheck-style: the kernels' gradient through proxy_attention is
        # autograd's through the plain forward (fp32, the tiny shape)
        s = CHECK_SHAPES["tiny"]
        q, k, v, d_out = qkv(s, torch.float32, seed=2, n=4)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = pa.proxy_attention_bwd.launches
        pa.proxy_attention(*leaves, s["M"], s["N"], s["L"], s["D"] ** -0.5).backward(d_out)
        torch.cuda.synchronize()
        check(pa.proxy_attention_bwd.launches == before + 1, "autograd did not launch the backward kernel")
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        pa.proxy_attention_plain(*ref, s["M"], s["L"], s["D"] ** -0.5).backward(d_out)
        err = max((a.grad - b.grad).abs().max().item() for a, b in zip(leaves, ref))
        print(f"  autograd through the kernels vs through the plain forward (tiny, fp32): "
              f"max_abs {err:.3e} (tol {BWD_TOL_FP32:.0e})")
        check(err <= BWD_TOL_FP32, f"kernel autograd vs plain autograd: {err}")

    with phase("3c window kernel vs plain"):
        win_errors = {}
        for name, shape in WINDOW_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                win_errors[(name, str(dtype).split(".")[-1])] = check_window(name, shape, dtype)
        # the model's q/k/v: views of one fused [Bn, N, 3, H, d] projection,
        # read in place through their strides
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, mask = window_inputs(WINDOW_SHAPES["s3_shifted"], dtype, seed=1)
            views = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous().permute(2, 0, 3, 1, 4)
            check(not views[0].is_contiguous(), "the qkv views are contiguous")
            before = wa.window_attention.launches
            got = wa.window_attention(views[0], views[1], views[2], bias, mask)
            torch.cuda.synchronize()
            check(wa.window_attention.launches == before + 1, "strided: launch not counted")
            same = torch.equal(got, wa.window_attention(q, k, v, bias, mask))
            exact = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
            dt = str(dtype).split(".")[-1]
            err = (got.float() - exact).abs().max().item()
            win_errors[("s3_shifted_views", dt)] = err
            line = (f"  s3_shifted on qkv views (strides {views[0].stride()}) {dt:8s} vs fp32 plain max_abs "
                    f"{err:.3e}; bit-equal to the contiguous call: {same}")
            check(same, f"strided {dt}: the views give another result than the contiguous tensors")
            if dtype == torch.float32:
                check(err <= TOL[dt], f"strided fp32: max_abs {err} > {TOL[dt]}")
            else:
                ulps = bf16_ulps(got, exact)
                line += f", {ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})"
                check(ulps <= BF16_MAX_ULP, f"strided bf16: {ulps} ulp from the fp32 plain version")
            print(line)
            del q, k, v, bias, mask, views, got, exact

    with phase("3d packed proxy attention (strided kernels) vs plain and vs the [B,H,S,D] kernels"):
        packed_errors = {}
        for name, s in CHECK_SHAPES.items():
            D, scale = s["D"], s["D"] ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv(s, dtype)
                pq, pk, pv = (packed(t) for t in (q, k, v))
                before = pa.proxy_attention_packed.launches
                got = pa.proxy_attention_packed(pq, pk, pv, s["M"], s["N"], s["L"], scale, D)
                torch.cuda.synchronize()
                check(pa.proxy_attention_packed.launches == before + 1, f"{name}: packed launch not counted")
                check(got.dtype == dtype and got.shape == pq.shape, f"{name}: packed output dtype/shape")
                same = torch.equal(got, packed(pa.proxy_attention(q, k, v, s["M"], s["N"], s["L"], scale)))
                want = pa.proxy_attention_packed_plain(pq, pk, pv, s["M"], s["L"], scale, D)
                dt = str(dtype).split(".")[-1]
                err = (got.float() - want.float()).abs().max().item()
                packed_errors[(name, dt)] = err
                line = (f"  forward {name:10s} {dt:8s} max_abs {err:.3e} tol {TOL[dt]:.0e}; "
                        f"bit-equal to the [B,H,S,D] kernel: {same}")
                check(math.isfinite(err) and err <= TOL[dt], f"{name} {dt} packed: max_abs {err} > {TOL[dt]}")
                if dtype == torch.bfloat16:
                    exact = pa.proxy_attention_packed_plain(pq.float(), pk.float(), pv.float(), s["M"], s["L"],
                                                            scale, D)
                    ulps = bf16_ulps(got, exact)
                    line += f"; vs fp32 plain {ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})"
                    check(ulps <= BF16_MAX_ULP, f"{name} bf16 packed: {ulps} ulp from the fp32 plain version")
                print(line)
        s = B32_TRAIN
        D, scale = s["D"], s["D"] ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, d_out = qkv(s, dtype, seed=1, n=4)
            pq, pk, pv, pd = (packed(t) for t in (q, k, v, d_out))
            before = pa.proxy_attention_packed_bwd.launches
            got = pa.proxy_attention_packed_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D)
            torch.cuda.synchronize()
            check(pa.proxy_attention_packed_bwd.launches == before + 1, "packed backward launch not counted")
            same = all(torch.equal(g, packed(w)) for g, w in
                       zip(got, pa.proxy_attention_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale)))
            want = pa.proxy_attention_packed_bwd_plain(*(t.float() for t in (pq, pk, pv, pd)), s["M"], s["L"],
                                                       scale, D)
            dt = str(dtype).split(".")[-1]
            for g, gname in zip(got, ("dq", "dk", "dv")):
                check(g.dtype == dtype and g.shape == pq.shape, f"packed {dt} {gname}: dtype/shape")
            err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
            packed_errors[("b32_train_bwd", dt)] = err
            line = f"  backward b32_train  {dt:8s} max_abs {err:.3e}"
            check(math.isfinite(err), f"packed {dt}: backward not finite")
            if dtype == torch.float32:
                line += f" (tol {BWD_TOL_FP32:.0e})"
                check(err <= BWD_TOL_FP32, f"packed fp32 backward: max_abs {err} > {BWD_TOL_FP32}")
            else:
                ulps = max(bf16_grad_ulps(g, w) for g, w in zip(got, want))
                line += f", {ulps:.3f} ulp of the fp32 plain gradients (tol {BWD_MAX_ULP:.0f})"
                check(ulps <= BWD_MAX_ULP, f"packed bf16 backward: {ulps} ulp")
            print(line + f"; bit-equal to the [B,H,S,D] kernel: {same}")
            del q, k, v, d_out, pq, pk, pv, pd, got, want
        # autograd through the packed entry on the card against autograd of
        # the plain path (fp32, the tiny shape): a strided output gradient
        s = CHECK_SHAPES["tiny"]
        leaves = [packed(t).requires_grad_() for t in qkv(s, torch.float32, seed=2)]
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        weight = packed(qkv(s, torch.float32, seed=3, n=1)[0])
        before = pa.proxy_attention_packed_bwd.launches
        (pa.proxy_attention_packed(*leaves, s["M"], s["N"], s["L"], s["D"] ** -0.5, s["D"]).transpose(0, 1)
         * weight.transpose(0, 1)).sum().backward()
        torch.cuda.synchronize()
        check(pa.proxy_attention_packed_bwd.launches == before + 1, "autograd did not launch the packed backward")
        (pa.proxy_attention_packed_plain(*ref, s["M"], s["L"], s["D"] ** -0.5, s["D"]) * weight).sum().backward()
        err = max((a.grad - b.grad).abs().max().item() for a, b in zip(leaves, ref))
        print(f"  autograd through the packed kernels vs through the plain path (tiny, fp32): "
              f"max_abs {err:.3e} (tol {BWD_TOL_FP32:.0e})")
        check(err <= BWD_TOL_FP32, f"packed kernel autograd vs plain autograd: {err}")

    with phase("3e patch-embed kernel vs plain"):
        patch_errors = {}
        for name, shape in PATCH_SHAPES.items():
            frames, kernel = patch_inputs(shape)
            want = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD)  # the plain fp32 GEMM
            top = want.abs().max().item()
            for dtype in (torch.float32, torch.bfloat16):
                before = pp.fused_patch_embed.launches
                got = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, dtype, use_kernel=True)
                torch.cuda.synchronize()
                check(pp.fused_patch_embed.launches == before + 1, f"{name}: patch-embed launch not counted")
                check(got.dtype == dtype and got.shape == want.shape, f"{name}: patch-embed output dtype/shape")
                dt = str(dtype).split(".")[-1]
                err = (got.float() - want).abs().max().item()
                patch_errors[(name, dt)] = err
                line = f"  {name:12s} [N,H,W,P,D]={list(shape)} {dt:8s} max_abs {err:.3e} (max|out| {top:.3f})"
                check(math.isfinite(err), f"{name} {dt}: patch embed not finite")
                if dtype == torch.float32:
                    line += f", {err / top:.2e} of max|out| (tol {PATCH_FP32_REL:.0e})"
                    check(err <= PATCH_FP32_REL * top, f"{name} fp32 patch embed: {err} > {PATCH_FP32_REL} max|out|")
                else:
                    ulps = bf16_grad_ulps(got, want)
                    line += f", {ulps:.3f} ulp of the fp32 plain GEMM (tol {BF16_MAX_ULP:.0f})"
                    check(ulps <= BF16_MAX_ULP, f"{name} bf16 patch embed: {ulps} ulp")
                print(line)
            del frames, kernel, want, got

    with phase("3f frozen-BN kernels vs plain at layer1's bn3, and the stage-1 model's FrozenBatchNorms"):
        frozen_bn_check_phase(card)

    with phase("3g AdamW multi-tensor kernel vs the _foreach path at the three train cells' optimizers"):
        adamw_worst_ulps = adamw_check_phase(card)

    with phase("4 B/32 retrieval eval (main path)"), tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            report = run_retrieval_clipvip.main([
                "--dummy_data", "1", "--mode", "eval", "--clip_size", "base_32",
                "--device_ingest", "1", "--num_frm", "12", "--crop_img_size", "224",
                "--val_batch_size", str(EVAL_BATCH), "--device", "cuda",
                "--output_dir", out_dir, "--save_feats", f"{out_dir}/feats.npz",
            ])
            torch.cuda.synchronize()
            eval_launches = launch_counts()
        n_batches = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / EVAL_BATCH)
        print(f"  launches {eval_launches} (expected {VIDEO_LAYERS} layers x {n_batches} batches forward, "
              f"none backward); plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(eval_launches == expected(proxy_attention_fwd=VIDEO_LAYERS * n_batches), "eval kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        for direction in ("t2v", "v2t"):
            row = {k: report[direction][k] for k in ("R1", "R5", "R10", "MedR")}
            print(f"  {direction} {row}")
            check(all(math.isfinite(x) for x in row.values()), f"{direction} R@K not finite")
        feats = np.load(f"{out_dir}/feats.npz")
        for key in ("vis_features", "text_features"):
            f = feats[key]
            norms = np.linalg.norm(f, axis=-1)
            print(f"  {key} {f.shape} finite={np.isfinite(f).all()} "
                  f"L2 norm in [{norms.min():.4f}, {norms.max():.4f}]")
            check(f.shape == (run_retrieval_clipvip.DUMMY_VAL_SIZE, 512), f"{key} shape")
            check(bool(np.isfinite(f).all()) and np.abs(norms - 1).max() < 1e-2, f"{key} not unit rows")
        print(f"  eval wall {report['perf']['wall_s']:.2f} s, {report['perf']['clips_per_s']:.1f} clips/s "
              f"(host clock, synthetic decode + upload included) [{card}]")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    with phase("4b B/32 fine-tune (main path)"), tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(REPO, PRESET)) as f:
            preset = json.load(f)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            report = run_retrieval_clipvip.main(finetune_argv(out_dir))
            torch.cuda.synchronize()
            train_launches = launch_counts()
        wall = time.perf_counter() - t0
        # validation at start, at every TRAIN_EVERY steps, and the final report's
        n_val = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / preset["val_batch_size"])
        validations = 1 + TRAIN_STEPS // TRAIN_EVERY + 1
        want = expected(proxy_attention_fwd=VIDEO_LAYERS * (TRAIN_STEPS + validations * n_val),
                        proxy_attention_bwd=VIDEO_LAYERS * TRAIN_STEPS)
        print(f"  launches {train_launches} (expected {want}: {VIDEO_LAYERS} layers x ({TRAIN_STEPS} steps "
              f"+ {validations} validations x {n_val} batches) forward, x {TRAIN_STEPS} steps backward); "
              f"plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(train_launches == want, "fine-tune kernel launch counts")
        check(ADAMW_SEEN["updates"] == TRAIN_STEPS and train_launches["adamw_multi_tensor"] > 0,
              f"fine-tune AdamW updates on the card {ADAMW_SEEN} for {TRAIN_STEPS} steps")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
        norms = [r["value"] for r in rows if r["tag"] == "train/grad_norm"]
        print(f"  batch {preset['train_batch_size']}, losses {[round(x, 4) for x in losses]}, "
              f"grad norms {[round(x, 4) for x in norms]}")
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses + norms),
              "fine-tune losses not finite")
        for direction in ("t2v", "v2t"):
            row = {k: report[direction][k] for k in ("R1", "R5", "R10", "MedR")}
            print(f"  final {direction} {row}")
            check(all(math.isfinite(x) for x in row.values()), f"{direction} R@K not finite")
        ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
        check(ckpts == [f"{TRAIN_EVERY}.pt", f"{TRAIN_STEPS}.pt"], f"checkpoints {ckpts}")
        print(f"  checkpoints {ckpts}; run wall {wall:.1f} s (host clock, synthetic data and "
              f"{validations} validations included) [{card}]")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        finetune_reference = finished_run(out_dir, report, train_launches)  # phase 8a's run without a group

    with open(os.path.join(REPO, LFVILA_PRESET)) as f:
        lfvila_preset = json.load(f)

    with phase("4c LF-VILA retrieval, window kernel on (main path)"), tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        dummy_size, run_tasks_lfvila.DUMMY_SIZE = run_tasks_lfvila.DUMMY_SIZE, TASK_EVAL_SAMPLES
        try:
            with plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_tasks_lfvila.main([
                    "--config", os.path.join(REPO, LFVILA_PRESET), "--task", "retrieval", "--dummy_data", "1",
                    "--num_train_steps", "0", "--val_batch_size", str(LFVILA_BATCH), "--device", "cuda",
                    "--output_dir", out_dir,
                ])
                torch.cuda.synchronize()
                lfvila_launches = launch_counts()
        finally:
            run_tasks_lfvila.DUMMY_SIZE = dummy_size
        wall = time.perf_counter() - t0
        n_batches = math.ceil(TASK_EVAL_SAMPLES / LFVILA_BATCH)
        want = expected(window_attention_fwd=WINDOW_BLOCKS * n_batches)
        print(f"  launches {lfvila_launches} (expected {WINDOW_BLOCKS} window blocks x {n_batches} batches); "
              f"plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(lfvila_launches == want, "LF-VILA retrieval kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        with open(os.path.join(out_dir, "final_report.json")) as f:
            check(json.load(f)["t2v"] == report["t2v"], "final_report.json")
        for direction in ("t2v", "v2t"):
            row = {k: report[direction][k] for k in ("R1", "R5", "R10", "MedR")}
            print(f"  {direction} {row}")
            check(all(math.isfinite(x) for x in row.values()), f"{direction} R@K not finite")
        print(f"  eval {report['perf']['wall_s']:.2f} s, {report['perf']['clips_per_s']:.2f} clips/s; run wall "
              f"{wall:.1f} s (host clock; model build, synthetic data and upload included) [{card}]")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    with phase("4d ops: the packed proxy attention and the fused patch embed (main path)"):
        s, st = B32, B32_TRAIN
        D, scale = s["D"], s["D"] ** -0.5
        serve = [packed(t) for t in qkv(s, torch.bfloat16, seed=4)]
        train = [packed(t) for t in qkv(st, torch.bfloat16, seed=5, n=4)]
        leaves = [t.clone().requires_grad_() for t in train[:3]]
        g = torch.Generator(device="cuda").manual_seed(6)
        # the 24 x 12 frames of a B/32 serving batch, and a patch kernel of the model's shape
        frames = torch.randint(0, 256, (EVAL_BATCH * 12, 224, 224, 3), device="cuda", generator=g,
                               dtype=torch.uint8)
        kernel = torch.randn(32, 32, 3, 768, device="cuda", generator=g) * 0.02
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            out = pa.proxy_attention_packed(*serve, s["M"], s["N"], s["L"], scale, D)
            pa.proxy_attention_packed(*leaves, st["M"], st["N"], st["L"], scale, D).backward(train[3])
            emb = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16, use_kernel=True)
            torch.cuda.synchronize()
            ops_launches = launch_counts()
        want = expected(proxy_attention_packed_fwd=2, proxy_attention_packed_bwd=1, patch_embed_u8=1)
        print(f"  launches {ops_launches} (expected {want}); plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(ops_launches == want, "ops path kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        # what came out, against the plain versions of the same inputs in fp32
        ulps = bf16_ulps(out, pa.proxy_attention_packed_plain(*(t.float() for t in serve), s["M"], s["L"], scale, D))
        grads = pa.proxy_attention_packed_bwd_plain(*(t.float() for t in train), st["M"], st["L"], scale, D)
        grad_ulps = max(bf16_grad_ulps(t.grad, w) for t, w in zip(leaves, grads))
        emb_ulps = bf16_grad_ulps(emb, pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD))
        print(f"  packed forward {tuple(out.shape)} {ulps:.3f} ulp, gradients {grad_ulps:.3f} ulp, "
              f"patch embeddings {tuple(emb.shape)} {emb_ulps:.3f} ulp of the fp32 plain versions")
        check(out.shape == serve[0].shape and all(t.grad.shape == train[0].shape for t in leaves)
              and emb.shape == (EVAL_BATCH * 12, 49, 768), "ops path output shapes")
        check(ulps <= BF16_MAX_ULP and grad_ulps <= BWD_MAX_ULP and emb_ulps <= BF16_MAX_ULP,
              "ops path outputs against their plain versions")
        del serve, train, leaves, frames, kernel, out, emb, grads

    with phase("4e LF-VILA stage-1 pretraining (main path)"):
        stage1_launches, _ = lfvila_stage1_phase(card)

    with phase("4f LF-VILA stage-2 pretraining, frozen stage-1 modules (main path)"):
        stage2_launches, _ = lfvila_stage2_phase(card)

    with phase("4g LF-VILA fine-tunes: QA and video classification (main path)"):
        task_launches = lfvila_finetune_phase(card)

    with phase("4h CLIP-ViP B/32 pretraining from a CLIP-ViP checkpoint, image/caption branch (main path)"):
        pretrain_launches, _ = clipvip_pretrain_phase(card)

    with phase("4i LF-VILA stage-1 pretraining from 2-D Swin and BERT checkpoints (main path)"):
        cascade_launches = lfvila_cascade_phase(card)

    hdvila_ckpt = os.path.join(tempfile.mkdtemp(prefix="hdvila_"), "stage1_e2e.pt")
    with phase("4j HD-VILA stage-1 pretraining (main path)"):
        hdvila_stage1_launches, _ = hdvila_stage1_phase(card, hdvila_ckpt)

    with phase("4k HD-VILA stage-2 pretraining from 4j's checkpoint, frozen stage-1 modules (main path)"):
        hdvila_stage2_launches, _ = hdvila_stage2_phase(card, hdvila_ckpt)
        os.remove(hdvila_ckpt)

    with phase("4l HD-VILA retrieval: ITC fine-tune and R@K, then the rerank head (main path)"):
        hdvila_retrieval_launches = hdvila_retrieval_phase(card)

    with phase("4m HD-VILA video QA: multiple choice and FrameQA, then inference (main path)"):
        hdvila_qa_launches = hdvila_qa_phase(card)

    with phase("4n B/32 fine-tune at --steps_per_call 4, --param_dtype bf16, --async_checkpoint 1 (main path)"):
        graphed_launches = graphed_finetune_phase(card)

    with phase("4o LF-VILA stage-1 pretraining at --steps_per_call 2 against eager (main path)"):
        lfvila_graphed_launches = graphed_lfvila_phase(card)

    with phase("4p B/32 serving in the factorized proxy mode (main path)"):
        factorized_launches = factorized_phase(card)

    with phase("4q PrefetchLoader onto the card"):
        prefetch_phase(card)

    with phase("4s CLIP-ViP and LF-VILA training at attention dropout 0.1: JAX's dense branch, the kernels in "
               "validation (main path)"):
        dropout_launches = attention_dropout_phase(card)

    with phase("5 serve: card vs CPU, fp32"):
        model_cpu = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.float32))
        model_cpu.init_weights(torch.Generator().manual_seed(0))
        gpu = RetrievalTowers(copy.deepcopy(model_cpu), "cuda")
        cpu = RetrievalTowers(model_cpu, "cpu")
        rng = np.random.default_rng(0)
        video = rng.integers(0, 256, size=(2, 12, 224, 224, 3), dtype=np.uint8)
        ids, mask = captions(rng, 2)
        before = pa.proxy_attention.launches
        feats = {
            "video": (gpu.encode_video(video), cpu.encode_video(video)),
            "text": (gpu.encode_text(ids, mask), cpu.encode_text(ids, mask)),
        }
        torch.cuda.synchronize()
        check(pa.proxy_attention.launches == before + VIDEO_LAYERS, "serving did not use the kernel")
        for name, (on_card, on_cpu) in feats.items():
            a, b = on_card.cpu(), on_cpu
            err = (a - b).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
            print(f"  {name} {tuple(a.shape)} card vs cpu max_abs {err:.3e} (tol 1e-4) min_cos {cos:.7f}")
            check(err <= 1e-4, f"{name}: card vs cpu {err}")
        sims = gpu.similarity(feats["text"][0], feats["video"][0], scaled=True)
        print(f"  scaled text->video scores {sims.cpu().numpy().round(3).tolist()}")
        check(bool(torch.isfinite(sims).all()), "similarity not finite")
        del gpu, cpu, model_cpu

    with phase("5b pretraining step with the image branch: card vs CPU, fp32"):
        lr = 1e-5
        model_cpu = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.float32))
        model_cpu.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():  # a temporal embedding that is not zero, so both branches' lerps count
            model_cpu.vision_model.embeddings.temporal_embedding.normal_(0.0, 0.02, generator=torch.Generator()
                                                                          .manual_seed(1))
        model_gpu = copy.deepcopy(model_cpu).cuda()
        rng = np.random.default_rng(2)
        ids, mask = captions(rng, 2)
        cap_ids, cap_mask = captions(rng, 2)
        frames = rng.integers(0, 256, size=(2, 13, 224, 224, 3), dtype=np.uint8)
        # as PretrainCollator ships them: fp32 normalized video and one image a clip, one caption a clip
        batch = {"video": np.stack([normalize(f[:12]) for f in frames]), "text_input_ids": ids,
                 "text_input_mask": mask, "image": np.stack([normalize(f[12:]) for f in frames]),
                 "caption_ids": cap_ids[:, None], "caption_masks": cap_mask[:, None]}
        metrics = {}
        for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            step, state = train_step_parts(model, lr, "NCELearnableTempLoss_vsc_fc")
            before = (pa.proxy_attention.launches, pa.proxy_attention_bwd.launches)
            _, m = step(state, batch_to_device(device)(batch), 0)
            metrics[device] = {k: v.item() for k, v in m.items()}
            if device == "cuda":
                launched = (pa.proxy_attention.launches - before[0], pa.proxy_attention_bwd.launches - before[1])
                check(launched == (PROXY_LAYERS_PER_STEP,) * 2, f"card train step launches {launched}")
        print(f"  card {metrics['cuda']}\n  cpu  {metrics['cpu']}")
        loss_err = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"])
        norm_err = abs(metrics["cuda"]["grad_norm"] / metrics["cpu"]["grad_norm"] - 1)
        # fp32 sums in other orders through 24 layers: 1e-4 on the loss,
        # 1e-3 relative on the gradients' global norm
        check(loss_err <= 1e-4, f"train loss card vs cpu {loss_err}")
        check(norm_err <= 1e-3, f"grad_norm card vs cpu rel {norm_err}")
        cpu_state = model_cpu.state_dict()
        diffs = torch.cat([(v.cpu() - cpu_state[k]).abs().flatten() for k, v in model_gpu.state_dict().items()])
        # AdamW's first step is lr * g / (|g| + eps) (+ decay): where |g| is
        # near eps the last digits of g move it, by up to 2 lr
        print(f"  loss diff {loss_err:.3e} (tol 1e-4), grad_norm rel diff {norm_err:.3e} (tol 1e-3); "
              f"params after the step: max diff {diffs.max().item():.3e} (tol 2 lr = {2 * lr:.0e}), "
              f"{(diffs > 1e-7).double().mean().item():.2e} of them above 1e-7")
        check(diffs.max().item() <= 2 * lr, "params after one step differ by more than 2 lr")
        del model_cpu, model_gpu

    with phase("5c LF-VILA towers: card vs CPU, fp32"):
        model_cpu = LfVilaRetrieval(run_tasks_lfvila.lfvila_config_from({**lfvila_preset, "bf16": 0}))
        model_cpu.init_weights(torch.Generator().manual_seed(0))
        gpu = LfVilaTowers(copy.deepcopy(model_cpu), "cuda")
        cpu = LfVilaTowers(model_cpu, "cpu")
        rng = np.random.default_rng(3)
        frames = rng.normal(size=(1, 3, 32, 192, 320)).astype(np.float32)
        ids = rng.integers(1, 30522, size=(1, 4, 70))
        mask = (np.arange(70)[None, None] < rng.integers(5, 70, size=(1, 4, 1))).astype(np.int64)
        before = wa.window_attention.launches
        feats = {
            "video": (gpu.encode_video(frames), cpu.encode_video(frames)),
            "text": (gpu.encode_text(ids, mask), cpu.encode_text(ids, mask)),
        }
        torch.cuda.synchronize()
        check(wa.window_attention.launches == before + WINDOW_BLOCKS, "the video tower did not use the kernel")
        for name, (on_card, on_cpu) in feats.items():
            a, b = on_card.cpu(), on_cpu
            err = (a - b).abs().max().item()
            print(f"  {name} {tuple(a.shape)} card vs cpu max_abs {err:.3e} (tol 1e-4)")
            check(math.isfinite(err) and err <= 1e-4, f"{name}: card vs cpu {err}")
        sims = gpu.similarity(feats["text"][0], feats["video"][0], scaled=True)
        print(f"  scaled text->video score {sims.cpu().numpy().round(3).tolist()}")
        check(bool(torch.isfinite(sims).all()), "similarity not finite")
        del gpu, cpu, model_cpu

    with phase("5d LF-VILA pretraining step: card vs CPU, fp32"):
        lfvila_card_vs_cpu_phase()

    with phase("5e HD-VILA pretraining steps at full width: card vs CPU, fp32"):
        hdvila_card_vs_cpu_phase()

    with phase("5f the graphed train step against the eager one, plain and with accumulation"):
        graph_equals_eager_phase(card)

    with phase("6 timing"):
        s = B32
        args = (s["M"], s["N"], s["L"], s["D"] ** -0.5)
        timings = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(s, dtype)
            runs = alternate({
                "kernel": lambda: pa.proxy_attention(q, k, v, *args),
                "plain": lambda: pa.proxy_attention_plain(q, k, v, s["M"], s["L"], args[-1]),
            })
            dt = str(dtype).split(".")[-1]
            timings[dt] = {name: sum(r) / len(r) for name, r in runs.items()}
            timings[dt]["device"] = device_ms(lambda: pa.proxy_attention(q, k, v, *args), iters=200)
            print(f"  proxy attention B/32 b=24 {dt}: kernel {runs['kernel']} ms, "
                  f"plain {runs['plain']} ms (CUDA events, 200 calls each); kernel device time "
                  f"{timings[dt]['device']:.4f} ms (torch.profiler, 200 calls) [{card}]")
            del q, k, v

        model = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.bfloat16), device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
        batch = synthetic_batch(EVAL_BATCH, "cuda", seed=1)
        video, ids, mask = batch["video"], batch["text_input_ids"], batch["text_input_mask"]
        # Windows of about 2 s each, so host-launch noise shows as spread.
        with torch.inference_mode():
            fwd = window_ms(lambda: model(video, ids, mask), iters=100)
            vid = window_ms(lambda: model.forward_video(video), iters=100)
            txt = window_ms(lambda: model.forward_text(ids, mask), iters=300)
        print(f"  B/32 bf16 video+text forward b={EVAL_BATCH}: {spread(fwd)} = "
              f"{EVAL_BATCH / median(fwd) * 1e3:.1f} clips/s at the median; windows {fwd} "
              f"(CUDA events, 100 calls per window, inputs on the card) [{card}]")
        print(f"  B/32 bf16 video tower b={EVAL_BATCH}: {spread(vid)}; windows {vid} [{card}]")
        print(f"  B/32 bf16 text tower b={EVAL_BATCH}: {spread(txt)}; windows {txt} "
              f"(300 calls per window) [{card}]")

    with phase("6b timing: backward kernel and train step"):
        s = B32_TRAIN
        args = (s["M"], s["N"], s["L"], s["D"] ** -0.5)
        bwd_timings = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, d_out = qkv(s, dtype, n=4)
            dt = str(dtype).split(".")[-1]
            # like for like: the backward kernel against its plain version;
            # "kernel" is what autograd runs (on the forward's LSE), "alone"
            # the public entry, which computes the LSE first
            _, lse = pa._launch_fwd(q, k, v, *args, with_lse=True)
            runs = alternate({
                "kernel": lambda: pa._launch_bwd(q, k, v, d_out, *args, lse=lse),
                "plain": lambda: pa.proxy_attention_bwd_plain(q, k, v, d_out, s["M"], s["L"], args[-1]),
                "alone": lambda: pa.proxy_attention_bwd(q, k, v, d_out, *args),
            })
            bwd_timings[dt] = {name: sum(r) / len(r) for name, r in runs.items()}
            bwd_timings[dt]["device"] = device_ms(lambda: pa._launch_bwd(q, k, v, d_out, *args, lse=lse), iters=200)
            print(f"  proxy attention backward B/32 b=32 {dt}: kernel on the forward's LSE {runs['kernel']} ms, "
                  f"alone {runs['alone']} ms, plain (proxy_attention_bwd_plain) {runs['plain']} ms (CUDA events, "
                  f"200 calls each); kernel on the forward's LSE, device time {bwd_timings[dt]['device']:.4f} ms "
                  f"(torch.profiler, 200 calls) [{card}]")

            # what a layer pays in training: forward and backward through
            # autograd, the two kernels against the plain forward
            def through(forward):
                def run():
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    forward(*leaves).backward(d_out)
                return run

            fns = {
                "kernel": through(lambda *t: pa.proxy_attention(*t, *args)),
                "plain": through(lambda *t: pa.proxy_attention_plain(*t, s["M"], s["L"], args[-1])),
            }
            if dtype == torch.bfloat16:  # the library's forward + backward, on the tensor cores too
                mask = pa.proxy_bias(q.shape[2], s["M"], s["L"], "cuda").to(dtype)
                fns["sdpa"] = through(lambda *t: torch.nn.functional.scaled_dot_product_attention(
                    *t, attn_mask=mask, scale=args[-1]))
            both = alternate(fns)
            print(f"  proxy attention forward+backward (autograd) B/32 b=32 {dt}: kernels {both['kernel']} ms, "
                  f"plain forward + autograd {both['plain']} ms"
                  + (f", SDPA forward + autograd {both['sdpa']} ms" if "sdpa" in both else "")
                  + f" (CUDA events, 200 calls each) [{card}]")
            del q, k, v, d_out, lse

        b = B32_TRAIN["B"]
        _, steps_ms, iters, peak_gib = time_train_step(b)
        print(f"  B/32 bf16 train step b={b}: {spread(steps_ms)} = {b / median(steps_ms) * 1e3:.1f} clips/s at "
              f"the median; windows {steps_ms} (CUDA events, {iters} steps per window, inputs on the card) "
              f"[{card}]")
        print(f"  train step peak device memory {peak_gib:.2f} GiB [{card}]")
        check(all(math.isfinite(x) for x in steps_ms), "train step timing")

    with phase("6c timing: window kernel and LF-VILA towers"):
        win_timings = {}
        for name in WINDOW_TIMED:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, bias, mask = window_inputs(WINDOW_SHAPES[name], dtype)
                runs = alternate({
                    "kernel": lambda: wa.window_attention(q, k, v, bias, mask),
                    "plain": lambda: wa.window_attention_plain(q, k, v, bias, mask),
                })
                dt = str(dtype).split(".")[-1]
                win_timings[(name, dt)] = {n: sum(r) / len(r) for n, r in runs.items()}
                win_timings[(name, dt)]["device"] = device_ms(lambda: wa.window_attention(q, k, v, bias, mask),
                                                              iters=200)
                print(f"  window attention {name} {list(WINDOW_SHAPES[name][:4])} {dt}: kernel {runs['kernel']} ms, "
                      f"plain {runs['plain']} ms (CUDA events, 200 calls each); kernel device time "
                      f"{win_timings[(name, dt)]['device']:.4f} ms (torch.profiler, 200 calls) [{card}]")
                del q, k, v, bias, mask

        model = LfVilaRetrieval(run_tasks_lfvila.lfvila_config_from(lfvila_preset), device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
        g = torch.Generator(device="cuda").manual_seed(1)
        b = LFVILA_BATCH
        frames = torch.randn(b, 3, 32, 192, 320, device="cuda", generator=g)
        ids = torch.randint(1, 30522, (b, 4, 70), device="cuda", generator=g)
        mask = (torch.arange(70, device="cuda")[None, None] < torch.randint(5, 70, (b, 4, 1), device="cuda",
                                                                             generator=g)).long()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            before = wa.window_attention.launches
            vid = window_ms(lambda: model.forward_video(frames), iters=10)
            txt = window_ms(lambda: model.forward_text(ids, mask), iters=50)
            # window_ms: 3 warm-up calls, then 5 windows of 10
            check(wa.window_attention.launches - before == WINDOW_BLOCKS * (3 + 5 * 10), "video tower launches")
            vid_device = device_ms(lambda: model.forward_video(frames), iters=5)
        print(f"  LF-VILA bf16 video tower b={b} (32x192x320 fp32 frames on the card): {spread(vid)} = "
              f"{b / median(vid) * 1e3:.2f} clips/s at the median; windows {vid} (CUDA events, 10 calls "
              f"per window); device time {vid_device:.4f} ms a call (torch.profiler, 5 calls) [{card}]")
        print(f"  LF-VILA bf16 text tower b={b} (4 x 70 tokens): {spread(txt)}; windows {txt} (50 calls per "
              f"window) [{card}]")
        print(f"  towers peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        check(all(math.isfinite(x) for x in vid + txt), "tower timing")
        del model, frames

    with phase("6d timing: packed and patch-embed kernels, and one library call for each kernel"):
        import torch.nn.functional as F

        lib = {}  # kernel name -> ms of one PyTorch call computing the same function
        sdpa_checks = []

        def sdpa(q, k, v, mask, scale):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        def sdpa_fwd_bwd(tensors, d_out, view, mask, scale):
            def run():
                leaves = [t.detach().requires_grad_() for t in tensors]
                sdpa(*(view(t) for t in leaves), mask, scale).backward(view(d_out))
            return run

        # #1 and #3: B/32 serving, b=24, bf16; the proxy mask built outside the window
        s = B32
        D, scale, S = s["D"], s["D"] ** -0.5, s["M"] + s["N"] * s["L"]
        mask = pa.proxy_bias(S, s["M"], s["L"], "cuda").to(torch.bfloat16)
        q, k, v = qkv(s, torch.bfloat16)
        pq, pk, pv = (packed(t) for t in (q, k, v))
        hq, hk, hv = (head_view(t, D) for t in (pq, pk, pv))
        runs = alternate({
            "kernel": lambda: pa.proxy_attention_packed(pq, pk, pv, s["M"], s["N"], s["L"], scale, D),
            "plain": lambda: pa.proxy_attention_packed_plain(pq, pk, pv, s["M"], s["L"], scale, D),
            "library": lambda: sdpa(hq, hk, hv, mask, scale),
            "library_bhsd": lambda: sdpa(q, k, v, mask, scale),
        })
        packed_fwd_timing = {k_: mean(r) for k_, r in runs.items()}
        packed_fwd_timing["device"] = device_ms(
            lambda: pa.proxy_attention_packed(pq, pk, pv, s["M"], s["N"], s["L"], scale, D), iters=200)
        lib["proxy_attention_packed_fwd"] = packed_fwd_timing["library"]
        lib["proxy_attention_fwd"] = packed_fwd_timing["library_bhsd"]
        sdpa_checks.append(("proxy fwd", sdpa(q, k, v, mask, scale), pa.proxy_attention(q, k, v, s["M"], s["N"],
                                                                                        s["L"], scale)))
        print(f"  packed proxy attention B/32 b=24 bf16: kernel {runs['kernel']} ms, plain {runs['plain']} ms, "
              f"SDPA on the head views {runs['library']} ms; [B,H,S,D] SDPA {runs['library_bhsd']} ms "
              f"(CUDA events, 200 calls each); kernel device time {packed_fwd_timing['device']:.4f} ms "
              f"(torch.profiler, 200 calls) [{card}]")
        del q, k, v, pq, pk, pv, hq, hk, hv

        # #2 and #4: B/32 train, b=32, bf16; the library's backward is its
        # forward + backward through autograd minus its forward alone
        s = B32_TRAIN
        q, k, v, d_out = qkv(s, torch.bfloat16, seed=1, n=4)
        pq, pk, pv, pd = (packed(t) for t in (q, k, v, d_out))
        hv_ = lambda t: head_view(t, D)  # noqa: E731
        same = lambda t: t  # noqa: E731
        # "kernel" as autograd runs it, on the forward's LSE; "alone" the public entry
        _, plse = pa._launch_fwd(pq, pk, pv, s["M"], s["N"], s["L"], scale, D, with_lse=True)
        runs = alternate({
            "kernel": lambda: pa._launch_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D, lse=plse),
            "plain": lambda: pa.proxy_attention_packed_bwd_plain(pq, pk, pv, pd, s["M"], s["L"], scale, D),
            "alone": lambda: pa.proxy_attention_packed_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D),
            "library_fwd_bwd": sdpa_fwd_bwd((pq, pk, pv), pd, hv_, mask, scale),
            "library_fwd": lambda: sdpa(hv_(pq), hv_(pk), hv_(pv), mask, scale),
            "bhsd_fwd_bwd": sdpa_fwd_bwd((q, k, v), d_out, same, mask, scale),
            "bhsd_fwd": lambda: sdpa(q, k, v, mask, scale),
        })
        packed_bwd_timing = {k_: mean(r) for k_, r in runs.items()}
        packed_bwd_timing["device"] = device_ms(
            lambda: pa._launch_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D, lse=plse), iters=200)
        lib["proxy_attention_packed_bwd"] = packed_bwd_timing["library_fwd_bwd"] - packed_bwd_timing["library_fwd"]
        lib["proxy_attention_bwd"] = packed_bwd_timing["bhsd_fwd_bwd"] - packed_bwd_timing["bhsd_fwd"]
        print(f"  packed proxy attention backward B/32 b=32 bf16: kernel on the forward's LSE {runs['kernel']} ms, "
              f"alone {runs['alone']} ms, plain {runs['plain']} ms, SDPA forward+backward on the head views "
              f"{runs['library_fwd_bwd']} ms, its "
              f"forward {runs['library_fwd']} ms; [B,H,S,D] SDPA forward+backward {runs['bhsd_fwd_bwd']} ms, "
              f"forward {runs['bhsd_fwd']} ms (CUDA events, 200 calls each); kernel on the forward's LSE, device "
              f"time {packed_bwd_timing['device']:.4f} ms (torch.profiler, 200 calls) [{card}]")
        del q, k, v, d_out, pq, pk, pv, pd, plse

        # #5: the B/32 serving frames, bf16 out; the library call is one bf16
        # addmm of patches gathered (and cast) outside the window with the
        # bf16-rounded weight: the model's own patch_embed_u8 GEMM, rounded as
        # SDPA is for the proxy rows. The fp32 addmm (TF32 off) and the gather
        # are timed apart.
        N_, H_, W_, P_, D_ = PATCH_SHAPES["b32"]
        frames, kernel = patch_inputs(PATCH_SHAPES["b32"])
        folded_w, bias = pp.fold_normalization(kernel, CLIP_MEAN, CLIP_STD)
        gather = lambda: pp.extract_patches_u8(frames, P_).reshape(-1, 3 * P_ * P_).float()  # noqa: E731
        patches = gather()
        patches_bf16, folded_bf16, bias_bf16 = patches.bfloat16(), folded_w.bfloat16(), bias.bfloat16()
        runs = alternate({
            "kernel": lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16,
                                                   use_kernel=True),
            "plain": lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16),
            "library": lambda: torch.addmm(bias_bf16, patches_bf16, folded_bf16),
            "library_fp32": lambda: torch.addmm(bias, patches, folded_w),
            "gather": gather,
            "kernel_fp32": lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, use_kernel=True),
        }, iters=50)
        patch_timing = {k_: mean(r) for k_, r in runs.items()}
        patch_timing["device"] = device_ms(lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD,
                                                                        torch.bfloat16, use_kernel=True), iters=50)
        launch_device = device_ms(lambda: pp._launch(frames, folded_w, bias, P_, torch.bfloat16), iters=50)
        lib["patch_embed_u8"] = patch_timing["library"]
        sdpa_checks.append(("patch embed", torch.addmm(bias_bf16, patches_bf16, folded_bf16),
                            pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, use_kernel=True).flatten(0, 1)))
        print(f"  patch embed [N,H,W,P,D]={list(PATCH_SHAPES['b32'])} bf16 out: kernel {runs['kernel']} ms "
              f"(fp32 out {runs['kernel_fp32']} ms), plain {runs['plain']} ms, bf16 addmm of gathered patches "
              f"{runs['library']} ms, the gather {runs['gather']} ms (CUDA events, 50 calls each); device time "
              f"{patch_timing['device']:.4f} ms, of which the kernel's launch (weight split and GEMM) "
              f"{launch_device:.4f} ms and the rest the weight fold (torch.profiler, 50 calls) [{card}]")
        del frames, kernel, folded_w, bias, patches, patches_bf16, folded_bf16, bias_bf16

        # #6: stage 3's shifted block at b=8, bf16; bias + mask as one
        # [nW, H, N, N] mask, broadcast over the batch of windows
        shape = WINDOW_SHAPES["s3_shifted"]
        q, k, v, bias, wmask = window_inputs(shape, torch.bfloat16)
        Bn, Hw, Nw, dw = shape[:4]
        nW = wmask.shape[0]
        joint = (bias[None] + wmask[:, None]).to(torch.bfloat16)
        wview = lambda t: t.view(Bn // nW, nW, Hw, Nw, dw)  # noqa: E731
        runs = alternate({
            "kernel": lambda: wa.window_attention(q, k, v, bias, wmask),
            "plain": lambda: wa.window_attention_plain(q, k, v, bias, wmask),
            "library": lambda: sdpa(wview(q), wview(k), wview(v), joint, dw ** -0.5),
        })
        lib["window_attention_fwd"] = mean(runs["library"])
        sdpa_checks.append(("window", sdpa(wview(q), wview(k), wview(v), joint, dw ** -0.5).reshape(q.shape),
                            wa.window_attention(q, k, v, bias, wmask)))
        print(f"  window attention s3_shifted {list(shape[:4])} bf16: kernel {runs['kernel']} ms, plain "
              f"{runs['plain']} ms, SDPA with the joint mask {runs['library']} ms (CUDA events, 200 calls each) "
              f"[{card}]")
        del q, k, v, bias, wmask, joint

        # #6 at stages 3 and 5 and the grouped stages 0-1 (N=120, below the
        # model's gate pallas_min_window 240), against the plain version and
        # the model's off-gate path: WindowAttention3D._attend's
        # common.dot_attention with bias + mask as one [nW, h, N, N] mask
        def off_gate(q, k, v, bias, wmask):
            nW = 1 if wmask is None else wmask.shape[0]
            add = bias[None] if wmask is None else bias[None] + wmask[:, None]
            split = lambda t: t.unflatten(0, (-1, nW))  # noqa: E731
            return dot_attention(split(q), split(k), split(v), q.shape[-1] ** -0.5, add).flatten(0, 1)

        for name in ("s3", "s5", "s0_grouped", "s1_grouped"):
            q, k, v, bias, wmask = window_inputs(WINDOW_SHAPES[name], torch.bfloat16)
            runs = alternate({
                "kernel": lambda: wa.window_attention(q, k, v, bias, wmask),
                "plain": lambda: wa.window_attention_plain(q, k, v, bias, wmask),
                "dot_attention": lambda: off_gate(q, k, v, bias, wmask),
            })
            sdpa_checks.append((f"window {name} off the gate", off_gate(q, k, v, bias, wmask),
                                wa.window_attention(q, k, v, bias, wmask)))
            print(f"  window attention {name} {list(WINDOW_SHAPES[name][:4])} bf16: kernel {runs['kernel']} ms, plain "
                  f"{runs['plain']} ms, the model's off-gate path (dot_attention, bias + mask as one mask) "
                  f"{runs['dot_attention']} ms (CUDA events, 200 calls each) [{card}]")
            del q, k, v, bias, wmask
        # the yardsticks compute the kernels' functions (bf16 rounding apart)
        for name, a, b in sdpa_checks:
            err = (a.float() - b.float()).abs().max().item()
            print(f"  library call vs kernel, {name}: max_abs {err:.3e}")
            check(math.isfinite(err) and err <= 5e-2 * max(1.0, b.float().abs().max().item()),
                  f"library call for {name} computes another function: {err}")

        # the least time the card could take for each kernel's work on this run's inputs
        bounds = {}
        for name, s, backward in (("proxy_attention_fwd", B32, False), ("proxy_attention_bwd", B32_TRAIN, True)):
            flops, nbytes, _ = pa.proxy_attention_cost(s["B"], s["H"], s["M"] + s["N"] * s["L"], s["D"], s["M"],
                                                       s["L"], 2, backward)
            bounds[name] = bounds[name.replace("attention_", "attention_packed_")] = bound_ms(flops, nbytes)
        rows, K = N_ * (H_ // P_) * (W_ // P_), 3 * P_ * P_
        bounds["patch_embed_u8"] = bound_ms(2 * rows * K * D_, N_ * H_ * W_ * 3 + (K + 1) * D_ * 4 + rows * D_ * 2)
        bounds["window_attention_fwd"] = bound_ms(4 * Bn * Hw * Nw * Nw * dw,
                                                  4 * Bn * Hw * Nw * dw * 2 + (Hw + nW) * Nw * Nw * 4)
        for name, (t, by) in bounds.items():
            print(f"  bound {name}: {t:.4f} ms ({by}; {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                  f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16)")

    with phase("6e timing: HD-VILA stage-1 train step and video tower at batch 8"):
        hdvila_timing_phase(card)

    with phase("6h timing: frozen-BN kernels at layer1's bn3 against the plain version"):
        frozen_bn_timing = frozen_bn_timing_phase(card)

    with phase("6i timing: the AdamW kernel at the three train cells' leaf lists against the _foreach chain"):
        adamw_timing = adamw_timing_phase(card)

    with phase("6f timing: eager and graphed train steps, fp32 and bf16 storage"):
        graph_timing_phase(card)

    with phase("6g timing: the graphed B/32 train step at attention dropout 0.1 beside 0"):
        dropout_timing_phase(card)

    with tempfile.TemporaryDirectory(prefix="artifacts_") as folder:
        with phase("7a B/32 serving artifact with kernel attention, through the export CLI (main path)"):
            clipvip_artifact_launches, (b32_model, b32_batch) = clipvip_artifact_phase(card, folder)
        with phase("7b LF-VILA serving artifact, window kernel on (main path)"):
            lfvila_artifact_launches = lfvila_artifact_phase(card, lfvila_preset, folder)
        with phase("7c HD-VILA serving artifact at the stage-1 preset's width"):
            hdvila_artifact_phase(card)
        with phase("7d xpt::patch_embed_u8 through torch.export (main path)"):
            patch_artifact_launches = patch_embed_export_phase(card, folder)
    with phase("7e w8a8 serving of B/32 against bf16"):
        int8_phase(card, b32_model, b32_batch)
        del b32_model, b32_batch
        release_memory()
    with phase("7f create_mesh in a process without a group: ring attention on a one-rank seq mesh (main path)"):
        one_process_launches = one_process_mesh_phase(card)
    with one_rank_nccl_group():
        with phase("8a B/32 fine-tune under a one-rank NCCL group, eager and graphed, against 4b (main path)"):
            dp_launches = data_parallel_finetune_phase(card, finetune_reference)
        with phase("8b the graphed step's collectives: profile and timing with and without the group"):
            data_parallel_graph_phase(card)
    with phase("8c LF-VILA stage 1 and the window-kernel eval under a one-rank NCCL group (main path)"):
        dp_lfvila_launches = data_parallel_lfvila_phase(card)
    with one_rank_nccl_group():
        with phase("9a B/32 fine-tune at --zero3 1 under a one-rank NCCL group, eager and graphed, against 4b "
                   "(main path)"):
            zero3_launches = zero3_finetune_phase(card, finetune_reference)
            del finetune_reference
        with phase("9b the B/32 step under the TP plan over a 1 x 1 (data, model) mesh; #1/#2 at --tp 2 and 4 "
                   "shapes (main path)"):
            tp_launches = tp_plan_phase(card)
        with phase("9c the LF-VILA towers through the cp path at model size 1; #6 at --cp 2 shapes (main path)"):
            cp_launches = cp_towers_phase(card, lfvila_preset)
    with one_rank_nccl_group():
        with phase("10a ring attention at BERT-large heads over 2048 tokens on a (data, seq) mesh of one rank "
                   "(main path)"):
            ring_launches = ring_attention_phase(card)
        with phase("10b the GPipe pipeline of BERT-large on a (data, pipe) mesh of one rank (main path)"):
            pipe_launches = pipeline_phase(card)
        with phase("10c the MoE FFN at B/32's MLP widths on a (data, expert) mesh of one rank (main path)"):
            moe_launches = moe_phase(card)
    # the serving artifacts' main path: each run's counts, read just after it
    artifact_launches = {name: clipvip_artifact_launches[name] + lfvila_artifact_launches[name]
                         + patch_artifact_launches[name] for name in KERNELS}

    paths = {"eval": eval_launches, "train": train_launches, "lfvila_retrieval": lfvila_launches,
             "ops": ops_launches, "lfvila_stage1": stage1_launches, "lfvila_stage2": stage2_launches,
             **{f"lfvila_{task}": counts for task, counts in task_launches.items()},
             "clipvip_pretrain": pretrain_launches, "lfvila_stage1_from_2d_swin_bert": cascade_launches,
             "hdvila_stage1": hdvila_stage1_launches, "hdvila_stage2": hdvila_stage2_launches,
             **{f"hdvila_retrieval_{k}": v for k, v in hdvila_retrieval_launches.items()},
             **{f"hdvila_qa_{k}": v for k, v in hdvila_qa_launches.items()},
             "train_graphed_bf16_async": graphed_launches, "lfvila_stage1_graphed": lfvila_graphed_launches,
             "clipvip_factorized": factorized_launches, "serving_artifact": artifact_launches,
             "train_data_parallel": dp_launches[1], "train_data_parallel_graphed": dp_launches[2],
             "lfvila_stage1_data_parallel": dp_lfvila_launches["train"],
             "lfvila_retrieval_data_parallel": dp_lfvila_launches["eval"],
             "train_zero3": zero3_launches[1], "train_zero3_graphed": zero3_launches[DP_GRAPH_K],
             "train_step_tp_plan": tp_launches, "lfvila_towers_cp": cp_launches,
             "ring_attention": ring_launches, "pipeline": pipe_launches, "moe_ffn": moe_launches,
             "train_attention_dropout": dropout_launches["clipvip"],
             "train_attention_dropout_graphed": dropout_launches["clipvip_graphed"],
             "lfvila_qa_mc_attention_dropout": dropout_launches["lfvila"],
             "ring_attention_one_process": one_process_launches}
    window_timing = {dt: win_timings[("s3_shifted", dt)] for dt in ("bfloat16", "float32")}
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            # each main path's count, read just after its own run
            "launches": sum(counts[name] for counts in paths.values()),
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "max_abs_err": err,
            "ms": timing["kernel"],
            "device_ms": timing["device"],
            "plain_ms": timing["plain"],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": lib[name],
        }
        for name, err, timing in (
            ("proxy_attention_fwd", errors[("b32", "bfloat16")], timings["bfloat16"]),
            ("proxy_attention_bwd", bwd_errors[("b32_train", "bfloat16", "forward's LSE")], bwd_timings["bfloat16"]),
            ("proxy_attention_packed_fwd", packed_errors[("b32", "bfloat16")], packed_fwd_timing),
            ("proxy_attention_packed_bwd", packed_errors[("b32_train_bwd", "bfloat16")], packed_bwd_timing),
            ("patch_embed_u8", patch_errors[("b32", "bfloat16")], patch_timing),
            ("window_attention_fwd", win_errors[("s3_shifted", "bfloat16")], window_timing["bfloat16"]),
        )
    ]}
    check(all(k_["launches"] > 0 for k_ in summary["kernels"]), "a kernel was launched no time on the main paths")
    summary["fused_kernels"] = [{
        "name": "frozen_bn_act", "route": "cuda", "source": "xpretrain_tpu_torch/csrc/frozen_bn_act.cu",
        "replaces": None, "launches": sum(counts.get("frozen_bn_act", 0) for counts in paths.values()),
        "launches_by_path": {path: counts["frozen_bn_act"] for path, counts in paths.items()
                             if counts.get("frozen_bn_act")},
        **frozen_bn_timing,
    }]
    check(summary["fused_kernels"][0]["launches"] > 0, "the frozen-BN kernel was launched no time on the main paths")
    summary["fused_kernels"].append({
        "name": "adamw_multi_tensor", "route": "cuda", "source": "xpretrain_tpu_torch/csrc/adamw_multi_tensor.cu",
        "replaces": None, "launches": sum(counts.get("adamw_multi_tensor", 0) for counts in paths.values()),
        "launches_by_path": {path: counts["adamw_multi_tensor"] for path, counts in paths.items()
                             if counts.get("adamw_multi_tensor")},
        "max_ulps_vs_foreach": adamw_worst_ulps, "timing_by_cell": adamw_timing,
    })
    check(summary["fused_kernels"][1]["launches"] > 0, "the AdamW kernel was launched no time on the main paths")
    print(f"patch_embed_u8 beside its fp32 yardstick: kernel {patch_timing['kernel']:.4f} ms, fp32 addmm of the "
          f"gathered patches (TF32 off) {patch_timing['library_fp32']:.4f} ms (CUDA events) [{card}]")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
