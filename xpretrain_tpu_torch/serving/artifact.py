"""Serving artifacts: the retrieval towers as ``torch.export`` programs in one
file, the counterpart of ``xpretrain_tpu/serving/artifact.py``.

The reference deploys retrieval by shipping the training stack and a torch
checkpoint that ``run_video_retrieval.py`` restores at start-up. Here the
deployment unit is one ``.xpsa`` file: each tower is traced once by
``torch.export.export`` with the weights inside and a symbolic batch
dimension, so one artifact serves every batch size, and a serving process
calls it with no model code, only ``torch`` and the port's ops package.

Layout of the ``.xpsa`` file (a zip, members stored as written):

- ``video.pt2`` / ``text.pt2``: ``torch.export.save`` of the video and text
  towers' programs, each holding only the weights its tower reads;
- ``meta.json``: input shapes and dtypes, the feature width, ``logit_scale``
  (CLIP-ViP) or ``temp`` (LF-VILA, HD-VILA), the ``device`` the programs were
  exported for (``cuda`` or ``cpu``: weights and constants live there),
  ``attention`` (``kernel``: the port's CUDA kernels as ``torch.ops.xpt.*``
  calls inside the program; ``plain``: PyTorch ops only) and the torch
  version that wrote it.

A ``kernel`` artifact calls the ``xpt::`` custom ops, so
:func:`load_artifact` imports ``xpretrain_tpu_torch.ops`` (which registers
them) first, and it needs a card; the kernels build from the package's
``csrc/`` at their first call. An artifact exported for ``cuda`` loaded where
torch sees no CUDA device raises: nothing moves it to another device. The
JAX package's ``.xpsa`` holds StableHLO members (``*.jaxexp``): the two
formats are not interchangeable, and this loader rejects a JAX file as not
a serving artifact.

The towers:

- video: CLIP-ViP uint8 [B, T, H, W, 3] (or fp32 [B, T, C, H, W]), LF-VILA
  fp32 [B, 3, N, H, W], HD-VILA uint8 ``(img_middle, img_other)``, each to
  L2-normalized [B, dim] features;
- text: token ids + mask ([B, seq], or [B, M, L] sentences for LF-VILA) to
  L2-normalized [B, dim] features.

Ranking is the plain product the caller owns, ``text_feats @ video_feats.T``
(:meth:`RetrievalArtifact.similarity`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import zipfile
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.export.graph_signature import InputKind

_VIDEO_MEMBER = "video.pt2"
_TEXT_MEMBER = "text.pt2"
_META_MEMBER = "meta.json"

FORMAT_VERSION = 1


@dataclasses.dataclass
class RetrievalArtifact:
    """The two exported towers and their metadata.

    ``encode_video`` is variadic: CLIP-ViP and LF-VILA towers take one video
    tensor, HD-VILA's hybrid tower ``(img_middle, img_other)``
    (``meta["family"]`` says which, ``meta`` records the shapes). Inputs may
    be numpy arrays or tensors; they are moved to the artifact's device,
    and token ids and masks are cast to int64 (the exported dtype)."""

    video: torch.export.ExportedProgram
    text: torch.export.ExportedProgram
    meta: dict[str, Any]

    def __post_init__(self) -> None:
        self.device = torch.device(self.meta["device"])
        self._video_call = self.video.module()
        self._text_call = self.text.module()

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def encode_video(self, *video) -> torch.Tensor:
        with torch.no_grad():
            return self._video_call(*(self._to_device(v) for v in video))

    def encode_text(self, input_ids, attention_mask) -> torch.Tensor:
        with torch.no_grad():
            return self._text_call(self._to_device(input_ids).long(), self._to_device(attention_mask).long())

    def similarity(self, text_feats: torch.Tensor, video_feats: torch.Tensor, scaled: bool = False) -> torch.Tensor:
        """[Nt, Nv] retrieval scores; ``scaled`` applies exp(logit_scale)
        (CLIP-ViP) or 1/temp (HD-VILA / LF-VILA)."""
        scores = text_feats.float() @ video_feats.float().T
        if scaled:
            if "logit_scale" in self.meta:
                scores = scores * float(np.exp(self.meta["logit_scale"]))
            elif "temp" in self.meta:
                scores = scores / float(self.meta["temp"])
        return scores


class _Tower(nn.Module):
    """One method of a model as the module ``torch.export`` traces."""

    def __init__(self, model: nn.Module, method: str):
        super().__init__()
        self.model = model
        self.method = method

    def forward(self, *args: torch.Tensor) -> torch.Tensor:
        return getattr(self.model, self.method)(*args)


def _drop_unused_weights(program: torch.export.ExportedProgram) -> torch.export.ExportedProgram:
    """Remove the parameters, buffers and constants the graph never reads
    (the other tower's weights), in place: each tower's file then holds its
    own weights only."""
    signature = program.graph_signature
    placeholders = [node for node in program.graph.nodes if node.op == "placeholder"]
    kept = []
    for node, spec in zip(placeholders, signature.input_specs):
        if node.name != spec.arg.name:
            raise RuntimeError(f"exported program: placeholder {node.name} does not match its input {spec}")
        if spec.kind in (InputKind.PARAMETER, InputKind.BUFFER, InputKind.CONSTANT_TENSOR) and not node.users:
            program.graph.erase_node(node)
            # lifted constants and non-persistent buffers live in constants
            for store in (program.state_dict, program.constants):
                store.pop(spec.target, None)
        else:
            kept.append(spec)
    signature.input_specs[:] = kept
    program.graph_module.recompile()
    return program


def _export_tower(model: nn.Module, method: str, samples: tuple,
                  context: Callable = contextlib.nullcontext) -> torch.export.ExportedProgram:
    """Trace ``model.<method>(*samples)`` in eval mode under ``no_grad``,
    with a symbolic batch dimension shared by every input (the samples'
    batch must be >= 2, else the trace specializes it to their size)."""
    batch = torch.export.Dim("b", min=1)
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), context():
            program = torch.export.export(_Tower(model, method), samples,
                                          dynamic_shapes=(tuple({0: batch} for _ in samples),))
    finally:
        model.train(was_training)
    return _drop_unused_weights(program)


def _device_of(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def _attention(requested: Optional[str], device: torch.device, has_kernel: bool) -> str:
    """``kernel`` or ``plain``: what the artifact's attention runs. The
    default is the device's own path (the kernels on a card); the kernels
    run on CUDA tensors only."""
    attention = requested or ("kernel" if device.type == "cuda" and has_kernel else "plain")
    if attention not in ("kernel", "plain"):
        raise ValueError(f"attention must be 'kernel' or 'plain', got {attention!r}")
    if attention == "kernel" and device.type != "cuda":
        raise ValueError(f"attention='kernel' puts the port's CUDA kernels in the artifact: the model must be on "
                         f"a CUDA device, got {device}")
    if attention == "kernel" and not has_kernel:
        raise ValueError("attention='kernel': this model runs none of the port's kernels")
    return attention


def _common_meta(family: str, device: torch.device, attention: str) -> dict[str, Any]:
    return {"format_version": FORMAT_VERSION, "family": family, "device": device.type, "attention": attention,
            "torch_version": torch.__version__}


def export_retrieval_towers(
    model,
    *,
    frames: int,
    image_size: int,
    seq_len: int,
    video_dtype: torch.dtype = torch.uint8,
    attention: Optional[str] = None,
) -> RetrievalArtifact:
    """Export a ``CLIPViPModel``'s towers, on the device its weights are on.

    The video tower takes uint8 [B, T, H, W, 3] frames (the device-ingest
    path) or, with a float ``video_dtype``, channel-first [B, T, C, H, W]
    clips normalized on the host; the text tower int64 [B, seq] ids + mask.
    ``attention`` (default: ``kernel`` on a card, ``plain`` on the CPU)
    picks the proxy attention the program holds: ``kernel`` calls
    ``xpt::proxy_attention_fwd`` in every video layer, ``plain`` traces
    ``proxy_attention_plain`` under
    :func:`~xpretrain_tpu_torch.ops.proxy_attention.force_plain_attention`
    (JAX's ``use_pallas_attention=False``)."""
    from xpretrain_tpu_torch.ops.proxy_attention import force_plain_attention

    device = _device_of(model)
    attention = _attention(attention, device, has_kernel=True)
    if video_dtype == torch.uint8:
        video = torch.zeros((2, frames, image_size, image_size, 3), dtype=torch.uint8, device=device)
    else:
        video = torch.zeros((2, frames, 3, image_size, image_size), dtype=video_dtype, device=device)
    ids = torch.zeros((2, seq_len), dtype=torch.long, device=device)
    ids[:, 1] = model.config.text.vocab_size - 1  # an EOT: the argmax the text tower pools at
    context = force_plain_attention if attention == "plain" else contextlib.nullcontext
    video_program = _export_tower(model, "forward_video", (video,), context)
    text_program = _export_tower(model, "forward_text", (ids, torch.ones_like(ids)))
    meta = {
        **_common_meta("clip_vip", device, attention),
        "frames": frames,
        "image_size": image_size,
        "seq_len": seq_len,
        "video_dtype": str(video_dtype).removeprefix("torch."),
        "projection_dim": int(model.config.projection_dim),
        "logit_scale": float(model.logit_scale.detach().float().cpu()),
    }
    return RetrievalArtifact(video=video_program, text=text_program, meta=meta)


def export_lfvila_retrieval_towers(
    model,
    *,
    frames: int = 32,
    image_size: tuple[int, int] = (192, 320),
    n_sent: int = 4,
    sent_len: int = 50,
) -> RetrievalArtifact:
    """Export an ``LfVilaRetrieval``'s dual-encoder towers: video fp32
    [B, 3, N, H, W] (ImageNet-normalized) frames, text [B, M, L] sentence ids
    + mask. The window kernel is in the program where the model's config
    turns it on (``use_pallas_attention``, for the windows its gate takes)
    and the model is on a card (``meta["attention"] == "kernel"``)."""
    device = _device_of(model)
    gated = any(getattr(m, "use_pallas", False) for m in model.modules())
    attention = _attention(None, device, has_kernel=gated)
    video = torch.zeros((2, 3, frames, *image_size), dtype=torch.float32, device=device)
    ids = torch.ones((2, n_sent, sent_len), dtype=torch.long, device=device)
    video_program = _export_tower(model, "forward_video", (video,))
    text_program = _export_tower(model, "forward_text", (ids, torch.ones_like(ids)))
    meta = {
        **_common_meta("lf_vila", device, attention),
        "frames": frames,
        "image_size": list(image_size),
        "n_sent": n_sent,
        "sent_len": sent_len,
        "temp": float(model.config.temp),
    }
    return RetrievalArtifact(video=video_program, text=text_program, meta=meta)


def export_hdvila_retrieval_towers(
    model,
    *,
    n_clips: int = 2,
    n_hi_frames: int = 1,
    n_lo_frames: int = 6,
    hi_size: tuple[int, int] = (640, 1024),
    lo_size: tuple[int, int] = (160, 256),
    seq_len: int = 50,
) -> RetrievalArtifact:
    """Export an ``HdVilaPretrainModel``'s stage-1 ITC towers. The video
    tower takes the hybrid pair the collator produces, as uint8 (the port
    normalizes once, on the device): ``img_middle [B, clips, 3·n_hi, H, W]``
    high-res middles and ``img_other [B, clips, n_lo, 3, h, w]`` low-res
    neighbours; the text tower int64 [B, seq] ids + mask. HD-VILA runs none
    of the port's kernels (``meta["attention"] == "plain"``)."""
    device = _device_of(model)
    middle = torch.zeros((2, n_clips, 3 * n_hi_frames, *hi_size), dtype=torch.uint8, device=device)
    other = torch.zeros((2, n_clips, n_lo_frames, 3, *lo_size), dtype=torch.uint8, device=device)
    ids = torch.ones((2, seq_len), dtype=torch.long, device=device)
    video_program = _export_tower(model, "forward_video", (middle, other))
    text_program = _export_tower(model, "forward_text", (ids, torch.ones_like(ids)))
    meta = {
        **_common_meta("hd_vila", device, _attention(None, device, has_kernel=False)),
        "n_clips": n_clips,
        "n_hi_frames": n_hi_frames,
        "n_lo_frames": n_lo_frames,
        "hi_size": list(hi_size),
        "lo_size": list(lo_size),
        "seq_len": seq_len,
        "video_dtype": "uint8",
        "temp": float(getattr(model, "temp", 0.05)),
    }
    return RetrievalArtifact(video=video_program, text=text_program, meta=meta)


def save_artifact(path: str, artifact: RetrievalArtifact) -> None:
    """Write the artifact as one ``.xpsa`` zip (see the module docstring).

    Each program is saved to a temporary file beside ``path`` and copied
    into the zip from there, so no whole program is held in memory twice
    (a B/32 tower holds hundreds of MB of weights)."""
    folder = os.path.dirname(os.path.abspath(path))
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED, allowZip64=True) as zf:
        for member, program in ((_VIDEO_MEMBER, artifact.video), (_TEXT_MEMBER, artifact.text)):
            fd, tmp = tempfile.mkstemp(suffix=".pt2", dir=folder)
            os.close(fd)
            try:
                torch.export.save(program, tmp)
                zf.write(tmp, member)
            finally:
                os.unlink(tmp)
        zf.writestr(_META_MEMBER, json.dumps(artifact.meta, indent=2))


def load_artifact(path: str) -> RetrievalArtifact:
    """Load an ``.xpsa`` artifact: no model code needed, only torch and the
    port's ops package (imported here: a ``kernel`` artifact calls
    ``torch.ops.xpt.*``). Raises on a file that is not one, on a newer
    format, and on an artifact exported for ``cuda`` where torch sees no CUDA
    device."""
    import xpretrain_tpu_torch.ops  # noqa: F401  (registers the xpt:: ops)

    with zipfile.ZipFile(path) as zf:
        missing = {_VIDEO_MEMBER, _TEXT_MEMBER, _META_MEMBER} - set(zf.namelist())
        if missing:
            raise ValueError(f"{path}: not a serving artifact (missing {sorted(missing)})")
        meta = json.loads(zf.read(_META_MEMBER))
        if meta.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"{path}: artifact format v{meta['format_version']} is newer than "
                f"this reader (v{FORMAT_VERSION}): upgrade xpretrain_tpu_torch"
            )
        if meta.get("device") == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"{path}: the artifact was exported for cuda (attention={meta.get('attention')}), and torch sees no "
                "CUDA device here: load it on a card, or export one for the CPU"
            )
        programs = []
        for member in (_VIDEO_MEMBER, _TEXT_MEMBER):
            with zf.open(member) as f:
                programs.append(torch.export.load(f))
    return RetrievalArtifact(video=programs[0], text=programs[1], meta=meta)
