"""Export a CLIP-ViP retrieval checkpoint as a serving artifact (the port's
counterpart of ``xpretrain_tpu/cli/export_serving_clipvip.py``).

The reference serves by shipping the repository and a torch checkpoint and
running ``run_video_retrieval.py`` in eval mode. This tool writes a one-file
deployment unit instead: it builds the model from the shared config surface
the runners use (``--clip_size``, ``--num_frm``, ``--crop_img_size``,
``--max_txt_len``, ``--bf16``), loads ``--clip_weights`` /
``--e2e_weights_path`` over the seeded init as ``run_retrieval_clipvip``
does, exports both towers on ``--device`` (default ``cuda``) and writes an
``.xpsa`` file that ``xpretrain_tpu_torch.serving.load_artifact`` serves
with no model code. On a card the video tower holds the proxy-attention
kernel (``--kernel_attention 1``, the default there; ``--pallas_attention``
is accepted as its alias, so the JAX tool's command lines run); ``0`` traces
the plain attention.

Example::

    python -m xpretrain_tpu_torch.cli.export_serving_clipvip \\
        --clip_size base_32 --e2e_weights_path /ckpts/clipvip_b32.pt \\
        --output /deploy/clipvip_b32.xpsa
"""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.cli.run_retrieval_clipvip import build_model, resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser
from xpretrain_tpu_torch.config import parse_with_config
from xpretrain_tpu_torch.serving import export_retrieval_towers, save_artifact
from xpretrain_tpu_torch.utils.logging import LOGGER


def main(argv=None) -> dict:
    parser = build_shared_parser("Export CLIP-ViP retrieval towers as a serving artifact (PyTorch)")
    parser.add_argument("--output", type=str, required=True, help=".xpsa output path")
    parser.add_argument("--fp_input", action="store_true",
                        help="export the fp32 [B,T,C,H,W] input path instead of uint8 [B,T,H,W,3]")
    parser.add_argument("--kernel_attention", "--pallas_attention", dest="kernel_attention", type=int,
                        nargs="?", const=1, default=None,
                        help="1: the proxy-attention CUDA kernel in the video tower (the default on a card); "
                             "0: the plain attention. --pallas_attention is the JAX tool's name for it")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    cfg = parse_with_config(parser, argv)
    device = resolve_device(cfg.device)

    if not (cfg.get("e2e_weights_path") or cfg.get("clip_weights")):
        LOGGER.warning("no --clip_weights/--e2e_weights_path: exporting INIT weights")
    model = build_model(cfg, device)
    kernel = cfg.get("kernel_attention")
    frames, image, seq = int(cfg.num_frm), int(cfg.crop_img_size), int(cfg.max_txt_len)
    artifact = export_retrieval_towers(
        model, frames=frames, image_size=image, seq_len=seq,
        video_dtype=torch.float32 if cfg.get("fp_input") else torch.uint8,
        attention=None if kernel is None else ("kernel" if kernel else "plain"),
    )
    save_artifact(cfg.output, artifact)
    LOGGER.info("wrote %s (device=%s, attention=%s, frames=%d, image=%d, seq=%d)",
                cfg.output, artifact.meta["device"], artifact.meta["attention"], frames, image, seq)
    return artifact.meta


if __name__ == "__main__":
    main()
