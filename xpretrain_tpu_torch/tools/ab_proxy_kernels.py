"""Time the hand-written kernels of several source trees on one card, in
turns, and print each kernel's registers.

A tree is a directory that holds an ``xpretrain_tpu_torch/`` package, for
example another commit's, unpacked with
``git archive <rev> xpretrain_tpu_torch | tar -x -C <dir>``. Each turn runs
in a fresh process that imports that tree's package (and so builds that
tree's kernels into its own ``build/``), times the kernels that ``--kernels``
names with CUDA events and prints one JSON line:

- ``proxy`` (the default): the forward and the backward kernel at the
  CLIP-ViP B/32 shapes (serving b=24, training b=32) in bf16 and fp32, the
  backward called alone (``proxy_attention_bwd``) and, at b=32, forward +
  backward through autograd (``fwdbwd_*``: the one like-for-like line across
  trees whose autograd hands the backward different inputs, such as a saved
  LSE);
- ``patch``: ``fused_patch_embed(use_kernel=True)`` on the 288 frames of a
  B/32 serving batch (224x224, P=32, D=768), bf16 and fp32 out;
- ``window``: ``window_attention`` at the LF-VILA b=8 stage shapes
  (``s3_shifted``, ``s3``, ``s5``, ``s0_grouped``, ``s1_grouped``), bf16 and
  fp32, on contiguous q/k/v and on q/k/v views of one fused qkv tensor
  (``*_views``, what the model passes).

Compare two versions only within one run, in turns there and back (the
default order is A, B, B, A).

    python -m xpretrain_tpu_torch.tools.ab_proxy_kernels \\
        --tree parent=<dir> --tree change=. --order parent,change,change,parent \\
        --kernels patch,window
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

_TURN = r"""
import json, sys
import torch

sys.path.insert(0, sys.argv[1])
kernels = sys.argv[2].split(",")
from xpretrain_tpu_torch.ops import _kernels
from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

torch.backends.cuda.matmul.allow_tf32 = False
g = torch.Generator(device="cuda").manual_seed(0)
out = {"package": _kernels.__file__}
dtypes = (torch.bfloat16, torch.float32)
if "proxy" in kernels:
    from xpretrain_tpu_torch.ops import proxy_attention as pa
    for B in (24, 32):
        H, M, N, L, D = 12, 4, 12, 49, 64
        S, scale = M + N * L, D ** -0.5
        for dtype in dtypes:
            q, k, v, d_out = (torch.randn(B, H, S, D, device="cuda", generator=g).to(dtype) for _ in range(4))
            name = str(dtype).split(".")[-1]
            out[f"fwd_b{B}_{name}_ms"] = cuda_time_ms(lambda: pa.proxy_attention(q, k, v, M, N, L, scale), 200, 20)
            out[f"bwd_b{B}_{name}_ms"] = cuda_time_ms(
                lambda: pa.proxy_attention_bwd(q, k, v, d_out, M, N, L, scale), 200, 20)
            if B == 32:
                def fwd_bwd():
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    pa.proxy_attention(*leaves, M, N, L, scale).backward(d_out)
                out[f"fwdbwd_b{B}_{name}_ms"] = cuda_time_ms(fwd_bwd, 200, 20)
if "patch" in kernels:
    from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
    from xpretrain_tpu_torch.ops import patchify as pp
    frames = torch.randint(0, 256, (288, 224, 224, 3), device="cuda", generator=g, dtype=torch.uint8)
    kernel = torch.randn(32, 32, 3, 768, device="cuda", generator=g) * 0.02
    for dtype in dtypes:
        name = str(dtype).split(".")[-1]
        out[f"patch_b32_{name}_ms"] = cuda_time_ms(
            lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, dtype, use_kernel=True), 50, 5)
if "window" in kernels:
    import numpy as np
    from xpretrain_tpu_torch.models.lf_vila.swin3d import grouped_window_mask, shifted_window_mask
    from xpretrain_tpu_torch.ops import window_attention as wa
    shapes = {  # (Bn, H, N, d, mask) of LF-VILA at b=8, as chip_smoke.py's WINDOW_SHAPES
        "s3_shifted": (64, 16, 240, 32, shifted_window_mask((32, 6, 10), (16, 3, 5), (0, 1, 2))),
        "s3": (64, 16, 240, 32, None),
        "s5": (8, 32, 480, 32, None),
        "s0_grouped": (2048, 4, 120, 32, grouped_window_mask((32, 24, 40), (2, 3, 5), (0, 1, 2), 4)),
        "s1_grouped": (512, 8, 120, 32, grouped_window_mask((32, 12, 20), (4, 3, 5), (0, 1, 2), 2)),
    }
    for shape, (Bn, H, N, d, mask) in shapes.items():
        mask = None if mask is None else torch.from_numpy(np.array(mask)).cuda()
        bias = torch.randn(H, N, N, device="cuda", generator=g)
        for dtype in dtypes:
            name = str(dtype).split(".")[-1]
            q, k, v = torch.randn(Bn, N, 3, H, d, device="cuda", generator=g).to(dtype).permute(2, 0, 3, 1, 4)
            qc, kc, vc = (t.contiguous() for t in (q, k, v))
            out[f"window_{shape}_{name}_ms"] = cuda_time_ms(lambda: wa.window_attention(qc, kc, vc, bias, mask),
                                                            200, 20)
            out[f"window_{shape}_{name}_views_ms"] = cuda_time_ms(lambda: wa.window_attention(q, k, v, bias, mask),
                                                                  200, 20)
out["ptxas_log"] = str(_kernels.library_path().with_suffix(".log"))
print("RESULT " + json.dumps(out))
"""


# entry names: the D=64 proxy-attention kernels (the CUDA-core ones, both
# dtypes before the tensor-core kernels, fp32 since, D/4 = 16 lanes' worth;
# the bf16 tensor-core forward, its LSE-only form and the two passes), the
# d=32 window-attention kernels (the CUDA-core one, of both dtypes before the
# tensor-core kernel, fp32 since) and the patch-embed kernels
_ENTRIES = (r"(proxy_attention_fwd_kernel|bwd_dq_kernel|bwd_dkv_kernel)I(f|13__nv_bfloat16)Li16E",
            r"(fwd_mma_kernel)ILi64ELb([01])E", r"(dq_mma_kernel|dkv_mma_kernel)ILi64E()",
            r"(window_attention_fwd_kernel)I(f|13__nv_bfloat16|)Li8E", r"(window_mma_kernel)ILi32E()",
            r"(patch_embed_u8_kernel)I(f|13__nv_bfloat16)E", r"(patch_embed_mma_kernel)ILb1E()",
            r"(patch_embed_fp32_kernel|patch_weight_split_kernel|patch_bias_shift_kernel)E()")


def registers(log_path: str) -> dict[str, int]:
    """Registers of each kernel of ``_ENTRIES`` in an ``-Xptxas -v`` log."""
    found, entry = {}, None
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"Used (\d+) registers", line)
            if not (m and entry):
                continue
            for pattern in _ENTRIES:
                kind = re.search(pattern, entry)
                if kind:
                    name, arg = kind.groups()
                    suffix = {"f": "_fp32", "13__nv_bfloat16": "_bf16", "0": "_lse_only", "1": "", "": ""}[arg]
                    found[f"{name}{suffix}"] = int(m.group(1))
    return found


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", action="append", required=True, help="name=directory holding xpretrain_tpu_torch/")
    parser.add_argument("--order", default="", help="comma-separated tree names (default: A,B,B,A of the first two)")
    parser.add_argument("--kernels", default="proxy", help="comma-separated: proxy, patch, window")
    args = parser.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    names = list(trees)
    order = args.order.split(",") if args.order else [names[0], names[-1], names[-1], names[0]]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    results = []
    for name in order:
        root = os.path.abspath(trees[name])
        proc = subprocess.run([sys.executable, "-c", _TURN, root, args.kernels], capture_output=True, text=True,
                              timeout=900)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            raise RuntimeError(f"turn {name} failed:\n{proc.stderr[-4000:]}")
        result = {"tree": name, **json.loads(lines[-1][len("RESULT "):])}
        result["registers"] = registers(result.pop("ptxas_log"))
        if not result["package"].startswith(root):
            raise RuntimeError(f"turn {name} imported {result['package']}, not the tree at {root}")
        results.append(result)
        print(json.dumps(result), flush=True)
    return results


if __name__ == "__main__":
    main()
