"""Time the proxy-attention kernels of several source trees on one card, in
turns, and print each kernel's registers.

A tree is a directory that holds an ``xpretrain_tpu_torch/`` package, for
example another commit's, unpacked with
``git archive <rev> xpretrain_tpu_torch | tar -x -C <dir>``. Each turn runs
in a fresh process that imports that tree's package (and so builds that
tree's kernels into its own ``build/``), times the forward and the backward
kernel at the CLIP-ViP B/32 shapes (serving b=24, training b=32) in bf16 and
fp32 with CUDA events, the backward called alone (``proxy_attention_bwd``)
and, at b=32, forward + backward through autograd (``fwdbwd_*``: the one
like-for-like line across trees whose autograd hands the backward different
inputs, such as a saved LSE), and prints one JSON line. Compare two versions
only within one run, in turns there and back (the default order is A, B, B,
A).

    python -m xpretrain_tpu_torch.tools.ab_proxy_kernels \\
        --tree parent=<dir> --tree change=. --order parent,change,change,parent
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
from xpretrain_tpu_torch.ops import _kernels, proxy_attention as pa
from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

g = torch.Generator(device="cuda").manual_seed(0)
out = {"package": pa.__file__}
for B in (24, 32):
    H, M, N, L, D = 12, 4, 12, 49, 64
    S, scale = M + N * L, D ** -0.5
    for dtype in (torch.bfloat16, torch.float32):
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
out["ptxas_log"] = str(_kernels.library_path().with_suffix(".log"))
print("RESULT " + json.dumps(out))
"""


# entry names of the D=64 proxy-attention kernels: the CUDA-core ones (both
# dtypes before the tensor-core kernels, fp32 since; D/4 = 16 lanes' worth),
# and the bf16 tensor-core ones (forward, its LSE-only form, the two passes)
_ENTRIES = (r"(proxy_attention_fwd_kernel|bwd_dq_kernel|bwd_dkv_kernel)I(f|13__nv_bfloat16)Li16E",
            r"(fwd_mma_kernel)ILi64ELb([01])E", r"(dq_mma_kernel|dkv_mma_kernel)ILi64E()")


def registers(log_path: str) -> dict[str, int]:
    """Registers of each D=64 proxy-attention kernel in an ``-Xptxas -v`` log."""
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
        proc = subprocess.run([sys.executable, "-c", _TURN, root], capture_output=True, text=True, timeout=900)
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
