"""The port's retrieval eval CLI on the CPU, and its JAX-free imports."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_retrieval_clipvip  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--dummy_data", "1", "--mode", "eval", "--clip_size", "tiny", "--num_frm", "2",
        "--crop_img_size", "32", "--val_batch_size", "24", "--device", "cpu"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


@pytest.mark.parametrize("ingest", ["0", "1"], ids=["fp32_frames", "u8_device_ingest"])
def test_eval_cli_reports_recall(tmp_path, ingest):
    report = run_retrieval_clipvip.main(TINY + ["--device_ingest", ingest, "--output_dir", str(tmp_path)])
    for direction in ("t2v", "v2t"):
        for k in ("R1", "R5", "R10"):
            assert 0.0 <= report[direction][k] <= 100.0
    with open(tmp_path / "eval_report.json") as f:
        assert json.load(f)["t2v"] == report["t2v"]


def test_train_mode_not_ported(tmp_path):
    argv = [a if a != "eval" else "train" for a in TINY] + ["--output_dir", str(tmp_path)]
    with pytest.raises(NotImplementedError, match="training slice"):
        run_retrieval_clipvip.main(argv)


def test_absent_cuda_fails_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_retrieval_clipvip.resolve_device("cuda")


def test_port_and_its_cli_load_no_jax(tmp_path):
    """Import every module of the port, run the eval CLI, and check that
    nothing of JAX was loaded on the way (the card's machine has no JAX)."""
    code = (
        "import pkgutil, sys, xpretrain_tpu_torch\n"
        "for m in pkgutil.walk_packages(xpretrain_tpu_torch.__path__, 'xpretrain_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from xpretrain_tpu_torch.cli.run_retrieval_clipvip import main\n"
        f"main({TINY + ['--device_ingest', '1', '--output_dir', str(tmp_path)]!r})\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
