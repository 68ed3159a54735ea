"""The port's retrieval CLI on the CPU (eval and fine-tune), and its JAX-free imports."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_retrieval_clipvip  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--dummy_data", "1", "--mode", "eval", "--clip_size", "tiny", "--num_frm", "2",
        "--crop_img_size", "32", "--val_batch_size", "24", "--device", "cpu"]
TRAIN = [a for a in TINY if a not in ("--mode", "eval")] + [
    "--train_batch_size", "8", "--num_train_steps", "4", "--log_steps", "1", "--bf16", "0",
    "--learning_rate", "1e-3", "--decay", "constant", "--warmup_ratio", "0",
]  # no --mode: the default is train, as in the JAX runner
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


@pytest.mark.parametrize("ingest", ["0", "1"], ids=["fp32_frames", "u8_device_ingest"])
def test_eval_cli_reports_recall(tmp_path, ingest):
    report = run_retrieval_clipvip.main(TINY + ["--device_ingest", ingest, "--output_dir", str(tmp_path)])
    for direction in ("t2v", "v2t"):
        for k in ("R1", "R5", "R10"):
            assert 0.0 <= report[direction][k] <= 100.0
    with open(tmp_path / "eval_report.json") as f:
        assert json.load(f)["t2v"] == report["t2v"]


SWITCHES = ["--steps_per_call", "2", "--param_dtype", "bf16", "--async_checkpoint", "1"]


def test_train_mode_takes_the_production_switches(tmp_path):
    """``--steps_per_call 2 --param_dtype bf16 --async_checkpoint 1``: 4 steps
    in 2 chunks, a loss logged per step, both async checkpoints written, and
    in each the parameters of >= 2 dims stored in bf16 equal to bf16 of the
    fp32 masters the optimizer state carries."""
    report = run_retrieval_clipvip.main(TRAIN + SWITCHES + ["--valid_steps", "2", "--save_steps", "2",
                                                            "--output_dir", str(tmp_path)])
    assert all(np.isfinite(report["t2v"][k]) for k in ("R1", "R5", "R10"))
    rows = [json.loads(line) for line in open(tmp_path / "log" / "scalars.jsonl")]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    assert [r["step"] for r in rows if r["tag"] == "train/loss"] == [1, 2, 3, 4] and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "4.pt"]
    for name in ("2.pt", "4.pt"):
        ckpt = torch.load(tmp_path / "ckpt" / name, weights_only=True)
        masters = ckpt["optimizer"]["master"]
        for key, value in ckpt["model"].items():
            if value.dim() >= 2:
                assert value.dtype == torch.bfloat16 and torch.equal(value, masters[key].to(torch.bfloat16)), key
            else:
                assert value.dtype == torch.float32 and key not in masters, key


def test_bf16_resume_equals_an_unbroken_run(tmp_path):
    """A bf16-stored run at K = 2 with async saves, broken at step 2 and
    resumed from its checkpoint's masters in a fresh run, ends where an
    unbroken one does, bit for bit."""
    flags = SWITCHES + ["--validate_at_start", "0", "--valid_steps", "100", "--save_steps", "2"]
    run_retrieval_clipvip.main(TRAIN + flags + ["--output_dir", str(tmp_path / "a")])
    broken = [a if a != "4" else "2" for a in TRAIN] + flags + ["--output_dir", str(tmp_path / "b")]
    run_retrieval_clipvip.main(broken)
    run_retrieval_clipvip.main(TRAIN + flags + ["--output_dir", str(tmp_path / "b")])
    a = torch.load(tmp_path / "a" / "ckpt" / "4.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "ckpt" / "4.pt", weights_only=True)
    assert a["step"] == b["step"] == 4 and a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for part in ("model", ("optimizer", "master"), ("optimizer", "mu"), ("optimizer", "nu")):
        want, got = (c[part] if isinstance(part, str) else c[part[0]][part[1]] for c in (a, b))
        assert set(got) == set(want)
        for key, value in want.items():
            assert got[key].dtype == value.dtype and torch.equal(got[key], value), (part, key)


def test_train_cli_writes_final_report(tmp_path):
    report = run_retrieval_clipvip.main(TRAIN + ["--valid_steps", "2", "--save_steps", "2",
                                                 "--output_dir", str(tmp_path)])
    with open(tmp_path / "final_report.json") as f:
        assert json.load(f)["t2v"] == report["t2v"]
    rows = [json.loads(line) for line in open(tmp_path / "log" / "scalars.jsonl")]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["2.pt", "4.pt"]
    assert os.listdir(tmp_path / "best")  # validated at 2 and 4: a best model was kept


def test_default_mode_is_train(monkeypatch):
    """As the JAX runner (``xpretrain_tpu/cli/run_retrieval_clipvip.py``)."""
    seen = {}

    def capture(parser, argv):
        seen["mode"] = parser.get_default("mode")
        raise SystemExit(0)

    monkeypatch.setattr(run_retrieval_clipvip, "parse_args", capture)
    with pytest.raises(SystemExit):
        run_retrieval_clipvip.main([])
    assert seen["mode"] == "train"


def test_resume_equals_an_unbroken_run(tmp_path):
    """4 steps with a save at 2 == 2 steps, then a fresh process resuming to 4."""
    flags = ["--validate_at_start", "0", "--valid_steps", "100", "--save_steps", "2"]
    straight = TRAIN + flags + ["--output_dir", str(tmp_path / "a")]
    run_retrieval_clipvip.main(straight)
    broken = [a if a != "4" else "2" for a in TRAIN] + flags + ["--output_dir", str(tmp_path / "b")]
    run_retrieval_clipvip.main(broken)
    run_retrieval_clipvip.main(TRAIN + flags + ["--output_dir", str(tmp_path / "b")])
    a = torch.load(tmp_path / "a" / "ckpt" / "4.pt", weights_only=True)
    b = torch.load(tmp_path / "b" / "ckpt" / "4.pt", weights_only=True)
    assert a["step"] == b["step"] == 4 and a["optimizer"]["count"] == b["optimizer"]["count"] == 4
    for key, value in a["model"].items():
        torch.testing.assert_close(b["model"][key], value, rtol=0, atol=0, msg=key)
    for key, value in a["optimizer"]["mu"].items():
        torch.testing.assert_close(b["optimizer"]["mu"][key], value, rtol=0, atol=0, msg=key)


def test_train_mode_trains_on_the_val_split_without_a_train_annotation(tmp_path, monkeypatch):
    """As the JAX runner (``train_loader or val_loader``,
    ``xpretrain_tpu/cli/run_retrieval_clipvip.py``): with no train split,
    ``--mode train`` hands the val loader to the trainer and trains on it."""
    build = run_retrieval_clipvip.build_loaders
    seen = {}

    def val_only(cfg):
        _, val_loader, valid_len = build(cfg)
        seen["val"] = val_loader
        return None, val_loader, valid_len

    class Capture(run_retrieval_clipvip.ClipVipTrainer):
        def __init__(self, cfg, train_loader, *args, **kwargs):
            seen["train"] = train_loader
            super().__init__(cfg, train_loader, *args, **kwargs)

    monkeypatch.setattr(run_retrieval_clipvip, "build_loaders", val_only)
    monkeypatch.setattr(run_retrieval_clipvip, "ClipVipTrainer", Capture)
    run_retrieval_clipvip.main(TRAIN + ["--num_train_steps", "2", "--validate_at_start", "0",
                                        "--output_dir", str(tmp_path)])
    assert seen["train"] is seen["val"]
    rows = [json.loads(line) for line in open(tmp_path / "log" / "scalars.jsonl")]
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_fused_adamw_is_read_and_ignored(tmp_path):
    """With fp32 moments ``--fused_adamw`` picks an optimizer-state layout in
    JAX; the port has one (``ClipVipTrainer``'s docstring): 0 and 1 give
    bit-identical first steps, parameters and optimizer state (with bf16
    moments 0 raises: the next test)."""
    flags = ["--num_train_steps", "1", "--validate_at_start", "0", "--valid_steps", "100", "--save_steps", "1"]
    for fused in ("0", "1"):
        run_retrieval_clipvip.main(TRAIN + flags + ["--fused_adamw", fused, "--output_dir", str(tmp_path / fused)])
    a, b = (torch.load(tmp_path / fused / "ckpt" / "1.pt", weights_only=True) for fused in ("0", "1"))
    for key, value in a["model"].items():
        torch.testing.assert_close(b["model"][key], value, rtol=0, atol=0, msg=key)
    for moment in ("mu", "nu"):
        for key, value in a["optimizer"][moment].items():
            torch.testing.assert_close(b["optimizer"][moment][key], value, rtol=0, atol=0, msg=key)


def test_moment_dtype_bf16_without_fused_adamw_raises_as_in_jax(tmp_path):
    """``--moment_dtype bf16 --fused_adamw 0``: JAX's ``build_optimizer``
    raises ``ValueError("moment_dtype requires fused=True ...")``; the
    port's raises the same, through the CLI and called alone, and takes
    ``fused_adamw 1``."""
    import jax.numpy as jnp

    from xpretrain_tpu.optim.optimizer import build_optimizer as jax_build_optimizer
    from xpretrain_tpu_torch.optim.optimizer import build_optimizer

    with pytest.raises(ValueError, match="moment_dtype requires fused=True") as jax_error:
        jax_build_optimizer({"w": jnp.zeros((2, 2))}, lambda step: 1e-3, fused=False, moment_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="moment_dtype requires fused=True") as port_error:
        build_optimizer({"w": torch.zeros(2, 2)}, lambda step: 1e-3, fused=False, moment_dtype=torch.bfloat16)
    assert str(port_error.value) == str(jax_error.value)
    flags = ["--num_train_steps", "1", "--validate_at_start", "0", "--valid_steps", "100", "--moment_dtype", "bf16"]
    with pytest.raises(ValueError, match="moment_dtype requires fused=True"):
        run_retrieval_clipvip.main(TRAIN + flags + ["--fused_adamw", "0", "--output_dir", str(tmp_path / "0")])
    run_retrieval_clipvip.main(TRAIN + flags + ["--fused_adamw", "1", "--output_dir", str(tmp_path / "1")])


def test_absent_cuda_fails_instead_of_falling_back():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_retrieval_clipvip.resolve_device("cuda")


def test_port_and_its_cli_load_no_jax(tmp_path):
    """Import every module of the port, run the eval and the train CLI, and
    check that nothing of JAX was loaded on the way (the card's machine has
    no JAX)."""
    code = (
        "import pkgutil, sys, xpretrain_tpu_torch\n"
        "for m in pkgutil.walk_packages(xpretrain_tpu_torch.__path__, 'xpretrain_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "from xpretrain_tpu_torch.cli.run_retrieval_clipvip import main\n"
        f"main({TINY + ['--device_ingest', '1', '--output_dir', str(tmp_path)]!r})\n"
        f"main({TRAIN + ['--num_train_steps', '2', '--output_dir', str(tmp_path / 'train')]!r})\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"
