"""Port parity: LF-VILA paragraph-to-video retrieval
(``xpretrain_tpu_torch/models/lf_vila/tasks.py``), its towers, its config
builder and its runner (``xpretrain_tpu_torch/cli/run_tasks_lfvila.py``).

The model and the towers are held against the JAX package's
``LfVilaRetrieval`` from the same flax params (``load_jax_params``), fp32 on
the CPU, with ``use_pallas_attention`` on so that the window-kernel gate is
taken (its plain version runs here); the bar is ROADMAP's LF-VILA one, 5e-5.
The flax params are built once for the module."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_tasks_lfvila  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila import swin3d  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths, load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval  # noqa: E402
from xpretrain_tpu_torch.ops import window_attention as wa  # noqa: E402
from xpretrain_tpu_torch.optim import optimizer as opt  # noqa: E402
from xpretrain_tpu_torch.parallel.train_step import make_model_train_step  # noqa: E402
from xpretrain_tpu_torch.serving.towers import LfVilaTowers  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML_PRESET = os.path.join(REPO, "xpretrain_tpu/configs/presets/lfvila_pretrain_stage1.yaml")
JSON_PRESET = os.path.join(REPO, "xpretrain_tpu_torch/configs/lfvila_stage1_window_kernel.json")
ATOL = 5e-5
B, M, L = 2, 4, 8  # clips, sentences per paragraph, tokens per sentence
FRAMES = (8, 96, 160)
WINDOW_BLOCKS = 3  # tiny Swin3D: stages 3-5, one block each, windows of >= 240 tokens unclipped
# the tiny model through the runner: Swin3D.tiny's widths, the tiny BERT
TINY_CONFIG = {
    "video_encoder": {"embed_dim": 32, "depths": [1, 1, 2, 1, 1, 1], "num_heads": [2, 2, 4, 4, 4, 4],
                      "use_pallas_attention": True},
    "bert": "tiny", "num_local_layers": 2, "stage1_layers": 4, "sample_frame": 8, "sample_clip": 4,
}
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _tiny_port_config() -> LfVilaConfig:
    return LfVilaConfig.tiny(video=Swin3DConfig.tiny(use_pallas_attention=True), sample_frame=FRAMES[0])


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    video = rng.normal(size=(B, 3, *FRAMES)).astype(np.float32)
    ids = rng.integers(1, 1000, size=(B, M, L))
    mask = (np.arange(L)[None, None] < rng.integers(2, L + 1, size=(B, M, 1))).astype(np.int64)
    return video, ids, mask


@pytest.fixture(scope="module")
def pair():
    """(JAX model, noisy flax params, port model loaded from them)."""
    import jax

    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig
    from xpretrain_tpu.models.lf_vila.swin3d import Swin3DConfig as JaxSwin
    from xpretrain_tpu.models.lf_vila.tasks import LfVilaRetrieval as JaxRetrieval

    jax_model = JaxRetrieval(JaxConfig.tiny(video=JaxSwin.tiny(use_pallas_attention=True), sample_frame=FRAMES[0]))
    video, ids, mask = _inputs()
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), video[:1], ids[:1], mask[:1])["params"]
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32), params
    )
    port = LfVilaRetrieval(_tiny_port_config())
    load_jax_params(port, {"params": params})
    return jax_model, params, port.eval()


@pytest.fixture(scope="module")
def jax_outputs(pair):
    """The JAX model's retrieval outputs and its two towers on ``_inputs()``."""
    import jax

    jax_model, params, _ = pair
    video, ids, mask = _inputs()
    apply = jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a))
    out = {k: np.asarray(v) for k, v in apply(params, video, ids, mask).items()}
    tower = jax.jit(lambda p, method, *a: jax_model.apply({"params": p}, *a, method=method), static_argnums=1)
    out["video_tower"] = np.asarray(tower(params, type(jax_model).forward_video, video))
    out["text_tower"] = np.asarray(tower(params, type(jax_model).forward_text, ids, mask))
    return out


def test_retrieval_forward_matches_jax(pair, jax_outputs):
    """Video and text features and the InfoNCE loss, the window gate taken."""
    _, _, port = pair
    before = wa.window_attention.launches
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in _inputs()))
    assert wa.window_attention.launches == before  # CPU: the plain version, no launch
    for key in ("video_global_feat", "text_global_feat", "ct_global_loss", "loss"):
        np.testing.assert_allclose(got[key].numpy(), jax_outputs[key], atol=ATOL, rtol=0, err_msg=key)


def test_towers_match_jax(pair, jax_outputs):
    """``LfVilaTowers`` on fp32 [B,3,N,H,W] frames and on the same frames as
    uint8 [B,N,H,W,3]; the text tower; the similarity the features give."""
    import jax

    jax_model, params, port = pair
    towers = LfVilaTowers(port, "cpu")
    video, ids, mask = _inputs()
    vid = towers.encode_video(video)
    txt = towers.encode_text(ids, mask)
    np.testing.assert_allclose(vid.numpy(), jax_outputs["video_tower"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(txt.numpy(), jax_outputs["text_tower"], atol=ATOL, rtol=0)
    np.testing.assert_allclose(vid.numpy(), jax_outputs["video_global_feat"], atol=ATOL, rtol=0)
    sims = towers.similarity(txt, vid, scaled=True)
    np.testing.assert_allclose(
        sims.numpy(), jax_outputs["text_tower"] @ jax_outputs["video_tower"].T / 0.05, atol=20 * ATOL, rtol=0
    )
    u8 = np.random.default_rng(5).integers(0, 256, size=(B, *FRAMES, 3), dtype=np.uint8)
    want = jax.jit(lambda p, x: jax_model.apply({"params": p}, x, method=type(jax_model).forward_video))(params, u8)
    np.testing.assert_allclose(towers.encode_video(u8).numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_load_is_total(pair):
    """A flax leaf no parameter takes, a parameter no leaf fills and a shape
    mismatch all raise."""
    _, params, _ = pair
    fresh = lambda: LfVilaRetrieval(_tiny_port_config())  # noqa: E731
    extra = dict(params, text_encoder=dict(params["text_encoder"], pooler={"dense": {"bias": np.zeros(256)}}))
    with pytest.raises(KeyError, match="pooler"):
        load_jax_params(fresh(), {"params": extra})
    missing = {k: v for k, v in params.items() if k != "video_global_proj"}
    with pytest.raises(KeyError, match="video_global_proj"):
        load_jax_params(fresh(), {"params": missing})
    bad = dict(params, text_global_proj=dict(params["text_global_proj"], bias=np.zeros(3, np.float32)))
    with pytest.raises(ValueError, match="text_global_proj.bias"):
        load_jax_params(fresh(), {"params": bad})


def test_param_labels_match_jax(pair):
    """Weight-decay groups under ``NO_DECAY_LFVILA``, by flax path: the port's
    label of each parameter is JAX's label of its leaf."""
    from xpretrain_tpu import optim as jax_optim

    _, params, port = pair
    want = jax_optim.param_group_labels(params, no_decay_patterns=jax_optim.NO_DECAY_LFVILA)
    paths = flax_param_paths(port)
    got = opt.param_group_labels(dict(port.named_parameters()), no_decay_patterns=opt.NO_DECAY_LFVILA, paths=paths)
    assert opt.NO_DECAY_LFVILA == jax_optim.NO_DECAY_LFVILA
    for name, label in got.items():
        node = want
        for key in paths[name].split("/"):
            node = node[key]
        assert label == node, name
    assert got["video_encoder.layers_0_blocks_0.attn.relative_position_bias_table"] == "base_no_decay"
    assert got["video_encoder.layers_0_blocks_0.attn.qkv.weight"] == "base_decay"


def _as_dict(config) -> dict:
    """A config dataclass as a dict, dtypes by name (torch and jnp differ)."""
    out = {}
    for field in dataclasses.fields(config):
        value = getattr(config, field.name)
        if dataclasses.is_dataclass(value):
            value = _as_dict(value)
        elif field.name == "dtype":
            value = str(value).removeprefix("torch.") if isinstance(value, torch.dtype) else np.dtype(value).name
        out[field.name] = value
    return out


def _load(path):
    from xpretrain_tpu.config import load_config_file

    return load_config_file(path)


@pytest.mark.parametrize("source", ["yaml_preset", "tiny", "base_fp32", "stage2_yaml_preset", "remat_policy"])
def test_config_builder_matches_jax(source):
    """For a config without the kernel keys the port builds the JAX config;
    the kernel keys are the one difference, and only the port reads them."""
    from xpretrain_tpu.cli.run_pretrain_lfvila import lfvila_config_from as jax_config_from

    cfg = {"yaml_preset": lambda: _load(YAML_PRESET),
           "stage2_yaml_preset": lambda: _load(YAML_PRESET.replace("stage1", "stage2")),
           "remat_policy": lambda: {"gradient_checkpointing": 1, "remat_policy": "dots_saveable", "cp": 1},
           "tiny": lambda: json.loads(json.dumps(TINY_CONFIG)),
           "base_fp32": lambda: {"bert": "base", "bf16": 0, "attention_window": 16,
                                 "training": {"temp": 0.07}}}[source]()
    cfg["video_encoder"] = {k: v for k, v in cfg.get("video_encoder", {}).items() if "pallas" not in k}
    want = _as_dict(jax_config_from(cfg))
    assert _as_dict(run_tasks_lfvila.lfvila_config_from(cfg)) == want
    cfg["video_encoder"].update(use_pallas_attention=True, pallas_min_window=100)
    got = run_tasks_lfvila.lfvila_config_from(cfg)
    assert (got.video.use_pallas_attention, got.video.pallas_min_window) == (True, 100)
    assert _as_dict(dataclasses.replace(got, video=dataclasses.replace(
        got.video, use_pallas_attention=False, pallas_min_window=240))) == want


def test_json_preset_is_the_yaml_preset_with_the_kernel_on():
    """The card's machine has no PyYAML: ``chip_smoke.py`` reads this JSON
    copy of the stage-1 preset, which must hold the YAML's values."""
    with open(JSON_PRESET) as f:
        preset = json.load(f)
    assert preset["video_encoder"].pop("use_pallas_attention") is True
    assert preset == json.loads(json.dumps(dict(_load(YAML_PRESET))))


def _runner_args(tmp_path, steps, *extra):
    config = tmp_path / "tiny.json"
    config.write_text(json.dumps(TINY_CONFIG))
    return ["--config", str(config), "--task", "retrieval", "--dummy_data", "1", "--input_hw", "96", "160",
            "--num_train_steps", str(steps), "--train_batch_size", "4", "--val_batch_size", "8",
            "--log_steps", "1", "--bf16", "0", "--device", "cpu", "--output_dir", str(tmp_path / "out"),
            *extra]


@pytest.mark.parametrize("steps", [0, 2])
def test_runner_writes_a_finite_final_report(tmp_path, monkeypatch, steps):
    """0 steps goes straight to the eval and never evaluates the schedule
    (whose step count is 0); 2 steps train first, then evaluate."""
    from xpretrain_tpu_torch.train import generic_trainer

    schedule_calls, get_schedule = [], generic_trainer.get_schedule

    def recording_schedule(*args, **kwargs):
        schedule = get_schedule(*args, **kwargs)
        return lambda step: schedule_calls.append(step) or schedule(step)

    monkeypatch.setattr(generic_trainer, "get_schedule", recording_schedule)
    report = run_tasks_lfvila.main(_runner_args(tmp_path, steps, "--save_steps", "2"))
    out = tmp_path / "out"
    with open(out / "final_report.json") as f:
        assert json.load(f) == json.loads(json.dumps(report))
    for direction in ("t2v", "v2t"):
        assert all(np.isfinite(report[direction][k]) and 0 <= report[direction][k] <= 100
                   for k in ("R1", "R5", "R10"))
    assert report["score"] == report["t2v"]["R1"]
    rows = [json.loads(line) for line in open(out / "log" / "scalars.jsonl")] if steps else []
    losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
    assert len(losses) == steps and all(np.isfinite(losses))
    assert bool(schedule_calls) == bool(steps)
    assert sorted(os.listdir(out / "ckpt")) == ([f"{steps}.pt"] if steps else [])


@pytest.mark.parametrize(
    "extra,error,match",
    [(["--task", "qa_mc", "--model_weight", "lfvila.pt"], FileNotFoundError, "lfvila.pt"),
     (["--task", "qa_cls", "--model_weight", "lfvila.pt"], FileNotFoundError, "lfvila.pt"),
     (["--task", "video_cls", "--model_weight", "lfvila.pt"], FileNotFoundError, "lfvila.pt"),
     (["--model_weight", "lfvila.pt"], FileNotFoundError, "lfvila.pt"),
     (["--gradient_checkpointing", "1", "--cp", "2"], NotImplementedError, "ROADMAP"),
     (["--cp", "2"], NotImplementedError, "ROADMAP")],
    ids=["qa_mc", "qa_cls", "video_cls", "model_weight", "remat", "context_parallel"],
)
def test_runner_raises_on_what_is_not_ported(tmp_path, extra, error, match):
    """Context parallelism, with or without remat, raises; the tasks and remat
    themselves run (``tests/test_torch_lfvila_tasks.py``,
    ``tests/test_torch_lfvila_pretrain.py``). ``--model_weight`` loads a torch
    checkpoint for every task (``tests/test_torch_pretrained_loading.py``):
    one that is not there raises instead of leaving the random init."""
    with pytest.raises(error, match=match):
        run_tasks_lfvila.main(_runner_args(tmp_path, 0, *extra))


def _fake_launch(q, k, v, bias, mask, out):
    out.copy_(wa.window_attention_plain(q, k, v, bias, mask))


def test_kernel_path_serves_and_refuses_to_train(pair, monkeypatch):
    """The model with the window attention routed through the CUDA branch
    (the launch replaced by the plain version, on CPU tensors): a forward
    without gradients counts one launch per gated block and gives the plain
    result; a train step raises, naming ROADMAP, instead of training on a
    plain path."""
    _, _, port = pair
    monkeypatch.setattr(swin3d, "window_attention", wa._launch)
    monkeypatch.setattr(wa._kernels, "window_attention_fwd", _fake_launch)
    monkeypatch.setattr(wa.window_attention, "launches", 0)
    video, ids, mask = (torch.from_numpy(a) for a in _inputs())
    with torch.no_grad():
        got = port.forward_video(video)
    assert wa.window_attention.launches == WINDOW_BLOCKS
    monkeypatch.setattr(swin3d, "window_attention", wa.window_attention)
    with torch.no_grad():
        torch.testing.assert_close(got, port.forward_video(video), atol=0, rtol=0)

    monkeypatch.setattr(swin3d, "window_attention", wa._launch)
    model = LfVilaRetrieval(_tiny_port_config())
    model.load_state_dict(port.state_dict())
    optimizer, _ = opt.build_optimizer(dict(model.named_parameters()), lambda step: 1e-4,
                                       no_decay_patterns=opt.NO_DECAY_LFVILA, paths=flax_param_paths(model))
    from xpretrain_tpu_torch.parallel.train_step import TrainState

    step = make_model_train_step(lambda m, b, g: m(b["v"], b["ids"], b["mask"], generator=g), "cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        step(TrainState(step=0, model=model, optimizer=optimizer), {"v": video, "ids": ids, "mask": mask}, 0)


def test_runner_loads_no_jax(tmp_path):
    """The LF-VILA runner, 0 steps, in a fresh process: nothing of JAX is
    loaded (the card's machine has none)."""
    code = (
        "import sys\n"
        "from xpretrain_tpu_torch.cli.run_tasks_lfvila import main\n"
        f"main({_runner_args(tmp_path, 0)!r})\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_port_sources_import_no_jax():
    """No module of the port, nor ``chip_smoke.py``, imports JAX, flax, optax
    or orbax, at any level (the card's machine has none of them)."""
    import ast
    import glob

    sources = glob.glob(os.path.join(REPO, "xpretrain_tpu_torch", "**", "*.py"), recursive=True)
    sources.append(os.path.join(REPO, "chip_smoke.py"))
    found = []
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            found += [(os.path.relpath(path, REPO), n) for n in names if n.split(".")[0] in FORBIDDEN]
    assert len(sources) > 30 and found == []
