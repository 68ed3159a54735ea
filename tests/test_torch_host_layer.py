"""The port's own host layer (``xpretrain_tpu_torch/{config,cli/shared_args,
data,utils,train/evaluate}.py``): the port imports nothing of the JAX
package, and its copies give the JAX package's batches, token ids, reports
and parsed configs.

1. A scan of every source of the port and of ``chip_smoke.py``: no import of
   ``xpretrain_tpu``, ``jax`` or ``flax``, and no path under
   ``xpretrain_tpu/`` that a program could read; no import of ``cv2`` or
   ``safetensors`` (the card's machine has neither) outside the three
   host-layer copies that read images and videos with cv2 where it exists
   (``CV2_HOST_LAYER``).
2. A fresh process in which importing those three raises: it imports every
   module of the port and runs both CPU runners; another, in which cv2 and
   safetensors cannot be imported either, runs the pretraining runner from a
   checkpoint.
3. The copies against the JAX originals, same seeds, fp32 on the CPU.
"""

import ast
import glob
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu import config as jax_config  # noqa: E402
from xpretrain_tpu.cli import shared_args as jax_shared_args  # noqa: E402
from xpretrain_tpu.data import datasets as jax_datasets  # noqa: E402
from xpretrain_tpu.data import datasets_lfvila as jax_datasets_lfvila  # noqa: E402
from xpretrain_tpu.data import datasets_lfvila_tasks as jax_datasets_lfvila_tasks  # noqa: E402
from xpretrain_tpu.data import loader as jax_loader  # noqa: E402
from xpretrain_tpu.data import sample_frames as jax_sample_frames  # noqa: E402
from xpretrain_tpu.data import tokenization as jax_tokenization  # noqa: E402
from xpretrain_tpu.data import transforms as jax_transforms  # noqa: E402
from xpretrain_tpu.data import video_reader as jax_video_reader  # noqa: E402
from xpretrain_tpu.train import evaluate as jax_evaluate  # noqa: E402
from xpretrain_tpu.utils import metrics as jax_metrics  # noqa: E402
from xpretrain_tpu_torch import config  # noqa: E402
from xpretrain_tpu_torch.cli import (  # noqa: E402
    run_pretrain_lfvila,
    run_retrieval_clipvip,
    run_tasks_lfvila,
    shared_args,
)
from xpretrain_tpu_torch.data import (  # noqa: E402
    datasets,
    datasets_lfvila,
    datasets_lfvila_tasks,
    loader,
    sample_frames,
    tokenization,
    transforms,
    video_reader,
)
from xpretrain_tpu_torch.train import evaluate  # noqa: E402
from xpretrain_tpu_torch.utils import metrics  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("xpretrain_tpu", "jax", "flax")
NOT_ON_THE_CARD = ("cv2", "safetensors")  # absent on the card's machine
# the host-layer copies that decode and resize frames with cv2 where it is
# installed, as their JAX originals do (ROADMAP Queue 3: the resize without it)
CV2_HOST_LAYER = ("xpretrain_tpu_torch/data/datasets.py", "xpretrain_tpu_torch/data/transforms.py",
                  "xpretrain_tpu_torch/data/video_reader.py")
SOURCES = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "xpretrain_tpu_torch", "**", "*.py"), recursive=True)
) + ["chip_smoke.py"]
PRESETS = sorted(glob.glob(os.path.join(REPO, "xpretrain_tpu", "configs", "presets", "*.json")))
# a path into the JAX package, as opposed to a "file.py:line" reference to it
_JAX_PATH = re.compile(r"(?<![\w.])xpretrain_tpu/")
_FILE_LINE = re.compile(r"xpretrain_tpu/\S*\.py:\d+")


def _docstrings(tree: ast.AST) -> set[int]:
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(first.value, ast.Constant):
                ids.add(id(first.value))
    return ids


# -- 1. the sources ----------------------------------------------------------


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_and_reads_nothing_of_jax(source):
    with open(os.path.join(REPO, source)) as f:
        tree = ast.parse(f.read())
    docs = _docstrings(tree)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if a.name.split(".")[0] in BANNED]
        elif isinstance(node, ast.ImportFrom) and (node.module or "").split(".")[0] in BANNED:
            found.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "import_module", "__import__", "importorskip"
        ):
            found += [a.value for a in node.args if isinstance(a, ast.Constant)
                      and str(a.value).split(".")[0] in BANNED]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) and id(node) not in docs:
            text = node.value
            if node.value == "xpretrain_tpu" or (_JAX_PATH.search(text) and not _FILE_LINE.search(text)):
                found.append(f"path {text!r}")
    assert found == [], f"{source}: {found}"


def test_every_port_module_is_scanned():
    assert len(SOURCES) > 40 and "xpretrain_tpu_torch/train/evaluate.py" in SOURCES


def _imported_modules(tree: ast.AST) -> list[str]:
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "id", getattr(node.func, "attr", "")) in (
            "import_module", "__import__", "importorskip"
        ):
            names += [str(a.value) for a in node.args if isinstance(a, ast.Constant)]
    return names


@pytest.mark.parametrize("source", SOURCES)
def test_source_imports_nothing_the_card_lacks(source):
    """No cv2 and no safetensors: the checkpoint readers read safetensors
    themselves, the Swin inflation resizes with torch."""
    with open(os.path.join(REPO, source)) as f:
        found = [m for m in _imported_modules(ast.parse(f.read())) if m.split(".")[0] in NOT_ON_THE_CARD]
    if source in CV2_HOST_LAYER:
        found = [m for m in found if m != "cv2"]
    assert found == [], f"{source}: {found}"


# -- 2. a process in which the JAX package cannot be imported ----------------

_BLOCKER = f"""
import importlib.abc, sys

class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {BANNED!r}:
            raise ImportError("refused: " + name)
        return None

sys.meta_path.insert(0, _Refuse())
"""

LFVILA_TINY = {"video_encoder": {"embed_dim": 32, "depths": [1, 1, 2, 1, 1, 1],
                                 "num_heads": [2, 2, 4, 4, 4, 4], "use_pallas_attention": True},
               "bert": "tiny", "num_local_layers": 2, "stage1_layers": 4, "sample_frame": 8}


def test_port_runs_where_the_jax_package_cannot_be_imported(tmp_path):
    """Every module of the port imports, and both CPU runners train 2 steps
    and evaluate, in a process whose imports of ``xpretrain_tpu``, ``jax``
    and ``flax`` raise."""
    lfvila_cfg = tmp_path / "lfvila.json"
    lfvila_cfg.write_text(json.dumps(LFVILA_TINY))
    clipvip = ["--dummy_data", "1", "--clip_size", "tiny", "--num_frm", "2", "--crop_img_size", "32",
               "--train_batch_size", "8", "--val_batch_size", "16", "--num_train_steps", "2",
               "--valid_steps", "2", "--save_steps", "2", "--bf16", "0", "--device", "cpu",
               "--device_ingest", "1", "--output_dir", str(tmp_path / "clipvip")]
    lfvila = ["--config", str(lfvila_cfg), "--task", "retrieval", "--dummy_data", "1", "--input_hw", "96", "160",
              "--num_train_steps", "2", "--train_batch_size", "4", "--val_batch_size", "8", "--save_steps", "2",
              "--bf16", "0", "--device", "cpu", "--output_dir", str(tmp_path / "lfvila")]
    code = _BLOCKER + (
        "import pkgutil, xpretrain_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(xpretrain_tpu_torch.__path__, 'xpretrain_tpu_torch.')]\n"
        "for m in mods:\n"
        "    __import__(m)\n"
        "from xpretrain_tpu_torch.cli import run_retrieval_clipvip, run_tasks_lfvila\n"
        f"a = run_retrieval_clipvip.main({clipvip!r})\n"
        f"b = run_tasks_lfvila.main({lfvila!r})\n"
        "print(len(mods), a['t2v']['R1'], b['t2v']['R1'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r}))\n"
    )
    # One thread: beside the other test processes, a child whose thread pool
    # spans every core ran 30x slower than alone (over 300 s against 9 s).
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    n_modules, *recalls = lines[-2].split()
    assert int(n_modules) > 40 and all(0 <= float(r) <= 100 for r in recalls)
    for run in ("clipvip", "lfvila"):
        assert (tmp_path / run / "final_report.json").exists()


def test_training_runners_run_where_the_jax_package_cannot_be_imported(tmp_path):
    """Both pretraining stages (2 steps) and the three fine-tune tasks (1
    step, then the accuracy eval of 4 synthetic samples) in a process whose
    imports of ``xpretrain_tpu``, ``jax`` and ``flax`` raise."""
    tiny = dict(LFVILA_TINY, final_num_patches=1, video_encoder=dict(LFVILA_TINY["video_encoder"],
                                                                     use_pallas_attention=False))
    cfg = tmp_path / "lfvila.json"
    cfg.write_text(json.dumps(tiny))
    common = ["--config", str(cfg), "--dummy_data", "1", "--input_hw", "96", "160", "--train_batch_size", "4",
              "--max_txt_len", "8", "--bf16", "0", "--device", "cpu", "--save_steps", "100"]
    runs = [("run_pretrain_lfvila", ["--stage", str(st), "--num_train_steps", "2"], f"stage{st}") for st in (1, 2)]
    runs += [("run_tasks_lfvila", ["--task", task, "--num_train_steps", "1", "--val_batch_size", "4",
                                   "--max_num_subtitle", "2"], task) for task in ("qa_mc", "qa_cls", "video_cls")]
    code = _BLOCKER + "from xpretrain_tpu_torch.cli import run_pretrain_lfvila, run_tasks_lfvila\n"
    code += "run_tasks_lfvila.DUMMY_SIZE = 4\n"
    for module, args, out in runs:
        argv = common + args + ["--output_dir", str(tmp_path / out)]
        code += f"print({out!r}, {module}.main({argv!r}) is not None)\n"
    code += f"print(sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r}))\n"
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # as above
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    names = [out for _, _, out in runs]
    assert [line for line in lines if line.split(" ")[0] in names] == [f"{out} True" for out in names]
    for task in ("qa_mc", "qa_cls", "video_cls"):
        with open(tmp_path / task / "final_report.json") as f:
            assert json.load(f)["n"] == 4


def test_pretraining_runner_runs_without_jax_cv2_or_safetensors(tmp_path):
    """``run_pretrain_clipvip`` trains 2 steps from a ``--clip_weights`` file
    it wrote with the port, and ``run_pretrain_lfvila`` a step from a 2-D
    ``--swin_weight`` it inflates, in a process whose imports of
    ``xpretrain_tpu``, ``jax``, ``flax``, ``cv2`` and ``safetensors`` raise."""
    rng = np.random.default_rng(0)
    swin2d = {"patch_embed.proj.weight": rng.normal(size=(32, 3, 4, 4)), "norm.weight": rng.normal(size=256)}
    for i, (depth, heads) in enumerate(((1, 2), (1, 2), (4, 4), (1, 4))):
        for b in range(depth):
            swin2d[f"layers.{i}.blocks.{b}.attn.relative_position_bias_table"] = rng.normal(size=(169, heads))
            swin2d[f"layers.{i}.blocks.{b}.attn.qkv.weight"] = rng.normal(size=(96 * 2**i, 32 * 2**i))
    torch.save({"model": {k: torch.from_numpy(v.astype(np.float32)) for k, v in swin2d.items()}},
               str(tmp_path / "swin.pt"))
    tiny = dict(LFVILA_TINY, final_num_patches=1, video_encoder=dict(LFVILA_TINY["video_encoder"],
                                                                     use_pallas_attention=False))
    cfg = tmp_path / "lfvila.json"
    cfg.write_text(json.dumps(tiny))
    clipvip = ["--dummy_data", "1", "--clip_size", "tiny", "--num_frm", "2", "--crop_img_size", "32",
               "--train_batch_size", "4", "--num_train_steps", "2", "--log_steps", "1", "--bf16", "0",
               "--device", "cpu", "--clip_weights", str(tmp_path / "clip.pt"), "--output_dir", str(tmp_path / "vip")]
    lfvila = ["--config", str(cfg), "--dummy_data", "1", "--input_hw", "96", "160", "--train_batch_size", "2",
              "--max_txt_len", "8", "--bf16", "0", "--device", "cpu", "--save_steps", "100", "--stage", "1",
              "--num_train_steps", "1", "--swin_weight", str(tmp_path / "swin.pt"),
              "--output_dir", str(tmp_path / "lfvila")]
    refused = BANNED + NOT_ON_THE_CARD
    code = _BLOCKER.replace(repr(BANNED), repr(refused)) + (
        "import torch\n"
        "from xpretrain_tpu_torch.cli import run_pretrain_clipvip, run_pretrain_lfvila\n"
        "from xpretrain_tpu_torch.models.clip_vip.convert import torch_clip_state_dict\n"
        "from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel\n"
        "model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=32)).init_weights(torch.Generator().manual_seed(1))\n"
        f"torch.save({{'module.clipmodel.' + k: v for k, v in torch_clip_state_dict(model).items()}}, "
        f"{str(tmp_path / 'clip.pt')!r})\n"
        "seen, load = [], run_pretrain_lfvila.load_lfvila_cascade\n"
        "def record(model, **kw):\n"
        "    load(model, **kw)\n"
        "    seen.append(model.video_encoder.layers_2_blocks_1.attn.relative_position_bias_table.detach().clone())\n"
        "run_pretrain_lfvila.load_lfvila_cascade = record\n"
        f"a = run_pretrain_clipvip.main({clipvip!r})\n"
        f"b = run_pretrain_lfvila.main({lfvila!r})\n"
        "print(a.step, b.step, tuple(seen[0].shape), torch.equal(seen[0][:45], seen[0][45:90]))\n"
        f"print(sorted(m for m in sys.modules if m.split('.')[0] in {refused!r}))\n"
    )
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # as above
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    # stage 2's (8, 3, 5) window: its 5 x 9 spatial table inflated, tiled 15 times over time
    assert lines[-2:] == ["2 1 (675, 4) True", "[]"]
    with open(tmp_path / "vip" / "log" / "scalars.jsonl") as f:
        losses = [row["value"] for row in map(json.loads, f) if row["tag"] == "train/loss"]
    assert len(losses) == 2 and all(np.isfinite(losses))


# -- 3. the copies hold against the JAX originals ----------------------------


def _assert_batches_equal(got, want, keys=None):
    keys = sorted(got) if keys is None else keys
    for key in keys:
        assert np.asarray(got[key]).dtype == np.asarray(want[key]).dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _parse(module, cfg_module, argv):
    return cfg_module.parse_with_config(module.build_shared_parser("x"), argv)


def test_shared_parser_has_the_jax_flags():
    def surface(parser):
        return [(a.dest, a.default, a.choices, a.type, a.nargs, a.required) for a in parser._actions]

    assert surface(shared_args.build_shared_parser()) == surface(jax_shared_args.build_shared_parser())


@pytest.mark.parametrize("preset", [os.path.basename(p) for p in PRESETS])
def test_presets_parse_the_same(preset):
    argv = ["--config", os.path.join(REPO, "xpretrain_tpu", "configs", "presets", preset),
            "--seed", "7", "--bf16", "0", "--betas", "0.8", "0.9"]
    got = _parse(shared_args, config, argv)
    want = _parse(jax_shared_args, jax_config, argv)
    assert isinstance(got, config.ConfigDict) and got.to_dict() == want.to_dict()
    assert got.seed == 7 and got.bf16 == 0 and got.betas == [0.8, 0.9]


def test_port_preset_copy_is_the_jax_preset():
    with open(os.path.join(REPO, "xpretrain_tpu_torch", "configs", "msrvtt_retrieval_vip_base_32.json")) as f:
        got = json.load(f)
    with open(os.path.join(REPO, "xpretrain_tpu", "configs", "presets", "msrvtt_retrieval_vip_base_32.json")) as f:
        assert got == json.load(f)


def test_pretrain_preset_copy_parses_like_the_jax_preset():
    """The port's JSON copy of the CLIP-ViP pretraining preset is the JAX
    preset, and parses to the same config through either package."""
    mine = os.path.join(REPO, "xpretrain_tpu_torch", "configs", "pretrain_vip_base_32.json")
    theirs = os.path.join(REPO, "xpretrain_tpu", "configs", "presets", "pretrain_vip_base_32.json")
    with open(mine) as f, open(theirs) as g:
        assert json.load(f) == json.load(g)
    got = _parse(shared_args, config, ["--config", mine, "--seed", "3"])
    want = _parse(jax_shared_args, jax_config, ["--config", theirs, "--seed", "3"])
    got.pop("config"), want.pop("config")  # the two files' paths
    assert got.to_dict() == want.to_dict() and got.loss_name == "NCELearnableTempLoss_vsc_fc"


def test_yaml_config_loads_the_same():
    pytest.importorskip("yaml")
    path = os.path.join(REPO, "xpretrain_tpu", "configs", "presets", "lfvila_pretrain_stage1.yaml")
    assert config.load_config_file(path).to_dict() == jax_config.load_config_file(path).to_dict()


def _clipvip_cfg(cfg_module, args_module, ingest):
    return _parse(args_module, cfg_module, [
        "--dummy_data", "1", "--num_frm", "3", "--crop_img_size", "40", "--train_batch_size", "4",
        "--val_batch_size", "5", "--seed", "3", "--device_ingest", ingest,
    ])


@pytest.mark.parametrize("ingest", ["0", "1"], ids=["fp32_frames", "u8_device_ingest"])
def test_clipvip_runner_batches_match_jax(ingest):
    """The port's runner loaders give the JAX runner's batches: train (two,
    across the shuffle) and validation (with its padded last batch)."""
    from xpretrain_tpu.cli import run_retrieval_clipvip as jax_runner

    got = run_retrieval_clipvip.build_loaders(_clipvip_cfg(config, shared_args, ingest))
    want = jax_runner.build_loaders(_clipvip_cfg(jax_config, jax_shared_args, ingest))
    assert got[2] == want[2] == run_retrieval_clipvip.DUMMY_VAL_SIZE
    for _ in range(2):
        _assert_batches_equal(next(got[0]), next(want[0]))
    val_got, val_want = list(got[1]), list(want[1])
    assert len(val_got) == len(val_want) == 26
    for g, w in zip(val_got[-2:], val_want[-2:]):
        _assert_batches_equal(g, w)


def test_lfvila_runner_batches_match_jax():
    from xpretrain_tpu.cli import run_tasks_lfvila as jax_runner

    argv = ["--dummy_data", "1", "--seed", "5", "--train_batch_size", "2", "--val_batch_size", "3"]
    extra = [("--sample_frame", 4), ("--sample_clip", 3), ("--input_hw", [32, 48]), ("--num_options", 4)]

    def cfg_of(args_module, cfg_module):
        parser = args_module.build_shared_parser("x")
        for flag, default in extra:
            parser.add_argument(flag, type=int, nargs=2 if isinstance(default, list) else None, default=default)
        return cfg_module.parse_with_config(parser, argv)

    cfg = cfg_of(shared_args, config)
    tok = tokenization.build_model_tokenizer("hash", 30522)
    train, val = run_tasks_lfvila.build_loaders(cfg, tok)
    jcfg = cfg_of(jax_shared_args, jax_config)
    jtok = jax_tokenization.build_model_tokenizer("hash", 30522)
    jcollate = jax_datasets_lfvila.LfVilaPretrainCollator(jtok, max_sent_len=int(jcfg.get("max_txt_len", 50)),
                                                          mlm=False)
    jtrain = jax_loader.InfiniteIterator(jax_loader.BatchLoader(jax_runner._synth_video_ds(jcfg), 2, jcollate, seed=5))
    jval = jax_loader.SequentialEvalLoader(jax_runner._synth_video_ds(jcfg), 3, jcollate)
    keys = ["video_frames", "text_ids", "attention_mask"]
    for _ in range(2):
        _assert_batches_equal(next(train), next(jtrain), keys)
    assert val.valid_len == jval.valid_len == run_tasks_lfvila.DUMMY_SIZE
    _assert_batches_equal(next(iter(val)), next(iter(jval)), keys)


@pytest.mark.parametrize("device_ingest", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_lfvila_dataset_and_mlm_collator_match_jax(train, device_ingest):
    def build(mod_ds, mod_tok):
        ds = mod_ds.LfVilaPretrainDataset([{} for _ in range(4)], None, 4, 3, (32, 48), train=train, seed=2,
                                          synthetic=True, device_ingest=device_ingest)
        collate = mod_ds.LfVilaPretrainCollator(mod_tok.HashTokenizer(30522), max_sent_len=12, mlm=True, seed=9)
        return [collate([ds[i], ds[i + 1]]) for i in (0, 2)]

    for g, w in zip(build(datasets_lfvila, tokenization), build(jax_datasets_lfvila, jax_tokenization)):
        _assert_batches_equal(g, w)


def test_merge_sentences_matches_jax():
    sents = ["a b", "c", "d e f", "g", "h i"]
    for total in (2, 3, 7):
        assert datasets_lfvila.merge_sentences_greedy(sents, total) == \
            jax_datasets_lfvila.merge_sentences_greedy(sents, total)


def _write_tokenizer_assets(tmp_path):
    byte_chars = list(jax_tokenization.bytes_to_unicode().values())
    merges = [("t", "h"), ("th", "e</w>"), ("a", "n"), ("an", "d</w>")]
    vocab = byte_chars + [c + "</w>" for c in byte_chars] + ["".join(m) for m in merges]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tmp_path / "vocab.json").write_text(json.dumps({tok: i for i, tok in enumerate(vocab)}))
    (tmp_path / "merges.txt").write_text("#version: 0.2\n" + "\n".join(" ".join(m) for m in merges) + "\n")
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "cat", "##s", "run", "##ning", "a", "."]
    (tmp_path / "vocab.txt").write_text("\n".join(words) + "\n")


@pytest.mark.parametrize("kind", ["hash", "hash_bert_vocab", "clip_bpe", "wordpiece"])
def test_tokenizer_ids_match_jax(tmp_path, kind):
    _write_tokenizer_assets(tmp_path)
    kwargs = {"hash": {}, "hash_bert_vocab": {"vocab_size": 30522},
              "clip_bpe": {"vocab_path": str(tmp_path / "vocab.json"), "merges_path": str(tmp_path / "merges.txt")},
              "wordpiece": {"vocab_path": str(tmp_path / "vocab.txt")}}[kind]
    name = kind.split("_bert")[0]
    texts = ["The cats and the dog", "a man running.", "ÉTÉ — naïve café 3 dogs", "", "the " * 40]
    got = tokenization.build_tokenizer(name, **kwargs)(texts, 16)
    want = jax_tokenization.build_tokenizer(name, **kwargs)(texts, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    masked = tokenization.mask_batch_text_tokens(got[0], 1, 30522, rng_a, special_ids=(0,))
    jmasked = jax_tokenization.mask_batch_text_tokens(want[0], 1, 30522, rng_b, special_ids=(0,))
    for g, w in zip(masked, jmasked):
        np.testing.assert_array_equal(g, w)


def test_model_tokenizer_clamps_like_jax():
    assert tokenization.build_model_tokenizer("hash", 30522).vocab_size == \
        jax_tokenization.build_model_tokenizer("hash", 30522).vocab_size == 30522


def test_transforms_and_samplers_match_jax():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 50, 70, 3), dtype=np.uint8)
    for train in (False, True):
        np.testing.assert_array_equal(
            transforms.clip_transform(frames, 32, train, np.random.default_rng(1)),
            jax_transforms.clip_transform(frames, 32, train, np.random.default_rng(1)))
        np.testing.assert_array_equal(
            transforms.clip_resize_crop_u8(frames, 32, train, np.random.default_rng(1)),
            jax_transforms.clip_resize_crop_u8(frames, 32, train, np.random.default_rng(1)))
    np.testing.assert_array_equal(
        transforms.normalize(frames, transforms.IMAGENET_MEAN, transforms.IMAGENET_STD),
        jax_transforms.normalize(frames, jax_transforms.IMAGENET_MEAN, jax_transforms.IMAGENET_STD))
    for name in ("CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD"):
        np.testing.assert_array_equal(getattr(transforms, name), getattr(jax_transforms, name))
    for test_mode in (False, True):
        np.testing.assert_array_equal(
            sample_frames.uniform_sample_with_jitter(97, 12, np.random.default_rng(2), test_mode),
            jax_sample_frames.uniform_sample_with_jitter(97, 12, np.random.default_rng(2), test_mode))
        for g, w in zip(sample_frames.multi_clip_sample([40, 7, 90], 32, np.random.default_rng(3), test_mode),
                        jax_sample_frames.multi_clip_sample([40, 7, 90], 32, np.random.default_rng(3), test_mode)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("interpolation", ["bilinear", "bicubic"])
def test_resize_without_cv2_stays_within_one_of_cv2(monkeypatch, interpolation):
    """Where cv2 is not installed (the card's machine) the port resizes with
    ``F.interpolate``: within 1 of cv2's uint8 result (cv2 rounds 11-bit
    fixed-point weights), down and up; the JAX copy's fallback, nearest
    neighbour, is further off."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(9)
    frames = rng.integers(0, 256, size=(2, 50, 70, 3), dtype=np.uint8)
    for size in ((32, 45), (61, 83), (35, 52)):
        want = transforms.resize(frames, size, interpolation).astype(np.int32)
        with monkeypatch.context() as m:
            m.setattr(transforms, "_HAS_CV2", False)
            m.setattr(jax_transforms, "_HAS_CV2", False)
            got = transforms.resize(frames, size, interpolation)
            nearest = jax_transforms.resize(frames, size, interpolation).astype(np.int32)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.abs(got.astype(np.int32) - want).max() <= 1, size
        assert np.abs(nearest - want).max() > 1, size


@pytest.mark.parametrize("num_workers", [0, 2])
def test_loaders_match_jax(num_workers):
    data = list(range(23))

    def collate(items):
        return np.asarray(items)

    def run(mod):
        batches = mod.BatchLoader(data, 4, collate, seed=1, num_workers=num_workers)
        endless = mod.InfiniteIterator(batches)
        train = [next(endless) for _ in range(12)]  # crosses two epoch boundaries
        val = list(mod.SequentialEvalLoader(data, 5, collate))
        return train + val

    for g, w in zip(run(loader), run(jax_loader)):
        np.testing.assert_array_equal(g, w)


def test_video_reader_finds_the_same_native_library():
    assert os.path.samefile(os.path.dirname(os.path.abspath(video_reader._LIB_PATHS[0])),
                            os.path.dirname(os.path.abspath(jax_video_reader._LIB_PATHS[0])))


def test_frame_source_reads_npy_clips_like_jax(tmp_path):
    rng = np.random.default_rng(6)
    np.save(tmp_path / "clip0.npy", rng.integers(0, 256, size=(9, 8, 10, 3), dtype=np.uint8))
    rows = [{"clip_id": "clip0", "text": ["a cat", "runs"]}]
    (tmp_path / "ann.jsonl").write_text(json.dumps(rows[0]) + "\n")
    for ingest in (False, True):
        got = datasets.VideoRetrievalDataset(str(tmp_path / "ann.jsonl"), datasets.FrameSource(str(tmp_path)),
                                             4, 8, train=True, seed=1, device_ingest=ingest)[0]
        want = jax_datasets.VideoRetrievalDataset(str(tmp_path / "ann.jsonl"), jax_datasets.FrameSource(str(tmp_path)),
                                                  4, 8, train=True, seed=1, device_ingest=ingest)[0]
        assert got["text"] == want["text"] == "a cat runs"
        np.testing.assert_array_equal(got["video"], want["video"])


def test_evaluate_retrieval_report_matches_jax(tmp_path):
    """The same features and ids give the same R@K report (``perf`` aside)
    and the same saved features."""
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(2, 22, 16)).astype(np.float32)
    batches = [{"ids": np.arange(b * 8, min(b * 8 + 8, 22)), "index": np.arange(b * 8, min(b * 8 + 8, 22))}
               for b in range(3)]

    def eval_step(params, batch):
        return {"vis_features": params[0][batch["index"]], "text_features": params[1][batch["index"]]}

    got = evaluate.evaluate_retrieval(eval_step, feats, batches, 20, save_feats_path=str(tmp_path / "a.npz"))
    want = jax_evaluate.evaluate_retrieval(eval_step, feats, batches, 20, save_feats_path=str(tmp_path / "b.npz"))
    got.pop("perf"), want.pop("perf")
    assert got == want
    a, b = np.load(tmp_path / "a.npz"), np.load(tmp_path / "b.npz")
    assert sorted(a.files) == sorted(b.files) == ["ids", "text_features", "vis_features"]
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key])
    sim = rng.normal(size=(9, 7))
    assert metrics.retrieval_report(sim) == jax_metrics.retrieval_report(sim)


def test_span_sampler_matches_jax():
    for total, n in ((97, 12), (12, 12), (5, 8), (1, 4), (300, 32)):
        for test_mode in (False, True):
            np.testing.assert_array_equal(
                sample_frames.span_jitter_linspace_sample(total, n, np.random.default_rng(total), test_mode),
                jax_sample_frames.span_jitter_linspace_sample(total, n, np.random.default_rng(total), test_mode))


TASK_DATASETS = {  # name -> (dataset, collator kwargs, dataset kwargs, a jsonl row without the clip id)
    "how2qa": ("How2QA", dict(max_sent_len=10, max_num_subtitle=3), dict(max_num_subtitle=3),
               {"span": [1.0, 3.5], "text_q": "what is the cat doing", "text_a": ["a", "b c", "d", "e f g"],
                "text_s": [{"text": f"subtitle {i} words", "start": i, "end": i + 1} for i in range(5)],
                "answer_idx": 2}),
    "how2qa_nan_span": ("How2QA", dict(max_sent_len=10, max_num_subtitle=3), dict(max_num_subtitle=3),
                        {"span": [float("nan"), float("nan")], "text_q": "q", "text_a": ["a", "b", "c", "d"],
                         "text_s": [], "answer_idx": 0}),
    "violin": ("Violin", dict(max_sent_len=9, max_num_subtitle=2), dict(max_num_subtitle=2),
               {"text_q": "the man opens the door", "text_s": [{"text": "hello there"}, {"text": "go"},
                                                               {"text": "now then"}], "answer": 1}),
    "actnet": ("ActnetQA", dict(max_sent_len=8), dict(num_labels=11), {"question": "is it raining", "answer": 4}),
    "video_cls": ("VideoCls", {}, dict(num_labels=9), {"recipe_type": 6}),
}


def _task_batches(mod_ds, mod_tok, name, rows, source, train):
    ds_name, collate_kw, ds_kw, _ = TASK_DATASETS[name]
    ds = getattr(mod_ds, f"{ds_name}Dataset")(rows, source, sample_frame=4, input_hw=(32, 48), train=train, seed=3,
                                              synthetic=source is None, **ds_kw)
    tok = (mod_tok.HashTokenizer(30522),) if ds_name != "VideoCls" else ()
    collate = getattr(mod_ds, f"{ds_name}Collator")(*tok, **collate_kw)
    return [collate([ds[i], ds[i + 1]]) for i in range(0, len(rows), 2)]


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", sorted(TASK_DATASETS))
def test_task_datasets_and_collators_match_jax(tmp_path, name, train):
    """The copies of ``datasets_lfvila_tasks`` give the JAX package's batches:
    synthetic rows, and jsonl rows over .npy clips (the jittered linspace at
    train time, subtitles merged down and padded with zero rows)."""
    rng = np.random.default_rng(7)
    for i in range(2):
        np.save(tmp_path / f"v{i}.npy", rng.integers(0, 256, size=(13 + 5 * i, 40, 56, 3), dtype=np.uint8))
    row = TASK_DATASETS[name][3]
    id_key = {"actnet": "video_name", "video_cls": "video_id"}.get(name, "clip_id")
    rows = [dict(row, **{id_key: f"v{i}"}) for i in range(2)]
    for rows_, root in (([{} for _ in range(4)], None), (rows, str(tmp_path))):
        got = _task_batches(datasets_lfvila_tasks, tokenization, name, rows_, root and datasets.FrameSource(root),
                            train)
        want = _task_batches(jax_datasets_lfvila_tasks, jax_tokenization, name, rows_,
                             root and jax_datasets.FrameSource(root), train)
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            _assert_batches_equal(g, w)


@pytest.mark.parametrize("task", ["qa_mc", "qa_cls", "qa_cls_violin", "video_cls"])
def test_lfvila_task_runner_batches_match_jax(task):
    """The port runner's task datasets and collators (with the labels the JAX
    runner's ``collate_with_labels`` adds) give the JAX runner's batches."""
    from xpretrain_tpu.cli import run_tasks_lfvila as jax_runner

    argv = ["--dummy_data", "1", "--seed", "5", "--task", task.split("_violin")[0], "--max_num_subtitle", "2",
            "--qa_dataset", "violin" if task.endswith("violin") else "", "--num_labels", "6"]
    extra = [("--sample_frame", 4), ("--sample_clip", 3), ("--input_hw", [32, 48]), ("--num_options", 4)]

    def cfg_of(args_module, cfg_module):
        parser = args_module.build_shared_parser("x")
        for flag, default in extra:
            parser.add_argument(flag, type=int, nargs=2 if isinstance(default, list) else None, default=default)
        for flag in ("--task", "--qa_dataset"):
            parser.add_argument(flag, type=str, default="")
        for flag in ("--max_num_subtitle", "--num_labels"):
            parser.add_argument(flag, type=int, default=0)
        return cfg_module.parse_with_config(parser, argv)

    cfg = cfg_of(shared_args, config)
    tok = tokenization.build_model_tokenizer("hash", 30522)
    _, collate, train, val, keys = run_tasks_lfvila.build_task(cfg, run_pretrain_lfvila.lfvila_config_from(
        {"bert": "tiny", "video_encoder": {"embed_dim": 32, "depths": [1] * 6, "num_heads": [2] * 6}}), tok, "cpu")
    collate = run_tasks_lfvila.with_labels(collate)
    jcfg = cfg_of(jax_shared_args, jax_config)
    jtok = jax_tokenization.build_model_tokenizer("hash", 30522)
    ds_cls, jcollate = {
        "qa_mc": (jax_datasets_lfvila_tasks.How2QADataset, jax_datasets_lfvila_tasks.How2QACollator(jtok, 70, 2)),
        "qa_cls": (jax_datasets_lfvila_tasks.ActnetQADataset, jax_datasets_lfvila_tasks.ActnetQACollator(jtok, 70)),
        "qa_cls_violin": (jax_datasets_lfvila_tasks.ViolinDataset,
                          jax_datasets_lfvila_tasks.ViolinCollator(jtok, 70, 2)),
        "video_cls": (jax_datasets_lfvila_tasks.VideoClsDataset, jax_datasets_lfvila_tasks.VideoClsCollator()),
    }[task]
    extra_kw = {"qa_mc": dict(max_num_subtitle=2), "qa_cls_violin": dict(max_num_subtitle=2)}.get(
        task, dict(num_labels=6))
    jtrain, jval = jax_runner._task_datasets(jcfg, ds_cls, **extra_kw)
    assert len(train) == len(jtrain) == len(val) == len(jval) == run_tasks_lfvila.DUMMY_SIZE
    for i in (0, 7):
        for got_ds, want_ds in ((train, jtrain), (val, jval)):
            g, w = collate([got_ds[i], got_ds[i + 1]]), jcollate([want_ds[i], want_ds[i + 1]])
            assert sorted(g) == sorted(w) and set(keys) <= set(g)
            _assert_batches_equal(g, w)


def _pretrain_items(n, with_image=True):
    rng = np.random.default_rng(2)
    items = []
    for i in range(n):
        item = {"video": rng.normal(size=(2, 3, 8, 8)), "text": f"a cat {i} runs " * (i + 1)}
        if i % 2:
            item["frames_transformed"] = rng.normal(size=(2, 3, 8, 8)).astype(np.float16)
        if with_image:
            item["image"] = rng.normal(size=(1, 3, 8, 8))
            item["caption"] = "the dog" if i % 2 else ""
        items.append(item)
    return items


@pytest.mark.parametrize("with_image", [False, True])
@pytest.mark.parametrize("mlm", [False, True])
def test_pretrain_collator_copy_matches_jax(with_image, mlm):
    """``PretrainCollator``: the fp32 cast of video and image (from fp64 and
    fp16), ``frames_transformed`` over ``video``, the [B, 1, L] captions and
    the MLM draw of a seeded generator across calls."""
    def run(ds_mod, tok_mod):
        collate = ds_mod.PretrainCollator(tok_mod.HashTokenizer(30522), max_txt_len=9, mlm=mlm, mlm_prob=0.4,
                                          seed=5)
        items = _pretrain_items(5, with_image)
        return [collate(items[:3]), collate(items[2:])]

    for g, w in zip(run(datasets, tokenization), run(jax_datasets, jax_tokenization)):
        assert sorted(g) == sorted(w)
        _assert_batches_equal(g, w)
        assert ("caption_ids" in g) == with_image and ("mlm_labels" in g) == mlm


def test_meta_loader_copy_matches_jax():
    """``MetaLoader`` over a plain loader and an ``InfiniteIterator``: the
    seeded task draws and the batches, across epochs; no loader raises."""
    def run(mod):
        meta = mod.MetaLoader({"x": ([np.arange(2), np.arange(3)], 1),
                               "y": (mod.InfiniteIterator(mod.BatchLoader(list(range(7)), 3, np.asarray, seed=2)), 4)},
                              seed=6)
        return [next(meta) for _ in range(30)]

    got, want = run(loader), run(jax_loader)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for mod in (loader, jax_loader):
        with pytest.raises(ValueError, match="empty"):
            mod.MetaLoader({})


@pytest.mark.parametrize("kind,path", [("hash", "w.pt"), ("hash", ""), ("wordpiece", "w.pt")])
def test_hash_tokenizer_warning_matches_jax(caplog, kind, path):
    """``warn_if_hash_with_weights`` warns exactly when the hash tokenizer
    meets a weights file, with the JAX package's message."""
    messages = []
    for mod in (tokenization, jax_tokenization):
        caplog.clear()
        with caplog.at_level("WARNING"):
            mod.warn_if_hash_with_weights(kind, path, vocab_name="CLIP BPE", hint="--tokenizer clip_bpe")
        messages.append([r.getMessage() for r in caplog.records if r.levelname == "WARNING"])
    assert messages[0] == messages[1]
    assert len(messages[0]) == (kind == "hash" and bool(path))
