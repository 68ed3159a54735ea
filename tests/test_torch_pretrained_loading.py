"""Port parity, pretrained checkpoints: torch CLIP / CLIP-ViP checkpoints into
``CLIPViPModel`` (``models/clip_vip/convert.py:merge_pretrained``) and the
LF-VILA WEIGHTS cascade (``models/pretrained.py:load_lfvila_cascade``),
each against the JAX package's loaders on the same files, fp32 on the CPU.
The reference-keyed files are written by the JAX package's exporters
(``flax_to_torch_clip``, ``models/export.py``) from JAX inits, or by hand for
a 2-D ImageNet Swin.

Tolerances: every loaded parameter equals JAX's merged tree within 1e-6
(copies and transposes of the same fp32 numbers; the temporal embedding's
interpolation runs in float64 on both sides); the bias tables of a 2-D Swin
within 1e-5 (JAX resizes them with cv2's bicubic, the port with
``F.interpolate``'s, which agree to float rounding); features 2e-5
(PARITY.md's CLIP-ViP bar).
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_pretrain_clipvip, run_pretrain_lfvila, run_tasks_lfvila  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.convert import (  # noqa: E402
    load_jax_params,
    load_torch_checkpoint,
    merge_pretrained,
    read_safetensors,
    torch_clip_state_dict,
)
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila import convert as lf_convert  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig, LfVilaPretrain  # noqa: E402
from xpretrain_tpu_torch.models.pretrained import load_lfvila_cascade  # noqa: E402

IMAGE, SEQ, TEMPORAL = 32, 16, 12
TINY_KW = dict(sample_frame=8, final_num_patches=1)
RUNNER_CONFIG = {  # the tiny LF-VILA model through the runners
    "video_encoder": {"embed_dim": 32, "depths": [1, 1, 2, 1, 1, 1], "num_heads": [2, 2, 4, 4, 4, 4]},
    "bert": "tiny", "num_local_layers": 2, "stage1_layers": 4, "sample_frame": 8, "sample_clip": 4,
    "final_num_patches": 1,
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _noisy(params, seed):
    import jax

    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32),
                                  params)


def _save(sd, path, wrap=None, prefix=""):
    tensors = {prefix + k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
    torch.save(tensors if wrap is None else {wrap: tensors, "epoch": 3}, str(path))
    return str(path)


# -- CLIP / CLIP-ViP ------------------------------------------------------------


def _tokens(rng, b):
    ids = np.zeros((b, SEQ), np.int64)
    ids[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, SEQ - 1, size=b)):
        ids[i, 1:n] = rng.integers(10, 400, size=n - 1)
        ids[i, n] = 49407
    return ids, (ids > 0).astype(np.int64)


def _clip_port(params):
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(temporal_size=TEMPORAL)))
    return load_jax_params(model, {"params": params})


@pytest.fixture(scope="module")
def clip_jax():
    """(JAX model, a fresh init, a source init): two noisy inits of the tiny
    CLIP-ViP, the source to write checkpoints from."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig
    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel
    from xpretrain_tpu.models.clip_vip import VipConfig as JaxVip

    model = JaxModel(JaxConfig.tiny_debug(image_size=IMAGE, vip=JaxVip(temporal_size=TEMPORAL)))
    video = jnp.zeros((1, 2, IMAGE, IMAGE, 3), jnp.uint8)
    ids = jnp.zeros((1, SEQ), jnp.int32).at[:, 3].set(49407)
    init = jax.jit(model.init)
    fresh = _noisy(init(jax.random.PRNGKey(0), video, ids, ids > 0)["params"], 7)
    src = _noisy(init(jax.random.PRNGKey(1), video, ids, ids > 0)["params"], 8)
    return model, fresh, src


def _clip_checkpoint(src, path):
    """A released-style CLIP-ViP checkpoint of ``src``: keys under
    ``module.clipmodel.``, wrapped in ``state_dict`` beside a non-tensor
    entry, an 8-row temporal embedding, a position table of another length,
    a layer beyond the model's depth and HF's ``position_ids`` buffer."""
    from xpretrain_tpu.models.clip_vip.convert import flax_to_torch_clip

    rng = np.random.default_rng(9)
    sd = dict(flax_to_torch_clip({"params": src}))
    width = sd["vision_model.embeddings.class_embedding"].shape[-1]
    sd["vision_model.embeddings.temporal_embedding"] = rng.normal(size=(1, 8, width))
    sd["text_model.embeddings.position_embedding.weight"] = rng.normal(size=(60, width))
    sd["vision_model.encoder.layers.7.mlp.fc1.weight"] = rng.normal(size=(4, width))
    sd["text_model.embeddings.position_ids"] = np.arange(77)[None]
    return _save(sd, path, wrap="state_dict", prefix="module.clipmodel.")


def test_clip_checkpoint_merges_as_jax_merges_it(clip_jax, tmp_path):
    """Every parameter equals JAX's ``merge_pretrained`` tree: the temporal
    embedding interpolated 8 -> 12, the mismatched position table kept at
    init, the deeper layer skipped; the video and text features agree."""
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import convert as jax_convert

    model, fresh, src = clip_jax
    path = _clip_checkpoint(src, tmp_path / "clipvip.pt")
    converted = jax_convert.torch_clip_to_flax(jax_convert.load_torch_checkpoint(path), 2, 2, temporal_size=TEMPORAL)
    merged = jax_convert.merge_pretrained({"params": fresh}, converted)["params"]

    port = _clip_port(fresh)
    report = merge_pretrained(port, load_torch_checkpoint(path))
    assert report["kept"] == ["text_model.embeddings.position_embedding.weight"]
    assert report["unmapped"] == ["vision_model.encoder.layers.7.mlp.fc1.weight"] and not report["unexpected"]
    assert len(report["loaded"]) == len(dict(port.named_parameters())) - 1
    want = _clip_port(merged).state_dict()
    for name, value in port.state_dict().items():
        torch.testing.assert_close(value, want[name], atol=1e-6, rtol=0, msg=name)
    np.testing.assert_allclose(port.logit_scale.item(), float(np.asarray(src["logit_scale"])), rtol=1e-7)

    rng = np.random.default_rng(4)
    video = rng.integers(0, 256, size=(3, 2, IMAGE, IMAGE, 3), dtype=np.uint8)
    ids, mask = _tokens(rng, 3)
    got = port.eval()(*(torch.from_numpy(a) for a in (video, ids, mask)))
    out = model.apply({"params": merged}, *(jnp.asarray(a) for a in (video, ids, mask)))
    for key in ("vis_features", "text_features"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(out[key]), atol=2e-5, rtol=0, err_msg=key)


def test_clip_checkpoint_without_vip_extras_keeps_their_init(clip_jax, tmp_path):
    """A plain CLIP checkpoint has no ``added_cls`` and no temporal
    embedding: both keep the fresh init; its ``logit_scale`` (ln 100)
    replaces the preset's init."""
    _, fresh, src = clip_jax
    from xpretrain_tpu.models.clip_vip.convert import flax_to_torch_clip

    sd = {k: v for k, v in flax_to_torch_clip({"params": src}).items()
          if not k.endswith(("added_cls", "temporal_embedding"))}
    sd["logit_scale"] = np.asarray(np.log(100.0), np.float32)
    port = _clip_port(fresh)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    merge_pretrained(port, load_torch_checkpoint(_save(sd, tmp_path / "clip.pt")))
    for key in ("vision_model.embeddings.added_cls", "vision_model.embeddings.temporal_embedding"):
        torch.testing.assert_close(port.state_dict()[key], before[key], atol=0, rtol=0)
    assert abs(port.logit_scale.item() - np.log(100.0)) < 1e-6


def test_clip_checkpoint_key_the_model_lacks_is_skipped(tmp_path):
    """A mapped key the model does not hold (``added_cls`` of a model without
    extra proxies) is skipped as unexpected; everything else loads."""
    path, sd = _clip_weights_file(tmp_path / "clip.pt")
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(add_cls_num=0)))
    model.init_weights(torch.Generator().manual_seed(3))
    report = merge_pretrained(model, load_torch_checkpoint(path))
    assert report["unexpected"] == ["vision_model.embeddings.added_cls"] and not report["kept"]
    want = _clip_port_from_torch(sd)
    for name, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), want[name], atol=0, rtol=0, msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_safetensors_read_back(tmp_path, dtype):
    """The port's own reader of the format gives back what the safetensors
    package wrote, bf16 included (as fp32, exactly), with the keys as
    stored; fp32 files read as the JAX package reads them."""
    safetensors_torch = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {"module.clipmodel.logit_scale": torch.tensor(4.6), "a.weight": torch.randn(5, 3, generator=g),
               "b.bias": torch.randn(7, generator=g), "empty": torch.zeros(0, 4),
               "ids": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    tensors = {k: v.to(getattr(torch, dtype)) if v.is_floating_point() else v for k, v in tensors.items()}
    path = str(tmp_path / "w.safetensors")
    safetensors_torch.save_file(tensors, path, metadata={"format": "pt"})
    raw = read_safetensors(path)
    got = load_torch_checkpoint(path)
    assert sorted(raw) == sorted(got) == sorted(tensors)
    for key, want in tensors.items():
        assert raw[key].dtype == want.dtype and torch.equal(raw[key], want), key
        np.testing.assert_array_equal(got[key], (want.float() if want.is_floating_point() else want).numpy())
        assert got[key].dtype == (np.float32 if want.is_floating_point() else np.int64)
    if dtype == "float32":
        from xpretrain_tpu.models.clip_vip.convert import load_torch_checkpoint as jax_load

        want = jax_load(path)
        for key in tensors:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _clip_weights_file(path, seed=5):
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE))
    model.init_weights(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    sd = {k: v + 0.02 * torch.randn(v.shape, generator=g) for k, v in torch_clip_state_dict(model).items()}
    torch.save(sd, str(path))
    return str(path), sd


PRETRAIN = ["--dummy_data", "1", "--clip_size", "tiny", "--num_frm", "2", "--crop_img_size", "32",
            "--train_batch_size", "4", "--log_steps", "1", "--save_steps", "2", "--bf16", "0", "--device", "cpu"]


def test_resumed_run_keeps_its_checkpoint_over_clip_weights(tmp_path):
    """``--clip_weights`` loads over the seeded init before the first step,
    and a run that resumes keeps its checkpoint's weights over them."""
    path, sd = _clip_weights_file(tmp_path / "clip.pt")
    loaded = run_pretrain_clipvip.main(PRETRAIN + ["--num_train_steps", "0", "--clip_weights", path,
                                                   "--output_dir", str(tmp_path / "fresh")])
    merged = _clip_port_from_torch(sd)
    for name, p in loaded.model.named_parameters():
        torch.testing.assert_close(p.detach(), merged[name], atol=0, rtol=0, msg=name)

    out = str(tmp_path / "run")
    run_pretrain_clipvip.main(PRETRAIN + ["--num_train_steps", "2", "--output_dir", out])
    saved = torch.load(f"{out}/ckpt/2.pt", weights_only=False)["model"]
    resumed = run_pretrain_clipvip.main(PRETRAIN + ["--num_train_steps", "2", "--clip_weights", path,
                                                    "--output_dir", out])
    assert resumed.step == 2
    for name, value in resumed.model.state_dict().items():
        torch.testing.assert_close(value, saved[name], atol=0, rtol=0, msg=name)
        assert not torch.equal(value, merged[name]), name


def _clip_port_from_torch(sd):
    """What the port holds after merging a full torch state dict: the same
    numbers, the patch weight in the port's layout."""
    out = dict(sd)
    out["vision_model.embeddings.patch_embedding.weight"] = sd["vision_model.embeddings.patch_embedding.weight"].permute(2, 3, 1, 0)
    return out


# -- LF-VILA ------------------------------------------------------------------


@pytest.fixture(scope="module")
def lfvila_jax():
    """Per stage: (fresh init, source init) of the JAX package's tiny
    ``LfVilaPretrain``."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig
    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaPretrain as JaxPretrain

    rng = np.random.default_rng(0)
    video = jnp.asarray(rng.normal(size=(1, 3, 8, 96, 160)).astype(np.float32))
    ids = jnp.asarray(rng.integers(2, 1000, (1, 4, 8)).astype(np.int32))
    mask = jnp.ones((1, 4, 8), jnp.int32)
    inits = {}
    for stage in (1, 2):
        model = JaxPretrain(JaxConfig.tiny(stage=stage, **TINY_KW))
        kwargs = {"mtc_rng": jax.random.PRNGKey(1)} if stage == 1 else {"mlm_labels": jnp.full((1, 32), -100)}
        init = jax.jit(lambda key, m=model, kw=kwargs: m.init(key, video, ids, mask, **kw)["params"])
        inits[stage] = tuple(jax.tree_util.tree_map(np.asarray, init(jax.random.PRNGKey(s))) for s in (7, 1234))
    return inits


def _swin2d_state_dict(rng, embed_dim=32, depths=(1, 1, 4, 1), heads=(2, 2, 4, 4), window=7, patch=4):
    """An ImageNet-Swin-shaped 2-D state dict (4 stages, torch keys), the
    shape of ``tests/test_pretrained_loading.py``'s."""
    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32))

    sd = {"patch_embed.proj.weight": t(embed_dim, 3, patch, patch), "patch_embed.proj.bias": t(embed_dim),
          "norm.weight": t(embed_dim * 2 ** (len(depths) - 1)), "norm.bias": t(embed_dim * 2 ** (len(depths) - 1))}
    side = 2 * window - 1
    for i, (d, h) in enumerate(zip(depths, heads)):
        c = embed_dim * 2**i
        for b in range(d):
            p = f"layers.{i}.blocks.{b}."
            for name, shape in (("norm1.weight", (c,)), ("norm1.bias", (c,)), ("attn.qkv.weight", (3 * c, c)),
                                ("attn.qkv.bias", (3 * c,)), ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                                ("attn.relative_position_bias_table", (side * side, h)), ("norm2.weight", (c,)),
                                ("norm2.bias", (c,)), ("mlp.fc1.weight", (4 * c, c)), ("mlp.fc1.bias", (4 * c,)),
                                ("mlp.fc2.weight", (c, 4 * c)), ("mlp.fc2.bias", (c,))):
                sd[p + name] = t(*shape)
            sd[p + "attn.relative_position_index"] = torch.zeros(window**2, window**2, dtype=torch.long)
        if i < len(depths) - 1:  # 2-D Swin downsamples after stages 0..2
            sd[f"layers.{i}.downsample.reduction.weight"] = t(2 * c, 4 * c)
            sd[f"layers.{i}.downsample.norm.weight"] = t(4 * c)
            sd[f"layers.{i}.downsample.norm.bias"] = t(4 * c)
    return sd


def _flax_layout(value: np.ndarray, kind: str) -> np.ndarray:
    if kind == lf_convert.LINEAR:
        return value.T
    if kind == lf_convert.CONV3D:
        return value.transpose(2, 3, 4, 1, 0)
    return value


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return np.asarray(tree)


def _bert_file(tree, path):
    from xpretrain_tpu.models.export import bert_flax_to_torch

    te = dict(tree["text_encoder"])
    pooler = te.pop("pooler", None)
    return _save(bert_flax_to_torch(te, pooler=pooler, mlm=tree.get("cls")), path)


def _cascade_files(branch, inits, tmp_path):
    """(stage of the model, cascade kwargs) of ``branch``, its files written."""
    from xpretrain_tpu.models.export import lfvila_flax_to_torch, swin3d_flax_to_torch

    src1, src2 = inits[1][1], inits[2][1]
    if branch == "full":
        return 1, dict(model_weight=_save(lfvila_flax_to_torch(src1), tmp_path / "lfvila.pt"))
    if branch == "stage1_bert":  # the stage-2 recipe: BERT-large first, the stage-1 model over it
        return 2, dict(stage1_model_weight=_save(lfvila_flax_to_torch(src1), tmp_path / "stage1.pt"),
                       bert_weight=_bert_file(src2, tmp_path / "bert.bin"))
    if branch == "swin3d_bert":
        return 1, dict(swin_weight=_save(swin3d_flax_to_torch(src1["video_encoder"]), tmp_path / "swin3d.pth"),
                       bert_weight=_bert_file(src2, tmp_path / "bert.bin"), pretrained_2d=False)
    path = tmp_path / "swin2d.pth"
    torch.save({"model": _swin2d_state_dict(np.random.default_rng(3))}, str(path))
    return 1, dict(swin_weight=str(path), bert_weight=_bert_file(src2, tmp_path / "bert.bin"), pretrained_2d=True)


@pytest.mark.parametrize("branch", ["full", "stage1_bert", "swin3d_bert", "swin2d_bert"])
def test_lfvila_cascade_merges_as_jax_merges_it(lfvila_jax, tmp_path, branch):
    """Each branch of the WEIGHTS cascade leaves every port parameter at
    JAX's ``load_lfvila_cascade`` tree, from the same fresh init and files."""
    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig
    from xpretrain_tpu.models.pretrained import load_lfvila_cascade as jax_cascade

    stage, kwargs = _cascade_files(branch, lfvila_jax, tmp_path)
    fresh = lfvila_jax[stage][0]
    swin = {"swin_config": JaxConfig.tiny(stage=stage, **TINY_KW).video} if "swin_weight" in kwargs else {}
    merged = jax_cascade(fresh, **kwargs, **swin)
    port = LfVilaPretrain(LfVilaConfig.tiny(stage=stage, **TINY_KW))
    lf_convert.load_jax_params(port, {"params": fresh})
    port_swin = {"swin_config": port.config.video} if swin else {}
    load_lfvila_cascade(port, **kwargs, **port_swin)
    rules = lf_convert.key_rules(port)
    changed = 0
    for name, p in port.named_parameters():
        path, kind = rules[name]
        got, want = _flax_layout(p.detach().numpy(), kind), _leaf(merged, path)
        tol = 1e-5 if branch == "swin2d_bert" and name.endswith("relative_position_bias_table") else 1e-6
        np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=name)
        changed += not np.array_equal(want, _leaf(fresh, path))
    assert changed > 0


def test_swin2d_inflation_is_bicubic_without_cv2(monkeypatch):
    """The reference-side fault the port does not copy: without cv2 the JAX
    inflation resizes the bias tables by nearest-neighbour indexing; the port
    imports no cv2 and always resizes bicubically, within float rounding of
    cv2's bicubic."""
    pytest.importorskip("cv2")
    from xpretrain_tpu.models.lf_vila import convert as jax_lf_convert

    table = np.random.default_rng(5).normal(size=(13 * 13, 4)).astype(np.float32)
    for wh, ww in ((10, 10), (7, 10), (6, 6), (4, 4), (3, 5)):
        port = lf_convert._resize_bias_table_spatial(table, wh, ww)
        cubic = jax_lf_convert._resize_bias_table_spatial(table, wh, ww)
        np.testing.assert_allclose(port, cubic, atol=1e-5, rtol=0, err_msg=f"{wh}x{ww}")
        with monkeypatch.context() as m:
            m.setitem(sys.modules, "cv2", None)  # import cv2 raises
            nearest = jax_lf_convert._resize_bias_table_spatial(table, wh, ww)
            np.testing.assert_array_equal(lf_convert._resize_bias_table_spatial(table, wh, ww), port)
        assert nearest.shape == port.shape and np.abs(nearest - port).max() > 0.1, f"{wh}x{ww}"


def _port_tree(model):
    """The flax-path tree of a port model's parameters (what the JAX
    exporters take)."""
    tree: dict = {}
    for name, (path, kind) in lf_convert.key_rules(model).items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = _flax_layout(dict(model.named_parameters())[name].detach().numpy(), kind)
    return tree


def _capture_cascade(monkeypatch, runner):
    """Record the model's parameters right after the runner's cascade load."""
    seen = {}

    def load(model, **kwargs):
        out = load_lfvila_cascade(model, **kwargs)
        seen.update({n: p.detach().clone() for n, p in model.named_parameters()})
        return out

    monkeypatch.setattr(runner, "load_lfvila_cascade", load)
    return seen


def test_pretrain_runner_loads_an_inflated_swin_and_bert(tmp_path, monkeypatch):
    """``run_pretrain_lfvila --swin_weight <2-D Swin> --bert_weight`` on the
    CPU: the model holds the BERT file's embeddings and the inflated patch
    embed before its first step, then trains."""
    from xpretrain_tpu.models.export import bert_flax_to_torch

    seen = _capture_cascade(monkeypatch, run_pretrain_lfvila)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(RUNNER_CONFIG))
    source = LfVilaPretrain(run_pretrain_lfvila.lfvila_config_from({**RUNNER_CONFIG, "bf16": 0}))
    source.init_weights(torch.Generator().manual_seed(11))
    te = _port_tree(source)["text_encoder"]
    pooler = te.pop("pooler", None)
    bert = _save(bert_flax_to_torch(te, pooler=pooler), tmp_path / "bert.bin")
    sd2d = _swin2d_state_dict(np.random.default_rng(3))
    torch.save({"model": sd2d}, str(tmp_path / "swin2d.pth"))
    state = run_pretrain_lfvila.main([
        "--config", str(cfg), "--stage", "1", "--dummy_data", "1", "--input_hw", "96", "160",
        "--num_train_steps", "1", "--train_batch_size", "4", "--max_txt_len", "8", "--bf16", "0", "--device", "cpu",
        "--save_steps", "100", "--swin_weight", str(tmp_path / "swin2d.pth"), "--bert_weight", bert,
        "--output_dir", str(tmp_path / "out")])
    assert state.step == 1
    word = "text_encoder.embeddings.word_embeddings.weight"
    torch.testing.assert_close(seen[word], dict(source.named_parameters())[word], atol=0, rtol=0)
    inflated = sd2d["patch_embed.proj.weight"][:, :, None].repeat(1, 1, 1, 2, 2) / 4
    torch.testing.assert_close(seen["video_encoder.patch_embed.proj.weight"], inflated, atol=1e-7, rtol=0)


def test_tasks_runner_loads_a_full_checkpoint(tmp_path, monkeypatch):
    """``run_tasks_lfvila --model_weight`` on the CPU: the retrieval model
    holds the checkpoint's encoders and projections, then evaluates."""
    from xpretrain_tpu.models.export import lfvila_flax_to_torch

    seen = _capture_cascade(monkeypatch, run_tasks_lfvila)
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(RUNNER_CONFIG))
    source = LfVilaPretrain(run_pretrain_lfvila.lfvila_config_from({**RUNNER_CONFIG, "bf16": 0}))
    source.init_weights(torch.Generator().manual_seed(12))
    path = _save(lfvila_flax_to_torch(_port_tree(source)), tmp_path / "lfvila.pt")
    monkeypatch.setattr(run_tasks_lfvila, "DUMMY_SIZE", 8)
    report = run_tasks_lfvila.main([
        "--config", str(cfg), "--task", "retrieval", "--dummy_data", "1", "--input_hw", "96", "160",
        "--num_train_steps", "0", "--val_batch_size", "4", "--bf16", "0", "--device", "cpu",
        "--model_weight", path, "--output_dir", str(tmp_path / "out")])
    assert 0.0 <= report["t2v"]["R1"] <= 100.0
    want = dict(source.named_parameters())
    assert set(seen) <= set(want)
    for name, value in seen.items():
        torch.testing.assert_close(value, want[name], atol=0, rtol=0, msg=name)
