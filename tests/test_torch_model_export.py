"""The port's reference-layout weight writers (``xpretrain_tpu_torch/models/
export.py``) against the JAX package's (``xpretrain_tpu/models/export.py``)
on the same flax-path trees, keys and values exactly; ``flax_params`` against
the JAX params a port model was loaded from; and a written LF-VILA checkpoint
back through the port's ``--model_weight`` loader."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel  # noqa: E402
from xpretrain_tpu_torch.models import export  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.convert import hdvila_e2e_state_dict  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoderConfig  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.modeling import HdVilaModelConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig, LfVilaPretrain  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval  # noqa: E402
from xpretrain_tpu_torch.models.pretrained import load_lfvila_cascade  # noqa: E402


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=g)
    return model


def _lfvila_config(stage: int = 1) -> LfVilaConfig:
    return LfVilaConfig.tiny(sample_clip=4, sample_frame=8, final_num_patches=1, stage=stage)


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=key)


@pytest.fixture(scope="module")
def jax_export():
    return pytest.importorskip("xpretrain_tpu.models.export")


@pytest.mark.parametrize("stage", [1, 2])
def test_lfvila_writers_equal_jax(jax_export, stage):
    """``bert_flax_to_torch``, ``swin3d_flax_to_torch`` and
    ``lfvila_flax_to_torch`` on an LF-VILA pretraining model's tree (stage 2:
    the fusion layers, the pooler, the MLM and VTM heads)."""
    tree = export.flax_params(_seeded(LfVilaPretrain(_lfvila_config(stage)), stage))
    _assert_same(export.lfvila_flax_to_torch(tree), jax_export.lfvila_flax_to_torch(tree))
    _assert_same(export.swin3d_flax_to_torch(tree["video_encoder"]),
                 jax_export.swin3d_flax_to_torch(tree["video_encoder"]))
    text = dict(tree["text_encoder"])
    pooler = text.pop("pooler", None)
    for kwargs in ({}, {"pooler": pooler, "mlm": tree.get("cls"), "prefix": "x.", "mlm_prefix": "y."}):
        _assert_same(export.bert_flax_to_torch(text, **kwargs), jax_export.bert_flax_to_torch(text, **kwargs))


def test_hdvila_writers_equal_jax(jax_export):
    """The HD-VILA writers on a stage-2 ``HdVilaPretrainModel``'s tree, and
    ``hdvila_e2e_flax_to_torch(flax_params(model))`` is the port's model
    writer ``hdvila_e2e_state_dict(model)``."""
    model = _seeded(HdVilaPretrainModel(HdVilaEncoderConfig.tiny(timesformer_frames=3, timesformer_hw=(1, 2)),
                                        HdVilaModelConfig.tiny(stage=2)), 3)
    tree = export.flax_params(model)
    _assert_same(export.hdvila_e2e_flax_to_torch(tree), jax_export.hdvila_e2e_flax_to_torch(tree))
    encoder = tree["encoder"]
    for name, sub in (("cnn", encoder["cnn"]), ("cnn_low", encoder["cnn_low"])):
        _assert_same(export.resnet_flax_to_torch(sub), jax_export.resnet_flax_to_torch(sub))
    _assert_same(export.timesformer_flax_to_torch(encoder["timesformer"]),
                 jax_export.timesformer_flax_to_torch(encoder["timesformer"]))
    written = export.hdvila_e2e_flax_to_torch(tree)
    tied = written.pop("transformer.cls.predictions.bias")  # the tree writer adds HF BERT's tied copy
    np.testing.assert_array_equal(tied, written["transformer.cls.predictions.decoder.bias"])
    _assert_same(written, {k: v.numpy() for k, v in hdvila_e2e_state_dict(model).items()})


def test_flax_params_is_the_tree_the_model_was_loaded_from():
    """``flax_params`` inverts ``load_jax_params``: a JAX ``LfVilaRetrieval``'s
    params, loaded into the port, come back leaf for leaf, in flax layouts
    (Dense kernels [in, out], the Conv3d patch embed channels-last)."""
    import jax

    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig
    from xpretrain_tpu.models.lf_vila.tasks import LfVilaRetrieval as JaxRetrieval

    jax_model = JaxRetrieval(JaxConfig.tiny(sample_clip=4, sample_frame=8, final_num_patches=1))
    rng = np.random.default_rng(0)
    video = rng.normal(size=(1, 3, 8, 96, 160)).astype(np.float32)
    ids = rng.integers(1, 1000, size=(1, 4, 6))
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), video, ids, np.ones_like(ids))["params"]
    port = load_jax_params(LfVilaRetrieval(_lfvila_config()), {"params": params})
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    got = {"/".join(path): leaf for path, leaf in export._flatten(export.flax_params(port))}
    _assert_same(got, want)


@pytest.mark.parametrize("model_cls", [LfVilaPretrain, LfVilaRetrieval])
def test_written_lfvila_checkpoint_loads_back_through_model_weight(tmp_path, model_cls):
    """A port model written as a reference checkpoint
    (``lfvila_flax_to_torch(flax_params(model))``) and read by the
    ``--model_weight`` branch of ``load_lfvila_cascade`` gives back the same
    model, parameter for parameter."""
    source = _seeded(model_cls(_lfvila_config()), 4)
    path = tmp_path / "lfvila.pt"
    torch.save({k: torch.from_numpy(v) for k, v in export.lfvila_flax_to_torch(export.flax_params(source)).items()},
               path)
    loaded = load_lfvila_cascade(_seeded(model_cls(_lfvila_config()), 5), model_weight=str(path))
    want = dict(source.named_parameters())
    for name, p in loaded.named_parameters():
        torch.testing.assert_close(p, want[name], rtol=0, atol=0, msg=name)
