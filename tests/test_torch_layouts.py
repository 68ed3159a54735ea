"""The port's layout rules against the JAX package's, without processes.

``parallel/tensor_parallel.py:tp_pspec``, ``parallel/fsdp.py:fsdp_pspec``
and ``resolve_shardings`` are held to ``xpretrain_tpu/parallel/{tensor_parallel,
fsdp}.py`` on every parameter path and flax shape of tiny CLIP-ViP, LF-VILA
and HD-VILA models, at (data, model) meshes of (2, 2), (2, 4) and (4, 2) on
JAX's virtual CPU devices; the explicit cases of
``tests/test_tensor_parallel.py`` and ``tests/test_fsdp.py`` run against the
port's copies. The deliberate layout differences (ROADMAP Queue 3) are
pinned here: attention whose heads the model axis does not divide stays
replicated, and a fused qkv is split per head.
"""

import sys
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from xpretrain_tpu_torch.config import ConfigDict  # noqa: E402
from xpretrain_tpu_torch.parallel import fsdp, tensor_parallel as tpm  # noqa: E402
from xpretrain_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, DataMesh, LeafLayout, local_leaf  # noqa: E402

MESHES = [(2, 2), (2, 4), (4, 2)]


def _models():
    import _torch_mp_worker as worker
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel

    return {"clipvip": CLIPViPModel(worker._clipvip_config()), "lfvila": worker._lfvila(2)[0],
            "hdvila": worker._hdvila()[0]}


@pytest.fixture(scope="module")
def models():
    return _models()


def _flax_tree(model):
    """The flax params tree of ``model`` as zeros of the flax shapes."""
    tree: dict = {}
    for name, p in model.named_parameters():
        path, kind = tpm.param_rules(model)[name]
        node = tree
        parts = path.strip("/").split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = np.zeros(tpm.flax_shape(tuple(p.shape), kind), np.float32)
    return tree


def _path_specs(tree) -> dict:
    import jax

    return {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(leaf.spec)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("family", ["clipvip", "lfvila", "hdvila"])
@pytest.mark.parametrize("dp, mp", MESHES)
def test_pspecs_and_policy_match_jax_on_every_path(models, family, dp, mp):
    import jax

    from xpretrain_tpu.optim import build_optimizer, get_schedule
    from xpretrain_tpu.parallel import fsdp as jfsdp, tensor_parallel as jtp
    from xpretrain_tpu.parallel.mesh import create_mesh

    model = models[family]
    rules = tpm.param_rules(model)
    shapes = {n: tpm.flax_shape(tuple(p.shape), rules[n][1]) for n, p in model.named_parameters()}
    for name, (path, _) in rules.items():
        shape = shapes[name]
        assert tpm.tp_pspec(path, shape, mp) == tuple(jtp.tp_pspec(path, shape, mp)), path
        for tp in (1, mp):
            for min_size in (64, 16384):
                assert fsdp.fsdp_pspec(path, shape, dp, tp, min_size) == tuple(
                    jfsdp.fsdp_pspec(path, shape, dp, tp, min_size)), (path, tp, min_size)

    params = _flax_tree(model)
    tx, _ = build_optimizer(params, get_schedule("cosine", 1e-3, 100))
    by_path = {path: n for n, (path, _) in rules.items()}
    for cfg in ({"tp": mp}, {"tp": mp, "zero2": 0}, {"tp": mp, "zero3": 1}, {"zero3": 1}, {}, {"zero2": 0}):
        shape = (dp, mp) if cfg.get("tp") else (dp,)
        axes = ("data", "model") if len(shape) == 2 else ("data",)
        mesh = create_mesh(shape, axes, devices=jax.devices()[:int(np.prod(shape))])
        want_p, want_s = jfsdp.resolve_shardings(ConfigDict(cfg), tx, params, mesh)
        got_p, got_s = fsdp.resolve_shardings(ConfigDict(cfg), model, dp, mp)
        assert (want_p is None) == (got_p is None), cfg
        if want_p is not None:
            for path, spec in _path_specs(want_p).items():
                assert got_p[by_path[path]] == spec, (cfg, path)
        assert (want_s is None) == (got_s is None), cfg
        if want_s is not None:
            # the moments of a parameter sit at paths that end with its path
            # and have its shape
            state_shapes = {"/" + "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): np.shape(v)
                            for p, v in jax.tree_util.tree_flatten_with_path(jax.eval_shape(tx.init, params))[0]}
            checked = 0
            for spath, spec in _path_specs(want_s).items():
                name = next((n for p, n in by_path.items() if spath.endswith(p)), None)
                if name is None or state_shapes[spath] != shapes[name]:
                    continue
                assert got_s[name] == spec, (cfg, spath)
                checked += 1
            assert checked >= 2 * len(shapes), (cfg, checked)


def test_jax_named_shardings_match_jax(models):
    """The JAX names (``tp_param_shardings``, ``fsdp_param_shardings``, their
    state counterparts, ``batch_sharding``, ``replicated_sharding``) give
    JAX's specs of every parameter, as the port writes a spec."""
    import jax

    from xpretrain_tpu.parallel import fsdp as jfsdp, mesh as jmesh_lib, tensor_parallel as jtp

    dp, mp = 2, 2
    model = models["clipvip"]
    mesh = DataMesh(rank=0, world_size=dp, device=torch.device("cpu"), backend="gloo", model_size=mp)
    jmesh = jmesh_lib.create_mesh((dp, mp), ("data", "model"), devices=jax.devices()[:dp * mp])
    params = _flax_tree(model)
    by_path = {path: n for n, (path, _) in tpm.param_rules(model).items()}
    got = tpm.tp_param_shardings(model, mesh)
    for path, spec in _path_specs(jtp.tp_param_shardings(params, jmesh)).items():
        assert got[by_path[path]] == spec, path
    for tp in (1, mp):
        got = fsdp.fsdp_param_shardings(model, mesh, tp=tp)
        for path, spec in _path_specs(jfsdp.fsdp_param_shardings(params, jmesh, tp=tp)).items():
            assert got[by_path[path]] == spec, (path, tp)
    # the moments' specs are the policy's, held to JAX's state trees above
    assert tpm.hybrid_state_shardings(model, mesh) == fsdp.resolve_shardings(ConfigDict(tp=mp), model, dp, mp)[1]
    assert fsdp.fsdp_state_shardings(model, mesh, tp=mp) == fsdp.resolve_shardings(
        ConfigDict(tp=mp, zero3=1), model, dp, mp)[1]
    from xpretrain_tpu_torch.parallel.mesh import batch_sharding, replicated_sharding

    assert batch_sharding(mesh) == tuple(jmesh_lib.batch_sharding(jmesh).spec) == (DATA_AXIS,)
    assert replicated_sharding(mesh) == tuple(jmesh_lib.replicated_sharding(jmesh).spec) == ()


def test_tp_pspec_rules_as_jax_tests_them():
    """``tests/test_tensor_parallel.py:test_tp_pspec_rules``, on the port's copy."""
    M = MODEL_AXIS
    assert tpm.tp_pspec("/a/self_attn/q_proj/kernel", (64, 64), 4) == (None, M)
    assert tpm.tp_pspec("/a/self_attn/q_proj/bias", (64,), 4) == (M,)
    assert tpm.tp_pspec("/a/self_attn/out_proj/kernel", (64, 64), 4) == (M, None)
    assert tpm.tp_pspec("/a/self_attn/out_proj/bias", (64,), 4) == ()
    assert tpm.tp_pspec("/a/mlp/fc1/kernel", (64, 128), 4) == (None, M)
    assert tpm.tp_pspec("/a/mlp/fc2/kernel", (128, 64), 4) == (M, None)
    assert tpm.tp_pspec("/l/attention_self/query/kernel", (64, 64), 2) == (None, M)
    assert tpm.tp_pspec("/l/attention_output_dense/kernel", (64, 64), 2) == (M, None)
    assert tpm.tp_pspec("/l/intermediate_dense/kernel", (64, 128), 2) == (None, M)
    assert tpm.tp_pspec("/l/output_dense/kernel", (128, 64), 2) == (M, None)
    assert tpm.tp_pspec("/b/qkv/kernel", (32, 96), 2) == (None, M)
    assert tpm.tp_pspec("/b/proj/kernel", (32, 32), 2) == (M, None)
    assert tpm.tp_pspec("/a/mlp/fc1/kernel", (64, 130), 4) == ()
    assert tpm.tp_pspec("/a/layer_norm1/scale", (64,), 4) == ()
    assert tpm.tp_pspec("/embeddings/patch_embedding/kernel", (16, 16, 3, 64), 4) == ()
    assert tpm.tp_pspec("/patch_embed/proj/kernel", (2, 8, 8, 3, 96), 2) == ()
    # TimeSformer's and Swin3D's MLPs match no rule, as in JAX
    assert tpm.tp_pspec("/blocks_0/mlp_fc1/kernel", (64, 256), 2) == ()


def test_fsdp_pspec_rules_as_jax_tests_them():
    """``tests/test_fsdp.py:test_fsdp_pspec_rules``, on the port's copy."""
    D, M = DATA_AXIS, MODEL_AXIS
    assert fsdp.fsdp_pspec("/x/fc1/kernel", (64, 512), dp=4, min_size=64) == (None, D)
    assert fsdp.fsdp_pspec("/x/embed/embedding", (512, 64), dp=4, min_size=64) == (D,)
    assert fsdp.fsdp_pspec("/x/layer_norm/scale", (64,), dp=4, min_size=16384) == ()
    assert fsdp.fsdp_pspec("/logit_scale", (), dp=4, min_size=16384) == ()
    assert fsdp.fsdp_pspec("/x/k", (7, 13), dp=4, min_size=1) == ()
    assert fsdp.fsdp_pspec("/a/mlp/fc1/kernel", (64, 128), dp=2, tp=4, min_size=64) == (D, M)
    assert fsdp.fsdp_pspec("/a/mlp/fc2/kernel", (128, 64), dp=2, tp=4, min_size=64) == (M, D)
    assert fsdp.fsdp_pspec("/a/self_attn/q_proj/bias", (64,), dp=2, tp=4, min_size=1) == (M,)


@pytest.mark.parametrize("mp", [2, 4])
def test_the_port_plans_every_leaf_jax_shards(models, mp):
    """Each leaf ``tp_pspec`` shards is in the port's plan, or in an
    attention the model axis cannot keep head-local (listed)."""
    for family, model in models.items():
        rules = tpm.param_rules(model)
        plan, indivisible = tpm.plan_tensor_parallel(model, mp)
        for name, p in model.named_parameters():
            path, kind = rules[name]
            if tpm.tp_pspec(path, tpm.flax_shape(tuple(p.shape), kind), mp):
                assert name in plan or any(name.startswith(u + ".") for u in indivisible), (family, name)


def test_heads_that_do_not_divide_stay_replicated():
    """CLIP-ViP B/32 at ``--tp 8``: the 12-head attentions stay replicated
    (JAX shards their 768 columns; attention cannot stay head-local), the
    MLPs are sharded (ROADMAP Queue 3)."""
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    model = CLIPViPModel(CLIPVipConfig.base_patch32(), device="meta")
    plan, indivisible = tpm.plan_tensor_parallel(model, 8)
    # the text tower's 8 heads divide 8
    assert sorted(indivisible) == sorted(f"vision_model.encoder.layers.{i}.self_attn" for i in range(12))
    assert not any(".self_attn." in n and n.startswith("vision_model") for n in plan)
    assert plan["vision_model.encoder.layers.0.mlp.fc1.weight"] == ("column", 1)
    assert plan["vision_model.encoder.layers.0.mlp.fc2.weight"] == ("row", 1)
    assert tpm.tp_pspec("/vision_model/encoder/layers_0/self_attn/q_proj/kernel", (768, 768), 8) == (None, "model")
    # at --tp 4 (3 heads a rank) every attention is sharded
    plan4, indivisible4 = tpm.plan_tensor_parallel(model, 4)
    assert not indivisible4 and plan4["vision_model.encoder.layers.0.self_attn.q_proj.weight"] == ("column", 1)


def test_fused_qkv_is_split_per_head():
    """A fused ``qkv`` [q heads | k heads | v heads] gives rank r the rows of
    its heads of q, of k and of v, in that order (JAX splits the fused
    columns in one block; ROADMAP Queue 3)."""
    heads, d, mp = 4, 3, 2
    full = torch.arange(3 * heads * d * 5, dtype=torch.float32).reshape(3 * heads * d, 5)
    layout = LeafLayout(tuple(full.shape), tp_dim=0, tp_parts=3)
    for r in range(mp):
        mesh = DataMesh(rank=0, world_size=1, device=torch.device("cpu"), backend="gloo", model_rank=r,
                        model_size=mp, model_group=object())
        local = local_leaf(full, layout, mesh)
        rows = full.view(3, heads, d, 5)[:, r * heads // mp:(r + 1) * heads // mp].reshape(-1, 5)
        assert torch.equal(local, rows)


def test_zero3_dims_follow_jax_through_the_flax_layout():
    """A Dense kernel [in, out] is the port's [out, in]: JAX's data dim maps
    across, so the port splits the same axis of the weight."""
    assert tpm.flax_shape((128, 64), "linear") == (64, 128)
    spec = fsdp.fsdp_pspec("/x/fc1/kernel", (64, 128), dp=4, min_size=64)
    assert spec == (None, DATA_AXIS)
    assert tpm.torch_dim(spec.index(DATA_AXIS), "linear", 2) == 0
    assert tpm.flax_shape((96, 3, 1, 8, 8), "conv3d") == (1, 8, 8, 3, 96)
    assert tpm.torch_dim(4, "conv3d", 5) == 0 and tpm.torch_dim(0, "conv3d", 5) == 2


def test_swin3d_stays_replicated_under_tp_with_cp(models):
    """``--tp N --cp N`` share the model axis: the Swin3D encoder shards its
    frames over it and keeps its attention replicated (JAX also TP-shards its
    ``qkv`` / ``proj``; ROADMAP Queue 3), while BERT is TP-sharded."""
    model = models["lfvila"]
    plan, _ = tpm.plan_tensor_parallel(model, 2, skip=(model.video_encoder,))
    assert not any(n.startswith("video_encoder.") for n in plan)
    assert any(n.endswith("attention_self.query.weight") for n in plan)
    full, _ = tpm.plan_tensor_parallel(model, 2)
    assert any(n.startswith("video_encoder.") and n.endswith("qkv.weight") for n in full)
