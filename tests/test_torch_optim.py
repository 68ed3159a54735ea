"""Port parity: schedules and the grouped AdamW
(``xpretrain_tpu_torch/optim``) against ``xpretrain_tpu.optim``, fp32 on the
CPU. The update is held to the JAX transform over K=3 steps on the same
gradients; both evaluate the same fp32 formulas in the same order, so the
bar is JAX's own fused-vs-optax one, 1e-6 relative and 1e-7 absolute.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.optim import optimizer as opt  # noqa: E402
from xpretrain_tpu_torch.optim import schedules  # noqa: E402

SCHEDULES = [
    ("linear", dict(warmup_ratio=0.1)),
    ("cosine", dict(warmup_ratio=0.1)),
    ("invsqrt", dict(warmup_ratio=0.04)),
    ("constant", dict()),
    ("multi_step", dict(warmup_ratio=0.05, steps_per_epoch=10, decay_epochs=[3, 7], gamma=0.5)),
]


@pytest.fixture(scope="module")
def jax_optim():
    return pytest.importorskip("xpretrain_tpu.optim")


@pytest.mark.parametrize("decay,kwargs", SCHEDULES, ids=[s[0] for s in SCHEDULES])
def test_schedule_matches_jax(jax_optim, decay, kwargs):
    """Every step from 0 (warmup's lr 0 -> the 1e-8 floor) past the end
    (the floor again). JAX evaluates in fp32, the port in Python floats: 1e-6
    relative, and a few fp32 ulps of the peak lr absolute (the cosine's
    1 + cos cancels near the end)."""
    lr = 1e-4
    want = jax_optim.get_schedule(decay, lr, 100, **kwargs)
    got = schedules.get_schedule(decay, lr, 100, **kwargs)
    steps = list(range(0, 121))
    np.testing.assert_allclose(
        [got(s) for s in steps], [float(want(s)) for s in steps], rtol=1e-6, atol=lr * 2.0**-22
    )
    assert got(0) == pytest.approx(schedules.LR_FLOOR) or decay == "constant"


def test_autostep_matches_jax(jax_optim):
    a, b = jax_optim.AutoStep(1, 0.5), schedules.AutoStep(1, 0.5)
    for score in (1.0, 2.0, 1.5, 1.5, 3.0, 2.0, 2.0, 2.0):
        a.step(score)
        b.step(score)
        for step in (5, 50, 500):
            assert b.get_lr(step, 1e-3, 1000) == pytest.approx(a.get_lr(step, 1e-3, 1000))
    assert b.coeff == a.coeff < 1.0


@pytest.fixture(scope="module")
def clip_params():
    """A tiny flax CLIP-ViP params tree and the port's model of that config."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig
    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    jax_model = JaxModel(JaxConfig.tiny_debug(image_size=32))
    video = jnp.zeros((1, 2, 32, 32, 3), jnp.uint8)
    ids = jnp.zeros((1, 8), jnp.int32).at[:, 3].set(49407)
    params = jax_model.init(jax.random.PRNGKey(0), video, ids, ids > 0)["params"]
    return params, CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=32))


@pytest.mark.parametrize(
    "prefix,frozen", [("", ()), ("vision_model", ("text_model",)), ("text", ("projection",))]
)
def test_labels_match_jax_per_flax_leaf(jax_optim, clip_params, prefix, frozen):
    """The port labels each torch parameter by its flax path: the label must
    be JAX's label of that leaf."""
    from xpretrain_tpu_torch.models.clip_vip.convert import clip_key_rules, flax_param_paths

    params, model = clip_params
    want = jax_optim.param_group_labels(params, lr_mul_prefix=prefix, frozen_patterns=frozen)
    got = opt.param_group_labels(
        dict(model.named_parameters()), prefix, frozen_patterns=frozen,
        paths=flax_param_paths(model.config),
    )
    rules = clip_key_rules(model.config.text.num_hidden_layers, model.config.vision.num_hidden_layers)
    assert set(got) == set(dict(model.named_parameters()))
    for name, label in got.items():
        node = want
        for key in rules[name][0]:
            node = node[key]
        assert label == node, name
    assert len(set(got.values())) >= (4 if prefix else 2)


def _tree():
    """Flax-style nested params; the port sees them flat, "."-joined."""
    rng = np.random.default_rng(0)
    leaf = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return {
        "vision": {"kernel": leaf(4, 4), "bias": leaf(4)},
        "cnn": {"conv": {"kernel": leaf(2, 8)}},
        "layer_norm": {"scale": leaf(4), "bias": leaf(4)},
        "logit_scale": np.asarray(4.6, np.float32),
        "pos_embed": leaf(3, 4),
    }


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


CASES = {
    "clip_on": dict(max_grad_norm=2.0, frozen_patterns=("cnn",), lr_mul=2.0, lr_mul_prefix="vision"),
    "clip_off": dict(max_grad_norm=None),
    "moment_bf16": dict(max_grad_norm=2.0, moment_dtype="bf16"),
    "accum_2": dict(max_grad_norm=2.0, grad_accum_steps=2, frozen_patterns=("pos_embed",)),
    # the train step hands over the norm of the gradients it logs: clipping
    # reuses it, and ignores it under accumulation (the mean is clipped)
    "clip_norm_given": dict(max_grad_norm=2.0, norm_given=True),
    "accum_2_norm_given": dict(max_grad_norm=2.0, grad_accum_steps=2, norm_given=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_update_matches_jax_over_three_steps(jax_optim, case):
    import jax
    import jax.numpy as jnp
    import optax

    kwargs = dict(CASES[case])
    moment = kwargs.pop("moment_dtype", None)
    norm_given = kwargs.pop("norm_given", False)
    accum = kwargs.get("grad_accum_steps", 1)
    tree = _tree()
    sched_j = jax_optim.get_schedule("cosine", 1e-2, 20, warmup_ratio=0.1)
    sched_t = schedules.get_schedule("cosine", 1e-2, 20, warmup_ratio=0.1)
    tx, _ = jax_optim.build_optimizer(
        jax.tree_util.tree_map(jnp.asarray, tree), sched_j, weight_decay=0.1,
        moment_dtype=jnp.bfloat16 if moment else None, **kwargs,
    )
    params_j = jax.tree_util.tree_map(jnp.asarray, tree)
    state_j = tx.init(params_j)
    named = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    port, _ = opt.build_optimizer(
        named, sched_t, weight_decay=0.1, moment_dtype=torch.bfloat16 if moment else None, **kwargs
    )
    rng = np.random.default_rng(1)
    for call in range(3 * accum):
        scale = 100.0 if call == 1 else 0.05  # trips the norm clip once
        grads = jax.tree_util.tree_map(lambda p: np.asarray(rng.normal(size=np.shape(p)) * scale, np.float32), tree)
        upd, state_j = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        flat_grads = _flat(grads)
        grads_t = [torch.from_numpy(flat_grads[name]) for name in port.names]
        port.step(grads_t, opt.global_norm(grads_t) if norm_given else None)
        for name, want in _flat(jax.tree_util.tree_map(np.asarray, params_j)).items():
            np.testing.assert_allclose(named[name].numpy(), want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{name} after call {call}")
    assert port.count == 3
    for name, label in zip(port.names, port.labels):
        if label == "frozen":
            np.testing.assert_array_equal(named[name].numpy(), _flat(tree)[name])
    if moment:
        assert all(m.dtype == torch.bfloat16 for m in port.mu)


def test_clamp_logit_scale():
    named = {"logit_scale": torch.tensor(9.0), "other": torch.tensor(9.0), "x.logit_scale": torch.tensor(-1.0)}
    opt.clamp_logit_scale(named)
    assert named["logit_scale"].item() == pytest.approx(5.2983)
    assert named["other"].item() == 9.0
    assert named["x.logit_scale"].item() == 0.0


def test_param_dtype_from_cfg():
    assert opt.param_dtype_from_cfg({"param_dtype": "fp32"}) is None
    assert opt.param_dtype_from_cfg({}) is None
    assert opt.param_dtype_from_cfg({"param_dtype": "bf16"}) == torch.bfloat16
    with pytest.raises(ValueError, match="param_dtype"):
        opt.param_dtype_from_cfg({"param_dtype": "fp16"})


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> float:
    """Largest |got - want| in bf16 ulps of ``want`` (both bf16 values)."""
    w = torch.from_numpy(np.asarray(want, np.float32))
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(2.0**-100))) - 7)
    return ((got.float() - w).abs() / ulp).max().item()


MASTER_CASES = {
    "clip_wd": dict(max_grad_norm=1.0, weight_decay=0.1),
    "accum_2_frozen": dict(max_grad_norm=None, weight_decay=0.0, grad_accum_steps=2, frozen_patterns=("cnn",)),
}


@pytest.mark.parametrize("case", sorted(MASTER_CASES))
def test_master_weights_match_jax_over_three_steps(jax_optim, case):
    """bf16 storage with fp32 masters against JAX's ``master_weights`` on the
    same bf16 gradients, for 3 updates: masters within 1e-6 relative, the
    stored bf16 parameters within 1 bf16 ulp, and ``param == bf16(master)``
    exact on the port after every call (a frozen leaf and accumulation
    included)."""
    import jax
    import jax.numpy as jnp
    import optax
    from xpretrain_tpu.optim import cast_params_for_storage, master_weights

    kwargs = MASTER_CASES[case]
    accum = kwargs.get("grad_accum_steps", 1)
    tree = _tree()
    sched_j = jax_optim.get_schedule("cosine", 1e-2, 20, warmup_ratio=0.1)
    tx, _ = jax_optim.build_optimizer(jax.tree_util.tree_map(jnp.asarray, tree), sched_j, fused=True, **kwargs)
    tx = master_weights(tx)
    params_j = cast_params_for_storage(jax.tree_util.tree_map(jnp.asarray, tree), jnp.bfloat16)
    state_j = tx.init(params_j)

    named = {k: torch.from_numpy(v.copy()) for k, v in _flat(tree).items()}
    port, _ = opt.build_optimizer(named, schedules.get_schedule("cosine", 1e-2, 20, warmup_ratio=0.1), **kwargs)
    opt.cast_params_for_storage(named, torch.bfloat16)
    opt.master_weights(port)
    masters = {port.names[i]: port.targets[i] for i in port.masters}
    assert set(masters) == {"vision.kernel", "cnn.conv.kernel", "pos_embed"}
    assert all(named[n].dtype == torch.bfloat16 and m.dtype == torch.float32 for n, m in masters.items())
    assert named["logit_scale"].dtype == named["vision.bias"].dtype == torch.float32

    rng = np.random.default_rng(1)
    for call in range(3 * accum):
        scale = 100.0 if call == 1 else 0.05  # trips the norm clip once
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(rng.normal(size=np.shape(p)) * scale, p.dtype), params_j)
        upd, state_j = tx.update(grads, state_j, params_j)
        params_j = optax.apply_updates(params_j, upd)
        flat_grads = _flat(jax.tree_util.tree_map(lambda g: np.asarray(g.astype(jnp.float32)), grads))
        port.step([torch.from_numpy(flat_grads[n]).to(named[n].dtype) for n in port.names])
        want = _flat(jax.tree_util.tree_map(lambda p: np.asarray(p.astype(jnp.float32)), params_j))
        want_masters = _flat(jax.tree_util.tree_map(np.asarray, state_j.master))
        for name, p in named.items():
            assert p.dtype == (torch.bfloat16 if name in masters else torch.float32), name
            if name in masters:
                assert torch.equal(p, masters[name].to(torch.bfloat16)), f"{name}: param != bf16(master)"
                np.testing.assert_allclose(masters[name].numpy(), want_masters[name], rtol=1e-6, atol=1e-7,
                                           err_msg=f"master {name} after call {call}")
                assert _bf16_ulps(p, want[name]) <= 1.0, f"{name} after call {call}"
            else:
                np.testing.assert_allclose(p.numpy(), want[name], rtol=1e-6, atol=1e-7, err_msg=name)
    assert port.count == 3
    if "frozen_patterns" in kwargs:
        np.testing.assert_array_equal(named["cnn.conv.kernel"].float().numpy(),
                                      _flat(tree)["cnn.conv.kernel"].astype(np.float32).astype(
                                          jnp.bfloat16).astype(np.float32))


def test_master_weights_state_dict_round_trip():
    """The masters travel in the optimizer's state; loading them sets each
    stored parameter to bf16(master), so a run resumes from its masters."""
    named = {k: torch.from_numpy(v.copy()) for k, v in _flat(_tree()).items()}
    port, _ = opt.build_optimizer(named, schedules.get_schedule("constant", 1e-2, 20))
    opt.cast_params_for_storage(named, torch.bfloat16)
    opt.master_weights(port)
    rng = np.random.default_rng(4)
    for _ in range(2):
        port.step([torch.from_numpy(rng.normal(size=p.shape).astype(np.float32)).to(p.dtype)
                   for p in port.params])
    state = {k: (dict(v) if isinstance(v, dict) else v) for k, v in port.state_dict().items()}
    assert set(state["master"]) == {"vision.kernel", "cnn.conv.kernel", "pos_embed"}
    state = {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v) for k, v in state.items()}

    fresh = {k: torch.zeros_like(v) for k, v in named.items()}
    other, _ = opt.build_optimizer(fresh, schedules.get_schedule("constant", 1e-2, 20))
    opt.master_weights(other)
    other.load_state_dict(state)
    assert other.count == 2
    for name, p in named.items():  # the fp32 leaves are their own master: the model's state carries them
        assert torch.equal(fresh[name], p if name in state["master"] else torch.zeros_like(p)), name
    with pytest.raises(KeyError, match="master"):
        plain, _ = opt.build_optimizer({k: torch.zeros_like(v) for k, v in named.items()},
                                       schedules.get_schedule("constant", 1e-2, 20))
        plain.load_state_dict(state)


def test_global_norm_on_the_cpu_is_exact_for_large_tensors():
    """The gradient norm (the train steps' metric and the clip's scale) of a
    31 M-element tensor, BERT-large's word embeddings, as optax computes it:
    within 1e-6 of the fp64 norm (torch's fp32 CPU norm alone lands 1.7e-3
    off, which HD-VILA's card-vs-CPU step exposed)."""
    g = torch.Generator().manual_seed(0)
    tensors = [torch.randn(31_254_528, generator=g) * 1e-3, torch.randn(1024, 1024, generator=g), torch.zeros(3)]
    want = np.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors))
    got = opt.global_norm(tensors)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), want, rtol=1e-6)
