"""Ring attention, the GPipe pipeline and the expert-parallel MoE FFN of the
port on 4 gloo ranks, against the JAX package's sharded functions.

One spawn of ``tests/_torch_mp_worker.py`` (scenario ``seq_pipe_expert``, 4
ranks, one thread each, under the spawn's deadline: a deadlock fails the
tests, it does not hold the suite) runs every case on a mesh it forms with
``mesh.create_mesh``, rank ``r`` at data index ``r // k`` and index
``r % k`` on the trailing axis, as JAX's ``create_mesh((dp, k))`` places
devices. Meanwhile this process runs the JAX package on 4 of its virtual CPU
devices:

- ring attention at seq = 4 and at data 2 × seq 2, with and without a
  padding mask: each rank's output block and the gradients of its share of
  a mean-squared loss against ``make_ring_attention`` on the same mesh
  shape (2e-5 forward, 3e-5 gradients, JAX's bars);
- the tiny BERT pipeline at pipe = 4 (4 and 8 microbatches) and at data 2 ×
  pipe 2 (2 microbatches): the output against ``pipelined_bert_encoder``
  and ``StagedBertEncoder``, each stage's gradients of the global loss
  (averaged over the data group, as the step does) against JAX's (2e-5,
  3e-5);
- the MoE FFN at data 2 × expert 2, top-1 and top-2, at a capacity factor
  of 0.75 (tokens dropped), each rank holding 2 of the 4 experts: outputs
  against JAX's unsharded ``MoeFfn`` (2e-5), ``aux`` (1e-6 relative), the
  averaged gradients (2e-5·max|g|), and the checkpoint it writes, in the
  reference layout.
"""

import os
import shutil
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, TESTS)

from test_torch_data_parallel import _spawn, _wait  # noqa: E402

WORLD = 4
RING_CASES = [((4,), "mask"), ((4,), "nomask"), ((2, 2), "mask"), ((2, 2), "nomask")]
PIPE_CASES = {"pipe_4_m4": ((4,), ("pipe",), 4, True), "pipe_4_m8": ((4,), ("pipe",), 8, False),
              "pipe_2x2_m2": ((2, 2), ("data", "pipe"), 2, True)}
BERT = dict(vocab_size=500, hidden_size=32, num_hidden_layers=4, num_attention_heads=4, intermediate_size=64,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
MOE = dict(tokens=32, d=16, experts=4, d_ff=32, capacity_factor=0.75)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _inputs(root: str) -> dict:
    """The cases' inputs and JAX parameters, written for the workers;
    returns them with the flax trees the JAX side needs."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.bert import BertConfig, StagedBertEncoder
    from xpretrain_tpu.parallel.moe import MoeFfn
    from xpretrain_tpu_torch.models.bert import BertConfig as PortBertConfig
    from xpretrain_tpu_torch.parallel.pipeline import stacked_bert_params_from_flax

    rng = np.random.default_rng(0)
    ring = {n: rng.normal(size=(2, 4, 48, 16)).astype(np.float32) for n in ("q", "k", "v", "target")}
    ring["mask"] = np.ones((2, 48), np.int32)
    ring["mask"][0, -10:] = 0
    ring["mask"][1, -3:] = 0
    ring["mask"][1, 5:9] = 0

    hidden = rng.normal(size=(8, 10, 32)).astype(np.float32)
    pad = np.ones((8, 10), np.int32)
    pad[:, -3:] = 0
    pad[5, 4:] = 0
    bert = jax.jit(lambda key: StagedBertEncoder(BertConfig(**BERT)).init(key, hidden, None))(jax.random.PRNGKey(0))
    bert = jax.tree_util.tree_map(np.asarray, bert["params"])
    stacked = stacked_bert_params_from_flax(bert, PortBertConfig(**BERT))

    x = rng.normal(size=(MOE["tokens"], MOE["d"])).astype(np.float32)
    moe = {}
    for k in (1, 2):
        model = MoeFfn(num_experts=MOE["experts"], d_ff=MOE["d_ff"], num_selected=k,
                       capacity_factor=MOE["capacity_factor"])
        moe[k] = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(k), jnp.asarray(x)))
    arrays = {**{f"ring/{n}": a for n, a in ring.items()},
              **{f"pipe/stacked/{n}": t.numpy() for n, t in stacked.items()},
              "pipe/hidden": hidden, "pipe/pad": pad,
              "pipe/target": rng.normal(size=hidden.shape).astype(np.float32),
              "moe/x": x, "moe/capacity_factor": np.float32(MOE["capacity_factor"]),
              **{f"moe{k}/{n}": v for k in (1, 2) for n, v in moe[k]["params"].items()}}
    np.savez(os.path.join(root, "seq_pipe_expert.npz"), **arrays)
    return {"arrays": arrays, "bert": bert, "moe": moe}


def _jax_results(inputs: dict) -> dict:
    """Every case as the JAX package computes it, on 4 virtual CPU devices."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.bert import BertConfig, StagedBertEncoder
    from xpretrain_tpu.models.common import expand_padding_mask
    from xpretrain_tpu.ops.ring_attention import make_ring_attention
    from xpretrain_tpu.parallel.mesh import create_mesh
    from xpretrain_tpu.parallel.moe import MoeFfn, _topk_dispatch
    from xpretrain_tpu.parallel.pipeline import pipelined_bert_encoder, stack_layer_params, unstack_layer_params

    a = inputs["arrays"]
    devices = jax.devices()[:WORLD]
    out = {}
    q, k, v, target, mask = (a[f"ring/{n}"] for n in ("q", "k", "v", "target", "mask"))
    for shape, tag in RING_CASES:
        names = ("seq",) if len(shape) == 1 else ("data", "seq")
        ring = make_ring_attention(create_mesh(shape, names, devices=devices),
                                   data_axis="data" if len(shape) == 2 else None)
        m = mask if tag == "mask" else None

        def loss(qkv, ring=ring, m=m):
            o = ring(*qkv, m)
            return jnp.mean((o - target) ** 2), o

        (_, o), g = jax.jit(jax.value_and_grad(loss, has_aux=True))((q, k, v))
        out[("ring", shape, tag)] = (np.asarray(o), [np.asarray(t) for t in g])

    cfg = BertConfig(**BERT)
    enc = StagedBertEncoder(cfg)
    hidden, target, params = a["pipe/hidden"], a["pipe/target"], inputs["bert"]
    jmask = expand_padding_mask(jnp.asarray(a["pipe/pad"]))
    for with_mask in (False, True):
        m = jmask if with_mask else None

        def seq_loss(p, m=m):
            o = enc.apply({"params": p}, hidden, m)
            return jnp.mean((o - target) ** 2), o

        (_, o), g = jax.jit(jax.value_and_grad(seq_loss, has_aux=True))(params)
        out[("sequential", with_mask)] = (np.asarray(o), jax.tree_util.tree_map(np.asarray, g))
    stacked = stack_layer_params(params, cfg.num_hidden_layers)
    for case, (shape, names, n_micro, with_mask) in PIPE_CASES.items():
        mesh = create_mesh(shape, names, devices=devices)
        run = pipelined_bert_encoder(cfg, mesh, data_axis="data" if len(shape) == 2 else None,
                                     n_microbatches=n_micro)
        m = jmask if with_mask else None
        if case == "pipe_4_m4":  # JAX's pipelined gradients too, once

            def pipe_loss(sp, run=run, m=m):
                o = run(sp, hidden, m)
                return jnp.mean((o - target) ** 2), o

            (_, o), g = jax.jit(jax.value_and_grad(pipe_loss, has_aux=True))(stacked)
            out[("pipe_grads", case)] = jax.tree_util.tree_map(
                np.asarray, unstack_layer_params(g, cfg.num_hidden_layers))
        else:
            o = jax.jit(run)(stacked, hidden, m)
        out[("pipe", case)] = np.asarray(o)

    x = a["moe/x"]
    for kk in (1, 2):
        model = MoeFfn(num_experts=MOE["experts"], d_ff=MOE["d_ff"], num_selected=kk,
                       capacity_factor=MOE["capacity_factor"])

        def moe_loss(p, model=model):
            y, aux = model.apply(p, x)
            return jnp.mean(y**2) + 0.01 * aux, (y, aux)

        (_, (y, aux)), g = jax.jit(jax.value_and_grad(moe_loss, has_aux=True))(inputs["moe"][kk])
        capacity = max(1, int(np.ceil(kk * MOE["tokens"] / MOE["experts"] * MOE["capacity_factor"])))
        routed = _topk_dispatch(jax.nn.softmax(x @ inputs["moe"][kk]["params"]["router"]), kk, capacity)[0]
        out[("moe", kk)] = (np.asarray(y), float(aux), jax.tree_util.tree_map(np.asarray, g["params"]),
                            float(routed.sum()))
    return out


@pytest.fixture(scope="module")
def runs():
    root = tempfile.mkdtemp(prefix="xpt_spe_")
    inputs = _inputs(root)
    spawn = _spawn(os.path.join(root, "w4"), WORLD, ("seq_pipe_expert",))
    try:
        jax_out = _jax_results(inputs)
    finally:
        _wait(spawn)
    ranks = {}
    for name in os.listdir(os.path.join(root, "w4", "seq_pipe_expert")):
        case, _, rank = name[:-len(".npz")].rpartition("_")
        with np.load(os.path.join(root, "w4", "seq_pipe_expert", name)) as f:
            ranks.setdefault(case, {})[int(rank)] = {k: f[k] for k in f.files}
    yield {"jax": jax_out, "ranks": ranks, "inputs": inputs}
    shutil.rmtree(root, ignore_errors=True)


def _seq_block(a: np.ndarray, index: int, size: int) -> np.ndarray:
    n = a.shape[2] // size
    return a[:, :, index * n:(index + 1) * n]


@pytest.mark.parametrize("shape", [(4,), (2, 2)], ids=["4", "2x2"])
def test_ring_shift_runs_in_jax_direction(runs, shape):
    """Index i receives from i - 1 (``ppermute``'s ``(i, (i + 1) % p)``), and
    the backward hands i's gradient (the weight 10 + (i + 1) % p of its
    successor) back to it: the K blocks visit the ranks in JAX's order."""
    k = shape[-1]
    for r, got in runs["ranks"][f"shift_{'x'.join(map(str, shape))}"].items():
        i = int(got["index"])
        assert i == r % k
        assert float(got["received"][0]) == (i - 1) % k
        assert float(got["grad"][0]) == 10.0 + (i + 1) % k


@pytest.mark.parametrize("shape,tag", RING_CASES, ids=[f"{'x'.join(map(str, s))}-{t}" for s, t in RING_CASES])
def test_ring_matches_jax_sharded(runs, shape, tag):
    want_out, want_g = runs["jax"][("ring", shape, tag)]
    ranks = runs["ranks"][f"ring_{'x'.join(map(str, shape))}_{tag}"]
    assert sorted(ranks) == list(range(WORLD))
    k = shape[-1]
    for r, got in ranks.items():
        assert (int(got["seq_index"]), int(got["seq_size"])) == (r % k, k)  # JAX's device order
        rows = got["rows"]
        np.testing.assert_array_equal(rows, np.arange(2)[(r // k) * 1:(r // k + 1) * 1] if len(shape) == 2
                                      else np.arange(2))
        np.testing.assert_allclose(got["out"], _seq_block(want_out[rows], r % k, k), atol=2e-5, rtol=0)
        for name, w in zip(("gq", "gk", "gv"), want_g):
            np.testing.assert_allclose(got[name], _seq_block(w[rows], r % k, k), atol=3e-5, rtol=0, err_msg=name)


def _layer_leaf(tree: dict, layer: int, path: tuple) -> np.ndarray:
    leaf = tree[f"layer_{layer}"]
    for p in path:
        leaf = leaf[p]
    return np.asarray(leaf)


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_pipeline_matches_jax_sharded(runs, case):
    from xpretrain_tpu_torch.models.bert import BertConfig, BertLayer
    from xpretrain_tpu_torch.models.lf_vila.convert import LINEAR, key_rules

    shape, _, _, with_mask = PIPE_CASES[case]
    want_seq, want_g = runs["jax"][("sequential", with_mask)]
    want_pipe = runs["jax"][("pipe", case)]
    np.testing.assert_allclose(want_pipe, want_seq, atol=2e-5)
    rules = dict(key_rules(BertLayer(BertConfig(**BERT))))
    per = BERT["num_hidden_layers"] // shape[-1]
    ranks = runs["ranks"][case]
    assert sorted(ranks) == list(range(WORLD))
    for r, got in ranks.items():
        assert (int(got["stage_index"]), int(got["stage_size"])) == (r % shape[-1], shape[-1])
        np.testing.assert_allclose(got["out"], want_pipe, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got["out"], want_seq, atol=2e-5, rtol=0)
        stage = r % shape[-1]
        for name, (path, kind) in rules.items():
            for j in range(per):
                layer = stage * per + j
                trees = [want_g] + ([runs["jax"][("pipe_grads", case)]] if ("pipe_grads", case) in runs["jax"] else [])
                for tree in trees:
                    w = _layer_leaf(tree, layer, path)
                    np.testing.assert_allclose(got[f"g/{name}"][j], w.T if kind == LINEAR else w, atol=3e-5, rtol=0,
                                               err_msg=f"rank {r} layer_{layer}.{name}")


@pytest.mark.parametrize("k", [1, 2])
def test_moe_data_expert_matches_jax_unsharded(runs, k):
    want_y, want_aux, want_g, routed = runs["jax"][("moe", k)]
    assert routed < MOE["tokens"] * k  # the capacity binds: JAX drops tokens
    per = MOE["experts"] // 2
    ranks = runs["ranks"][f"moe_k{k}"]
    assert sorted(ranks) == list(range(WORLD))
    for r, got in ranks.items():
        e = r % 2
        assert int(got["expert_index"]) == e and tuple(got["experts"]) == (e * per, (e + 1) * per)
        np.testing.assert_allclose(got["y"], want_y, rtol=2e-5, atol=2e-5)
        assert abs(float(got["aux"]) / want_aux - 1) <= 1e-6
        for name, w in want_g.items():
            block = w[e * per:(e + 1) * per] if name != "router" else w
            assert got[f"local/{name}"].shape == block.shape, name
            err = np.abs(got[f"g/{name}"] - block).max() / np.abs(block).max()
            assert err <= 2e-5, (r, name, err)
        assert (np.abs(got["g/w1"]).sum(axis=(1, 2)) > 0).all()  # each held expert trains


@pytest.mark.parametrize("k", [1, 2])
def test_moe_checkpoint_is_the_reference_layout(runs, k):
    """Every rank's ``state_dict`` gathers the expert leaves back: JAX's
    parameters, whole and bit for bit; each rank held its block."""
    params = runs["inputs"]["moe"][k]["params"]
    per = MOE["experts"] // 2
    for r, got in runs["ranks"][f"moe_k{k}"].items():
        for name, w in params.items():
            np.testing.assert_array_equal(got[f"saved/{name}"], w)
            np.testing.assert_array_equal(got[f"local/{name}"],
                                          w if name == "router" else w[(r % 2) * per:(r % 2 + 1) * per])
