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
  reference layout;
- around those cases, the run's mesh: ``create_mesh`` returns its mesh and
  leaves the current one, and a global-batch ``gather_rows`` through it, as
  they were (JAX's ``create_mesh`` only builds a ``Mesh``).

In this process, with no group: ``create_mesh((1,), (axis,), devices=[cpu])``
is JAX's one-device mesh, and the three modules on it match JAX's on
``create_mesh((1,), (axis,), devices=jax.devices()[:1])`` (2e-5; gradients
3e-5·max|g|, the MoE's 2e-5·max|g|) and equal the port's ``mesh=None`` calls
bit for bit; a shape that does not cover the devices raises JAX's
``ValueError``.
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


def test_create_mesh_leaves_the_run_mesh(runs):
    """On 4 ranks, before and after each ``create_mesh`` (the two explicit
    calls, then the six of the cases): the current mesh is the same object
    and ``gather_rows`` of each rank's [2, 3] block gives the 8 global rows;
    ``devices`` that do not count the ranks raise JAX's ``ValueError``."""
    want = np.concatenate([np.arange(6, dtype=np.float32).reshape(2, 3) + 10 * r for r in range(WORLD)])
    ranks = runs["ranks"]["run_mesh"]
    assert sorted(ranks) == list(range(WORLD))
    for r, got in ranks.items():
        assert int(got["world"]) == WORLD and got["same"].tolist() == [True] * 4, r
        for i in range(4):
            np.testing.assert_array_equal(got[f"rows{i}"], want, err_msg=f"rank {r}, gather {i}")
        assert "does not cover 2 devices" in str(got["raised"]), got["raised"]


def _one_process_ring(mesh, jmesh, jax, jnp):
    """Ring attention on the one-rank mesh and on JAX's one-device mesh:
    (port out, port grads, JAX out, JAX grads, the port's mesh=None run)."""
    from xpretrain_tpu.ops.ring_attention import make_ring_attention as jax_ring
    from xpretrain_tpu_torch.ops.ring_attention import make_ring_attention, sequence_block

    rng = np.random.default_rng(3)
    q, k, v, target = (rng.normal(size=(2, 4, 48, 16)).astype(np.float32) for _ in range(4))
    mask = np.ones((2, 48), np.int32)
    mask[0, -10:] = 0

    def loss(qkv):
        o = jax_ring(jmesh)(*qkv, mask)
        return jnp.mean((o - target) ** 2), o

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))((q, k, v))

    def port(m):
        args = [sequence_block(torch.from_numpy(a), m).requires_grad_(True) for a in (q, k, v)]
        out = make_ring_attention(m)(*args, torch.from_numpy(mask))
        ((out - torch.from_numpy(target)) ** 2).mean().backward()
        return out.detach().numpy(), [a.grad.numpy() for a in args]

    return (*port(mesh), np.asarray(want), [np.asarray(g) for g in want_g], port(None))


def _one_process_pipe(mesh, jmesh, jax, jnp):
    """The tiny BERT pipeline (2 microbatches, padding mask), gradients of a
    mean-squared loss with respect to the stacked leaves."""
    from xpretrain_tpu.models.bert import BertConfig as JaxBertConfig, StagedBertEncoder
    from xpretrain_tpu.models.common import expand_padding_mask as jax_expand
    from xpretrain_tpu.parallel import pipeline as jpipe
    from xpretrain_tpu_torch.models.bert import BertConfig
    from xpretrain_tpu_torch.models.common import expand_padding_mask
    from xpretrain_tpu_torch.parallel.pipeline import (
        pipeline_param_shardings,
        pipelined_bert_encoder,
        stacked_bert_params_from_flax,
    )

    rng = np.random.default_rng(4)
    hidden = rng.normal(size=(4, 10, 32)).astype(np.float32)
    target = rng.normal(size=hidden.shape).astype(np.float32)
    pad = np.ones((4, 10), np.int32)
    pad[1, 6:] = 0
    jcfg, L = JaxBertConfig(**BERT), BERT["num_hidden_layers"]
    params = jax.jit(lambda key: StagedBertEncoder(jcfg).init(key, hidden, None))(jax.random.PRNGKey(0))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    run = jpipe.pipelined_bert_encoder(jcfg, jmesh, n_microbatches=2)
    jmask = jax_expand(jnp.asarray(pad))

    def loss(p):
        o = run(jpipe.stack_layer_params(p, L), hidden, jmask)
        return jnp.mean((o - target) ** 2), o

    (_, want), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    cfg = BertConfig(**BERT)
    want_g = stacked_bert_params_from_flax(jax.tree_util.tree_map(np.asarray, want_g), cfg)  # the same transposes

    def port(m):
        stacked = {n: t.requires_grad_(True) for n, t in stacked_bert_params_from_flax(params, cfg).items()}
        out = pipelined_bert_encoder(cfg, m, n_microbatches=2)(pipeline_param_shardings(stacked, m),
                                                               torch.from_numpy(hidden),
                                                               expand_padding_mask(torch.from_numpy(pad)))
        ((out - torch.from_numpy(target)) ** 2).mean().backward()
        return out.detach().numpy(), [stacked[n].grad.numpy() for n in sorted(stacked)]

    return (*port(mesh), np.asarray(want), [want_g[n].numpy() for n in sorted(want_g)], port(None))


def _one_process_moe(mesh, jmesh, jax, jnp):
    """The MoE FFN, top-2 at a capacity factor that drops tokens: y and the
    gradients of ``mean(y**2) + 0.01·aux`` (``aux`` is held apart)."""
    from xpretrain_tpu.parallel.moe import MoeFfn as JaxMoeFfn
    from xpretrain_tpu_torch.parallel.moe import MoeFfn, moe_params_from_flax

    x = np.random.default_rng(5).normal(size=(MOE["tokens"], MOE["d"])).astype(np.float32)
    kw = dict(num_experts=MOE["experts"], d_ff=MOE["d_ff"], num_selected=2, capacity_factor=MOE["capacity_factor"])
    params = jax.jit(JaxMoeFfn(**kw).init)(jax.random.PRNGKey(2), jnp.asarray(x))
    model = JaxMoeFfn(**kw, expert_axis="expert", mesh=jmesh)

    def loss(p):
        y, aux = model.apply(p, x)
        return jnp.mean(y**2) + 0.01 * aux, (y, aux)

    (_, (want, want_aux)), want_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)

    def port(m):
        ffn = MoeFfn(MOE["d"], MOE["experts"], MOE["d_ff"], num_selected=2, capacity_factor=MOE["capacity_factor"],
                     expert_axis="expert", mesh=m)
        ffn.load_state_dict(moe_params_from_flax(params))
        y, aux = ffn(torch.from_numpy(x))
        assert abs(aux.item() / float(want_aux) - 1) <= 1e-6
        ((y**2).mean() + 0.01 * aux).backward()
        return y.detach().numpy(), [p.grad.numpy() for _, p in sorted(ffn.named_parameters())]

    names = sorted(want_g["params"])
    return (*port(mesh), np.asarray(want), [np.asarray(want_g["params"][n]) for n in names], port(None))


# axis -> (case, gradient bar relative to max|g|, per leaf or over all leaves:
# the pipeline's key biases get rounding alone, since the softmax ignores a
# constant added to a query's scores)
ONE_PROCESS = {"seq": (_one_process_ring, 3e-5, True), "pipe": (_one_process_pipe, 3e-5, False),
               "expert": (_one_process_moe, 2e-5, True)}


@pytest.mark.parametrize("axis", list(ONE_PROCESS))
def test_one_process_mesh_matches_jax_one_device(axis):
    """JAX's call sequence in one process with no group: ``create_mesh((1,),
    (axis,), devices=[cpu])`` returns a one-rank mesh and leaves no current
    mesh; the module on it matches JAX's on its one-device mesh and equals
    its own ``mesh=None`` run bit for bit."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from xpretrain_tpu_torch.parallel import mesh as mesh_lib

    assert mesh_lib.current_mesh() is None
    mesh = mesh_lib.create_mesh((1,), (axis,), devices=[torch.device("cpu")])
    assert mesh_lib.current_mesh() is None
    assert (mesh.world_size, mesh.model_size, mesh.model_axis, mesh.device) == (1, 1, axis, torch.device("cpu"))
    case, grad_rel, per_leaf = ONE_PROCESS[axis]
    out, grads, want, want_g, (none_out, none_grads) = case(
        mesh, jax_create_mesh((1,), (axis,), devices=jax.devices()[:1]), jax, jnp)
    np.testing.assert_allclose(out, want, atol=2e-5, rtol=0)
    assert len(grads) == len(want_g)
    gmax = max(np.abs(w).max() for w in want_g)
    for got, w in zip(grads, want_g):
        err = np.abs(got - w).max() / (np.abs(w).max() if per_leaf else gmax)
        assert got.shape == w.shape and err <= grad_rel, (got.shape, err)
    np.testing.assert_array_equal(out, none_out)
    for got, w in zip(grads, none_grads):
        np.testing.assert_array_equal(got, w)
    assert mesh_lib.current_mesh() is None


def test_a_mesh_that_does_not_cover_the_devices_raises():
    """JAX's ``ValueError`` for a shape that does not cover the devices, in a
    process with no group: the text of JAX's own check on the same call."""
    import jax

    from xpretrain_tpu.parallel.mesh import create_mesh as jax_create_mesh
    from xpretrain_tpu_torch.parallel import mesh as mesh_lib

    cpu = torch.device("cpu")
    for shape, names, n in (((2,), ("seq",), 1), ((1,), ("pipe",), 2), ((1, 2), ("data", "expert"), 1)):
        with pytest.raises(ValueError, match=f"does not cover {n} devices") as want:
            jax_create_mesh(shape, names, devices=jax.devices()[:n])
        with pytest.raises(ValueError) as got:
            mesh_lib.create_mesh(shape, names, devices=[cpu] * n)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="does not cover 1 devices"):
        mesh_lib.create_mesh((4,), ("seq",))  # the default device, cuda:0, is one device
    assert mesh_lib.current_mesh() is None
