"""The port's model-axis layouts on the CPU: ``--tp``, ``--zero3`` and both,
on real gloo process groups of 4 ranks.

``tests/_torch_mp_worker.py`` runs at 4 ranks (the tiny CLIP-ViP case and
the loader / dropout check, then the LF-VILA and HD-VILA cases) and at 1 rank
(the families' one-rank references), each rank pinned to one thread, while
this process runs the JAX package's sharded CLIP-ViP steps on its virtual
CPU devices: ``--tp 2`` on a (2, 2) mesh (``tp_param_shardings`` +
``hybrid_state_shardings``), ``--zero3 1`` on (4,) and ``--zero3 1 --tp 2``
on (2, 2) (``fsdp_param_shardings`` / ``fsdp_state_shardings``), with the
set-up of ``tests/test_tensor_parallel_families.py:_run_steps``. The bars
are JAX's own TP = DP bars: loss 2e-5 relative, parameters atol 3e-5 /
rtol 1e-4 (LF-VILA 5e-5 and HD-VILA 1e-4 against the one-rank port).
"""

import json
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

LAYOUTS = {"clipvip_tp": ((2, 2), dict(tp=2)), "clipvip_zero3": ((4,), dict(zero3=1)),
           "clipvip_zero3_tp": ((2, 2), dict(tp=2, zero3=1))}
MP_CASES = ("clipvip_tp", "clipvip_zero3", "clipvip_zero3_tp", "units_mp")
FAMILY_CASES = ("lfvila1_tp", "hdvila1_tp", "lfvila1_cp", "lfvila1_tpcp")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _jax_layouts(root: str):
    """The tiny CLIP-ViP case (``tests/_torch_mp_worker.py``) as the JAX
    package runs it under each layout: writes the initial parameters, yields
    for the workers to start, then yields {layout: (losses, final parameters
    by port name)}."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.data.datasets import RetrievalCollator, SyntheticVideoTextDataset
    from xpretrain_tpu.data.loader import BatchLoader
    from xpretrain_tpu.data.tokenization import HashTokenizer
    from xpretrain_tpu.data.transforms import clip_transform
    from xpretrain_tpu.models.clip_vip import CLIPTextConfig, CLIPVipConfig, CLIPVisionConfig, CLIPViPModel, VipConfig
    from xpretrain_tpu.ops.losses import build_loss_fn
    from xpretrain_tpu.optim import build_optimizer, get_schedule
    from xpretrain_tpu.parallel.fsdp import fsdp_param_shardings, fsdp_state_shardings
    from xpretrain_tpu.parallel.mesh import create_mesh, shard_host_batch
    from xpretrain_tpu.parallel.tensor_parallel import hybrid_state_shardings, tp_param_shardings
    from xpretrain_tpu.parallel.train_step import TrainState, make_train_step
    from xpretrain_tpu_torch.models.clip_vip.convert import LINEAR, clip_key_rules

    cfg = CLIPVipConfig(
        text=CLIPTextConfig(vocab_size=49408, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                            num_attention_heads=4, max_position_embeddings=16),
        vision=CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                                image_size=32, patch_size=16),
        vip=VipConfig(temporal_size=2, add_cls_num=2), projection_dim=16, dtype=jnp.float32)
    model = CLIPViPModel(cfg)

    class Transformed:
        def __init__(self, size, seed):
            self.ds = SyntheticVideoTextDataset(size=size, num_frames=2, image_size=32, seed=seed)

        def __len__(self):
            return len(self.ds)

        def __getitem__(self, i):
            item = self.ds[i]
            item["video"] = clip_transform(item["frames"], 32)
            return item

    loader = BatchLoader(Transformed(48, seed=0), 16, RetrievalCollator(HashTokenizer(), max_txt_len=16), seed=0)
    batches = []
    for batch in loader:
        batches.append(batch)
        if len(batches) == 2:
            break
    sample = batches[0]
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(sample["video"][:1]),
                        jnp.asarray(sample["text_input_ids"][:1]), jnp.asarray(sample["text_input_mask"][:1]))["params"]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(os.path.join(root, "clipvip_params.npz"), **flat)
    yield  # the workers start here

    rules = clip_key_rules(2, 2)

    def port_names(p):
        out = {}
        for path, v in jax.tree_util.tree_flatten_with_path(p)[0]:
            key = tuple(str(getattr(k, "key", k)) for k in path)
            name, kind = next((n, kd) for n, (pth, kd) in rules.items() if pth == key)
            v = np.asarray(v)
            out[name] = v.T if kind == LINEAR else v
        return out

    def apply_fn(p, b, r):
        return model.apply({"params": p}, b["video"], b["text_input_ids"], b["text_input_mask"])

    results = {}
    for name, (shape, layout) in LAYOUTS.items():
        tp = layout.get("tp", 1)
        mesh = create_mesh(shape, ("data", "model") if len(shape) == 2 else ("data",), devices=jax.devices()[:4])
        tx, _ = build_optimizer(params, get_schedule("cosine", 1e-3, 100), weight_decay=0.1)
        if layout.get("zero3"):
            pshard = fsdp_param_shardings(params, mesh, tp=tp, min_size=64)
            oshard = fsdp_state_shardings(tx, params, mesh, tp=tp, min_size=64)
        else:
            pshard = tp_param_shardings(params, mesh)
            oshard = hybrid_state_shardings(tx, params, mesh, min_size=64)
        losses, norms = [], []
        with mesh:
            step = make_train_step(apply_fn, tx, mesh, build_loss_fn("NCELearnableTempLoss"),
                                   param_shardings=pshard, opt_state_shardings=oshard, donate=False)
            state = TrainState.create(params, tx)
            state = state.replace(params=jax.device_put(state.params, pshard),
                                  opt_state=jax.device_put(state.opt_state, oshard))
            for i, batch in enumerate(batches):
                state, metrics = step(state, shard_host_batch(batch, mesh), jax.random.PRNGKey(i))
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        results[name] = (losses, norms, port_names(state.params))
    yield results


@pytest.fixture(scope="module")
def runs():
    """{world: {scenario: [rank results]}}, the JAX runs, and the root."""
    root = tempfile.mkdtemp(prefix="xpt_mp_")
    jax_run = _jax_layouts(root)
    next(jax_run)
    spawns = {"mp": _spawn(os.path.join(root, "mp"), 4, MP_CASES),
              "families": _spawn(os.path.join(root, "families"), 4, FAMILY_CASES),
              "one": _spawn(os.path.join(root, "one"), 1, ("lfvila1", "hdvila1"))}
    try:
        jax_result = next(jax_run)
    except BaseException:
        for _, procs in spawns.values():
            for p in procs:
                p.kill()
        raise
    results = {}
    for key, spawn in spawns.items():
        _wait(spawn)
        names = {"mp": MP_CASES, "families": FAMILY_CASES, "one": ("lfvila1", "hdvila1")}[key]
        world = len(spawn[1])
        results[key] = {n: [json.load(open(os.path.join(root, key, f"{n}_{r}.json"))) for r in range(world)]
                        for n in names}
    yield {"root": root, "results": results, "jax": jax_result}
    shutil.rmtree(root, ignore_errors=True)


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_clipvip_layout_matches_the_jax_sharded_step(runs, case):
    ranks = runs["results"]["mp"][case]
    jax_losses, jax_norms, jax_params = runs["jax"][case]
    # every rank holds the global metrics, and the same replicated parameters
    assert all(r["losses"] == ranks[0]["losses"] and r["grad_norms"] == ranks[0]["grad_norms"] for r in ranks)
    assert all(r["replicated"] == ranks[0]["replicated"] for r in ranks)
    np.testing.assert_allclose(ranks[0]["losses"], jax_losses, rtol=2e-5)
    # the norm of the global gradient: each element counted once
    np.testing.assert_allclose(ranks[0]["grad_norms"], jax_norms, rtol=2e-5)
    final = torch.load(os.path.join(runs["root"], "mp", case, "final.pt"), weights_only=True)["model"]
    assert set(final) == set(jax_params)
    for name, want in jax_params.items():
        np.testing.assert_allclose(final[name].numpy(), want, atol=3e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", list(LAYOUTS))
def test_each_rank_holds_its_share_of_every_sharded_leaf(runs, case):
    """TP leaves at 1/mp, ZeRO-3 leaves at 1/dp (1/(mp * dp) for both), the
    moments as the leaf; and the port shards every leaf JAX's policy shards
    (no attention of the tiny model has heads the model axis cannot divide)."""
    from xpretrain_tpu_torch.config import ConfigDict
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel
    from xpretrain_tpu_torch.parallel.fsdp import resolve_shardings
    import _torch_mp_worker as worker

    shape, layout = LAYOUTS[case]
    mp = shape[1] if len(shape) == 2 else 1
    dp = shape[0]
    for rank in runs["results"]["mp"][case]:
        shards = rank["shards"]
        assert shards
        for name, (local, full, moment, on_model, on_data) in shards.items():
            factor = (mp if on_model else 1) * (dp if on_data else 1)
            assert factor > 1 and local * factor == full and moment == local, (name, local, full, factor)
    model = CLIPViPModel(worker._clipvip_config())
    specs, _ = resolve_shardings(ConfigDict(layout), model, dp, mp, min_size=64)
    want = {n for n, s in specs.items() if any(a is not None for a in s)}
    assert set(runs["results"]["mp"][case][0]["shards"]) == want


def test_a_tp_zero3_checkpoint_resumes_at_one_rank(runs, tmp_path):
    """The (2, 2) ``--tp 2 --zero3 1`` run's step-1 checkpoint is in the
    reference layout and a one-process trainer resumes from it into the
    4-rank run's step 2."""
    import _torch_mp_worker as worker

    root = runs["root"]
    saved = torch.load(os.path.join(root, "mp", "clipvip_zero3_tp", "ckpt", "1.pt"), weights_only=True)
    params = os.path.join(root, "clipvip_params.npz")
    run_dir = tmp_path / "resume"
    (run_dir / "ckpt").mkdir(parents=True)
    shutil.copy(os.path.join(root, "mp", "clipvip_zero3_tp", "ckpt", "1.pt"), run_dir / "ckpt")
    trainer = worker._clipvip_trainer(str(run_dir), params, **worker.JAX_STEP)
    trainer.num_train_steps = worker.MP_STEPS
    named = dict(trainer.model.named_parameters())
    assert {k: tuple(v.shape) for k, v in saved["model"].items()} == {k: tuple(v.shape) for k, v in named.items()}
    rows = worker._record(trainer)
    trainer.train()
    four = runs["results"]["mp"]["clipvip_zero3_tp"][0]
    np.testing.assert_allclose(rows[0]["loss"], four["losses"][1], rtol=2e-5)
    final = torch.load(os.path.join(root, "mp", "clipvip_zero3_tp", "final.pt"), weights_only=True)["model"]
    for name, value in trainer.model.state_dict().items():
        np.testing.assert_allclose(value.numpy(), final[name].numpy(), atol=3e-5, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("case", ["clipvip_zero3", "clipvip_zero3_tp"])
def test_a_file_of_one_layout_loads_under_another(runs, case):
    """The ``--tp 2`` run's final model and optimizer state, loaded under
    ZeRO-3 on (4,) and under ``--tp 2 --zero3 1`` on (2, 2), gathers back to
    the file bit for bit on every rank."""
    assert all(rank["cross_layout_load"] for rank in runs["results"]["mp"][case])


def test_model_group_reads_the_same_rows_and_draws_the_same_masks(runs):
    """On a (2, 2) mesh the loaders take the data index and count, so the
    two ranks of a model group read the same rows and seed the same dropout
    generator; the two data indices read and draw different ones."""
    ranks = runs["results"]["mp"]["units_mp"]
    by_data: dict = {}
    for r in ranks:
        assert r["process_index_count"] == [r["data_index"], 2]
        by_data.setdefault(r["data_index"], []).append(r)
    assert sorted(by_data) == [0, 1]
    for peers in by_data.values():
        assert len(peers) == 2 and {p["model_index"] for p in peers} == {0, 1}
        assert peers[0]["rows"] == peers[1]["rows"] and peers[0]["mask"] == peers[1]["mask"]
    assert by_data[0][0]["rows"] != by_data[1][0]["rows"]
    assert by_data[0][0]["mask"] != by_data[1][0]["mask"]


@pytest.mark.parametrize("layout, case, tol", [
    ("lfvila1_tp", "lfvila1", 5e-5), ("hdvila1_tp", "hdvila1", 1e-4),
    ("lfvila1_cp", "lfvila1", 5e-5), ("lfvila1_tpcp", "lfvila1", 5e-5),
])
def test_family_layout_matches_one_rank(runs, layout, case, tol):
    """Two steps on a (2, 2) mesh against one rank on the same global
    batches: LF-VILA and HD-VILA stage 1 at ``--tp 2``, LF-VILA at ``--cp 2``
    and at both."""
    ranks = runs["results"]["families"][layout]
    (one,) = runs["results"]["one"][case]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol, err_msg=key)
    a = torch.load(os.path.join(runs["root"], "families", layout, "final.pt"), weights_only=True)
    b = torch.load(os.path.join(runs["root"], "one", case, "final.pt"), weights_only=True)
    assert set(a) == set(b)
    for name, value in b.items():
        np.testing.assert_allclose(a[name].numpy(), value.numpy(), atol=tol, rtol=0, err_msg=name)
    # the transformer blocks the layout shards are sharded over the model
    # axis (under --cp Swin3D keeps its attention whole and shards frames)
    shards = ranks[0]["shards"]
    wanted = {"lfvila1_tp": ("qkv.weight", "query.weight"), "hdvila1_tp": ("query.weight", "intermediate_dense.weight"),
              "lfvila1_cp": (), "lfvila1_tpcp": ("query.weight",)}[layout]
    for suffix in wanted:
        assert any(n.endswith(suffix) and on_model for n, (*_, on_model, _) in shards.items()), suffix
    if layout.endswith("cp"):
        assert not any(n.startswith("video_encoder.") for n in shards)
