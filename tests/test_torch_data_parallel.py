"""The port's data-parallel layer on the CPU: real gloo process groups.

``tests/_torch_mp_worker.py`` runs as 2 processes, as 1 process (a group of
one) and, for the sample-mixing sites, as 4, joined through a ``file://``
store (no TCP port, so test workers never collide), each pinned to one
thread. The contract is JAX's SPMD meaning, as in ``tests/test_multiprocess.py``:
an N-rank step on N per-rank batches equals the 1-rank step on their
concatenation, within the family's parity bar. The tiny CLIP-ViP run is also
held to the JAX package's single-process 8-device run, computed here.
"""

import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.parallel import mesh as mesh_lib  # noqa: E402

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "_torch_mp_worker.py")
sys.path.insert(0, TESTS)

TRAIN_CASES = ("clipvip", "clipvip_bf16", "lfvila1", "lfvila2", "hdvila1")
SPAWN_TIMEOUT = 120  # seconds, per spawn: a hang fails its test, not the suite's clock


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _spawn(out_dir: str, world: int, scenarios) -> tuple[float, list]:
    """Start ``world`` ranks of the worker, each writing its output to
    ``<out_dir>/rank<r>.log`` (a file, not a pipe: a rank never waits for
    this process to read it); returns (their deadline, the processes)."""
    os.makedirs(out_dir, exist_ok=True)
    store = os.path.join(out_dir, "store")
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   MKL_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.pop("MASTER_ADDR", None)
        env.pop("MASTER_PORT", None)
        with open(os.path.join(out_dir, f"rank{rank}.log"), "w") as log:
            procs.append(subprocess.Popen([sys.executable, WORKER, out_dir, store, *scenarios], env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
    return time.monotonic() + SPAWN_TIMEOUT, procs


def _wait(spawn) -> list:
    deadline, procs = spawn
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        pytest.fail(f"a rank did not finish within {SPAWN_TIMEOUT} s")
    outs = []
    for rank, p in enumerate(procs):
        with open(os.path.join(p.args[2], f"rank{rank}.log")) as f:
            outs.append(f.read())
        assert p.returncode == 0, f"rank failed:\n{outs[-1][-4000:]}"
    return outs


def _jax_clipvip(root: str) -> dict:
    """``tests/_mp_worker.py``'s run in this process: one process over the 8
    virtual CPU devices. Writes the initial parameters for the workers
    first (as '/'-joined keys) and returns the run's results."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.data.datasets import RetrievalCollator, SyntheticVideoTextDataset
    from xpretrain_tpu.data.loader import BatchLoader, SequentialEvalLoader
    from xpretrain_tpu.data.tokenization import HashTokenizer
    from xpretrain_tpu.data.transforms import clip_transform
    from xpretrain_tpu.models.clip_vip import CLIPTextConfig, CLIPVipConfig, CLIPVisionConfig, CLIPViPModel, VipConfig
    from xpretrain_tpu.ops.losses import build_loss_fn
    from xpretrain_tpu.optim import build_optimizer, get_schedule
    from xpretrain_tpu.parallel.mesh import create_mesh, shard_host_batch
    from xpretrain_tpu.parallel.train_step import TrainState, make_eval_step, make_train_step, zero2_state_shardings
    from xpretrain_tpu.train.evaluate import evaluate_retrieval

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

    collate = RetrievalCollator(HashTokenizer(), max_txt_len=16)
    train_loader = BatchLoader(Transformed(48, seed=0), 16, collate, seed=0)
    val_loader = SequentialEvalLoader(Transformed(22, seed=7), 8, collate)
    sample = next(iter(train_loader))
    params = model.init(jax.random.PRNGKey(0), jnp.asarray(sample["video"][:1]),
                        jnp.asarray(sample["text_input_ids"][:1]), jnp.asarray(sample["text_input_mask"][:1]))["params"]
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(os.path.join(root, "clipvip_params.npz"), **flat)
    yield  # the workers start here

    mesh = create_mesh()
    tx, _ = build_optimizer(params, get_schedule("constant", 1e-3, 10, warmup_ratio=0.0), weight_decay=0.0)

    def apply_fn(p, b, r):
        return model.apply({"params": p}, b["video"], b["text_input_ids"], b["text_input_mask"])

    losses = []
    with mesh:
        step = make_train_step(apply_fn, tx, mesh, build_loss_fn("NCELearnableTempLoss"),
                               opt_state_shardings=zero2_state_shardings(tx, params, mesh, min_size=64), donate=False)
        state = TrainState.create(params, tx)
        for i, batch in enumerate(train_loader):
            if i >= 3:
                break
            state, metrics = step(state, shard_host_batch(batch, mesh), jax.random.PRNGKey(i))
            losses.append(float(metrics["loss"]))
        report = evaluate_retrieval(make_eval_step(apply_fn, mesh), state.params,
                                    (shard_host_batch(b, mesh) for b in val_loader), valid_len=val_loader.valid_len)
    yield {"losses": losses, "logit_scale": float(np.asarray(state.params["logit_scale"]).reshape(-1)[0]),
           "t2v": report["t2v"], "v2t": report["v2t"], "t2v_dsl": report["t2v_dsl"]}


@pytest.fixture(scope="module")
def runs():
    """{world: {scenario: [rank results]}} and the JAX run, with the 1-, 2-
    and 4-rank spawns running beside the JAX compile."""
    import json

    root = tempfile.mkdtemp(prefix="xpt_dp_")
    jax_run = _jax_clipvip(root)
    next(jax_run)
    spawns = {2: _spawn(os.path.join(root, "w2"), 2, TRAIN_CASES),
              1: _spawn(os.path.join(root, "w1"), 1, TRAIN_CASES),
              4: _spawn(os.path.join(root, "w4"), 4, ("units",))}
    try:
        jax_result = next(jax_run)
    except BaseException:
        for _, procs in spawns.values():
            for p in procs:
                p.kill()
        raise
    results = {}
    for world, spawn in spawns.items():
        _wait(spawn)
        names = ("units",) if world == 4 else TRAIN_CASES
        results[world] = {name: [json.load(open(os.path.join(root, f"w{world}", f"{name}_{r}.json")))
                                 for r in range(world)] for name in names}
    yield {"root": root, "results": results, "jax": jax_result}
    shutil.rmtree(root, ignore_errors=True)


# -- CLIP-ViP: 2 ranks == 1 rank == JAX's 8 devices ---------------------------


def test_clipvip_two_ranks_match_one_rank_and_the_jax_run(runs):
    r0, r1 = runs["results"][2]["clipvip"]
    (one,) = runs["results"][1]["clipvip"]
    jx = runs["jax"]
    # both ranks hold the same global metrics and report
    assert r0 == r1
    assert len(r0["losses"]) == 3 and all(np.isfinite(r0["losses"]))
    # the step averages the logit_scale metric over the ranks with the loss;
    # a replicated value's mean over 2 ranks is that value, bit for bit: the
    # forward's, not the updated parameter's
    for run in (r0, one):
        assert run["logit_scale_metrics"] == run["forward_logit_scales"]
    assert r0["forward_logit_scales"][1] != r0["forward_logit_scales"][0]
    for other in (one, jx):
        np.testing.assert_allclose(r0["losses"], other["losses"], rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(r0["logit_scale"], other["logit_scale"], rtol=1e-5)
        for block in ("t2v", "v2t", "t2v_dsl"):
            for k, v in other[block].items():
                np.testing.assert_allclose(r0[block][k], v, rtol=0, atol=1e-9, err_msg=f"{block}/{k}")


# -- ZeRO-2: sharded state and a 2-rank checkpoint resumed at 1 rank -----------


def test_zero2_state_is_one_nth_per_rank(runs):
    ranks = runs["results"][2]["clipvip_bf16"]
    (one,) = runs["results"][1]["clipvip_bf16"]
    sharded = 0
    for name, (mu, nu, master, numel, is_sharded) in one["sizes"].items():
        per_rank = [r["sizes"][name] for r in ranks]
        if per_rank[0][4]:
            sharded += 1
            assert numel >= 64
            # each rank keeps 1/N of the moments and of the master
            assert all(p[:3] == [mu // 2, nu // 2, master // 2] for p in per_rank), name
        else:
            assert all(p[:3] == [mu, nu, master] for p in per_rank), name
    assert sharded > 10
    assert max(r["state_bytes"] for r in ranks) < 0.55 * one["state_bytes"]
    # the first step starts from the same parameters; after it, bf16 storage
    # rounds the masters' last-bit differences (the gradients' summation
    # order) to a bf16 ulp now and then
    np.testing.assert_allclose(ranks[0]["losses"][0], one["losses"][0], rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(ranks[0]["losses"], one["losses"], rtol=1e-3)


def test_two_rank_zero2_checkpoint_resumes_at_one_rank(runs, tmp_path):
    import _torch_mp_worker as worker

    root = runs["root"]
    saved = torch.load(os.path.join(root, "w2", "clipvip_bf16", "ckpt", "2.pt"), weights_only=True)
    # a fresh 1-rank trainer takes the 2-rank state as it was saved: full
    # tensors, masters included
    params = os.path.join(root, "clipvip_params.npz")
    trainer = worker._clipvip_trainer(str(tmp_path / "probe"), params, param_dtype="bf16")
    trainer.model.load_state_dict(saved["model"])
    trainer.optimizer.load_state_dict(saved["optimizer"])
    got = trainer.optimizer.state_dict()
    for key in ("mu", "nu", "master"):
        assert set(got[key]) == set(saved["optimizer"][key])
        for name, value in saved["optimizer"][key].items():
            assert torch.equal(got[key][name], value), (key, name)
    named = dict(trainer.model.named_parameters())
    for name, master in got["master"].items():
        assert torch.equal(named[name], master.to(named[name].dtype)), name

    # and trains on from it: step 3 at one rank == step 3 at two ranks
    run_dir = os.path.join(root, "resume")
    os.makedirs(os.path.join(run_dir, "ckpt"))
    shutil.copy(os.path.join(root, "w2", "clipvip_bf16", "ckpt", "2.pt"), os.path.join(run_dir, "ckpt"))
    trainer = worker._clipvip_trainer(run_dir, params, param_dtype="bf16")
    rows = worker._record(trainer)
    trainer.train()
    final = torch.load(os.path.join(root, "w2", "clipvip_bf16", "final.pt"), weights_only=True)
    np.testing.assert_allclose(rows[0]["loss"], runs["results"][2]["clipvip_bf16"][0]["losses"][2], rtol=2e-5)
    # Adam's normalized step turns the gradients' last-bit differences (their
    # summation order) into a few percent of the 1e-3 step where a gradient
    # is near zero: each master within a tenth of a step, and step 3's update
    # within 1% norm-wise
    state = trainer.optimizer.state_dict()
    for name, master in final["optimizer"]["master"].items():
        got, want = state["master"][name].double(), master.double()
        update = want - saved["optimizer"]["master"][name].double()
        assert (got - want).abs().max() < 1e-4, name
        assert (got - want).norm() <= 1e-2 * update.norm(), name


# -- LF-VILA and HD-VILA: 2 ranks == 1 rank -----------------------------------


@pytest.mark.parametrize("case, tol", [("lfvila1", 5e-5), ("lfvila2", 5e-5), ("hdvila1", 1e-4)])
def test_two_ranks_match_one_rank(runs, case, tol):
    r0, r1 = runs["results"][2][case]
    (one,) = runs["results"][1][case]
    assert r0 == r1
    for got, want in zip(r0["metrics"], one["metrics"]):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol, err_msg=key)
    a = torch.load(os.path.join(runs["root"], "w2", case, "final.pt"), weights_only=True)
    b = torch.load(os.path.join(runs["root"], "w1", case, "final.pt"), weights_only=True)
    for name, value in b.items():
        np.testing.assert_allclose(a[name].numpy(), value.numpy(), atol=tol, rtol=0, err_msg=name)


def test_lfvila_stage2_mlm_counts_differ_between_ranks(runs):
    """The global MLM mean is exercised: the two ranks mask different
    numbers of tokens in the positive half (rank 1's rows)."""
    r0, _ = runs["results"][2]["lfvila2"]
    assert all(np.isfinite(m["mlm_loss"]) and m["mlm_loss"] > 0 for m in r0["metrics"])


# -- the sample-mixing sites at 4 ranks against one process --------------------


@pytest.mark.parametrize("site, keys", [
    ("vtm_roll", ("vtm", "vtm_grad")),
    ("mlm_global_mean", ("mlm_loss", "mlm_grad")),
    ("contrastive_and_mtc", ("contrastive_loss", "contrastive_grad")),
])
def test_global_batch_site_matches_one_process(runs, site, keys):
    for rank in runs["results"][4]["units"]:
        for key in keys:
            assert rank[key] < 1e-5, (site, key, rank[key])


def test_vtm_labels_and_rerank_captions_follow_the_global_batch(runs):
    for rank in runs["results"][4]["units"]:
        assert rank["vtm_labels"] and rank["rerank_ids"]


def test_mlm_case_has_unequal_counts_per_rank(runs):
    counts = [r["mlm_counts"] for r in runs["results"][4]["units"]]
    assert len(set(counts)) > 1


def test_ranks_draw_different_dropout_masks(runs):
    """Each rank's step generator is a function of (seed + s, rank); rank 0's
    is a process's without a group (ROADMAP Queue 3, a deliberate
    difference from JAX's one global mask)."""
    for rank in runs["results"][4]["units"]:
        assert rank["draws_distinct"] and rank["rank0_draw_is_the_ungrouped_draw"]


# -- the group's set-up ------------------------------------------------------------


def test_no_world_size_means_no_group(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh_lib.maybe_init_distributed("cpu") is None
    assert mesh_lib.process_index_count() == (0, 1)
    x = torch.arange(4.0)
    assert mesh_lib.gather_rows(x) is x


def test_world_size_two_with_a_failing_init_raises(monkeypatch, tmp_path):
    import datetime

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(RuntimeError, match="did not form"):
        # the second rank never joins the store
        mesh_lib.maybe_init_distributed("cpu", init_method=f"file://{tmp_path / 'store'}",
                                        timeout=datetime.timedelta(seconds=2))
    assert mesh_lib.current_mesh() is None
    assert not torch.distributed.is_initialized()


def test_world_size_two_on_cuda_without_a_card_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh_lib.maybe_init_distributed("cuda")
    assert mesh_lib.current_mesh() is None


@pytest.mark.parametrize("flag, world, match", [
    ({"tp": 2, "cp": 4}, 8, "share the mesh's model axis"),  # tp != cp, both > 1
    ({"tp": 4}, 6, "does not divide the 6"),  # mp does not divide the world
    ({"tp": 2}, None, "does not divide the 1"),  # no group: JAX's 2 on one device
    ({"cp": 2}, None, "does not divide the 1"),
])
def test_invalid_layouts_raise_as_in_jax(monkeypatch, flag, world, match):
    """``mesh_from_config`` refuses what JAX's refuses, before any group
    forms (a world of ``world`` ranks stands in for a group)."""
    if world is not None:
        monkeypatch.setattr(mesh_lib, "_MESH", mesh_lib.DataMesh(rank=0, world_size=world,
                                                                 device=torch.device("cpu"), backend="gloo"))
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda group=None: world)
    with pytest.raises(ValueError, match=match):
        mesh_lib.mesh_from_config(flag)


def test_a_tensor_off_the_groups_device_is_refused():
    """A gloo group takes CPU tensors only (a CUDA tensor never goes through
    it); a tensor elsewhere raises before any collective."""
    group = mesh_lib.DataMesh(rank=0, world_size=2, device=torch.device("cpu"), backend="gloo")
    for call in (lambda t: mesh_lib.gather_rows(t, group), lambda t: mesh_lib.all_reduce_sum(t, group),
                 lambda t: mesh_lib.all_reduce_mean_([t], group)):
        with pytest.raises(RuntimeError, match="cannot go through the gloo group"):
            call(torch.empty(2, device="meta"))


def test_local_batch_and_host_batch_shard():
    assert mesh_lib.local_batch_size(16) == 16
    batch = {"x": np.arange(12).reshape(6, 2), "k": np.arange(2 * 6).reshape(2, 6), "s": 3}
    placed = mesh_lib.shard_host_batch(batch)
    assert torch.equal(placed["x"], torch.arange(12).reshape(6, 2)) and placed["s"] == 3
    two = mesh_lib.DataMesh(rank=1, world_size=2, device=torch.device("cpu"), backend="gloo")
    assert mesh_lib.local_batch_size(16, two) == 8
    with pytest.raises(ValueError):
        mesh_lib.local_batch_size(15, two)
    mine = mesh_lib.shard_host_batch(batch, two)
    assert torch.equal(mine["x"], torch.arange(6, 12).reshape(3, 2))
    stacked = mesh_lib.shard_host_batch({"k": batch["k"]}, two, leading_stack=True)
    assert torch.equal(stacked["k"], torch.tensor([[3, 4, 5], [9, 10, 11]]))
