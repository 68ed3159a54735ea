"""The port's public helpers that no runner reaches, held to the JAX package's
(the cases of ``tests/test_metrics.py``, ``test_sample_frames.py``,
``test_utils_misc.py``, ``test_small_utils.py``, ``test_video_reader.py``,
``test_patchify.py``, ``test_mc_eval.py`` and ``test_optim.py``)."""

import json
import random
import time
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.config import ConfigDict, deep_update, dump_config, load_config_file  # noqa: E402
from xpretrain_tpu_torch.data import video_reader  # noqa: E402
from xpretrain_tpu_torch.data.sample_frames import FrameSampler  # noqa: E402
from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD  # noqa: E402
from xpretrain_tpu_torch.ops.patchify import normalize_u8  # noqa: E402
from xpretrain_tpu_torch.optim.optimizer import build_multi_schedule_optimizer  # noqa: E402
from xpretrain_tpu_torch.parallel.mesh import DataMesh, local_batch_size  # noqa: E402
from xpretrain_tpu_torch.train.evaluate import evaluate_multichoice_by_similarity  # noqa: E402
from xpretrain_tpu_torch.utils import basic  # noqa: E402
from xpretrain_tpu_torch.utils.logging import NoOp, RunningMeter  # noqa: E402
from xpretrain_tpu_torch.utils.metrics import compute_metrics_multi, cosine_sim  # noqa: E402
from xpretrain_tpu_torch.utils.prng import key_for_step, rank_seed, set_host_seed, split_dict  # noqa: E402
from xpretrain_tpu_torch.utils.profiling import StepTimer, flops_estimate, trace  # noqa: E402

# -- utils/metrics.py ----------------------------------------------------------------


def test_multi_positive():
    sim = np.array([[0.1, 0.9, 0.5], [0.2, 0.3, 0.8], [0.9, 0.1, 0.0]])
    mask = np.array([[1, 1, 0], [0, 0, 1], [1, 0, 0]])
    assert compute_metrics_multi(sim, mask)["R1"] == 100.0


def test_multi_positive_and_cosine_match_jax():
    from xpretrain_tpu.utils import metrics as jax_metrics

    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(20, 8)), rng.normal(size=(30, 8))
    np.testing.assert_array_equal(cosine_sim(a, b), jax_metrics.cosine_sim(a, b))
    sim, mask = rng.normal(size=(20, 30)), rng.random((20, 30)) < 0.1
    mask[3] = False  # a query without a positive is left out
    assert compute_metrics_multi(sim, mask) == jax_metrics.compute_metrics_multi(sim, mask)


# -- data/sample_frames.py:FrameSampler ---------------------------------------------------


def test_test_mode_deterministic_centered():
    s = FrameSampler(clip_len=4, frame_interval=2, num_clips=3, test_mode=True)
    a, b = s(100), s(100)
    assert np.array_equal(a, b) and a.shape == (12,) and a.min() >= 0 and a.max() < 100


def test_train_mode_within_bounds_and_seeded():
    s = FrameSampler(clip_len=8, frame_interval=1, num_clips=2)
    a, b = s(50, np.random.default_rng(7)), s(50, np.random.default_rng(7))
    assert np.array_equal(a, b) and a.shape == (16,) and a.min() >= 0 and a.max() < 50


def test_short_video_loops_and_repeat_last_clamps():
    inds = FrameSampler(clip_len=12, frame_interval=1, num_clips=1, test_mode=True)(5)
    assert inds.shape == (12,) and inds.max() < 5
    inds = FrameSampler(clip_len=6, frame_interval=4, num_clips=1, out_of_bound_opt="repeat_last", test_mode=True)(10)
    assert inds.max() < 10 and inds[-1] == inds[-2]
    with pytest.raises(ValueError):
        FrameSampler(clip_len=2, out_of_bound_opt="wrap")


def test_twice_sample_and_temporal_jitter():
    assert FrameSampler(clip_len=4, num_clips=3, test_mode=True, twice_sample=True)(100).shape == (24,)
    inds = FrameSampler(clip_len=4, frame_interval=3, num_clips=2, temporal_jitter=True)(100, np.random.default_rng(0))
    assert inds.min() >= 0 and inds.max() < 100


@pytest.mark.parametrize("kwargs, total", [
    (dict(clip_len=8, frame_interval=2, num_clips=3), 100),
    (dict(clip_len=8, frame_interval=3, num_clips=2, temporal_jitter=True), 40),
    (dict(clip_len=4, num_clips=4, keep_tail_frames=True), 9),
    (dict(clip_len=16, num_clips=2, out_of_bound_opt="repeat_last"), 12),
    (dict(clip_len=4, num_clips=3, test_mode=True, twice_sample=True), 30),
])
def test_frame_sampler_matches_jax(kwargs, total):
    from xpretrain_tpu.data.sample_frames import FrameSampler as JaxSampler

    for seed in range(3):
        got = FrameSampler(**kwargs)(total, np.random.default_rng(seed), start_index=1)
        want = JaxSampler(**kwargs)(total, np.random.default_rng(seed), start_index=1)
        np.testing.assert_array_equal(got, want)


# -- utils/profiling.py ------------------------------------------------------------------


def test_step_timer_skips_warm_up():
    t = StepTimer(skip=1)
    t.tick()
    time.sleep(0.05)  # the warm-up step, skipped
    t.tick()
    time.sleep(0.01)
    t.tick()
    s = t.summary(items_per_step=4)
    assert 0.005 < s["mean_s"] < 0.05 and s["items_per_s"] > 50
    assert StepTimer().summary() == {}


def test_flops_estimate_matmul():
    a, b = torch.zeros(64, 128), torch.zeros(128, 32)
    assert flops_estimate(lambda x, y: x @ y, a, b) == 2 * 64 * 32 * 128
    assert flops_estimate(lambda: 1 / 0) == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "prof")):
        torch.ones(8) @ torch.ones(8)
    with open(tmp_path / "prof" / "trace.json") as f:
        assert "traceEvents" in json.load(f)


# -- config.py, utils/logging.py, utils/basic.py -------------------------------------------


def test_config_dict_merge_and_paths(tmp_path):
    base = ConfigDict(a=1, nested=dict(x=1, y=2))
    deep_update(base, {"nested": {"y": 3, "z": 4}, "b": 5})
    assert base.nested.y == 3 and base.nested.x == 1 and base.nested.z == 4 and base.b == 5
    assert base.get_path("nested.z") == 4 and base.get_path("nested.missing", "dflt") == "dflt"
    p = tmp_path / "c.json"
    p.write_text(json.dumps(base.to_dict()))
    assert load_config_file(str(p)).nested.z == 4


def test_dump_config_roundtrip(tmp_path):
    cfg = ConfigDict({"lr": 5e-6, "nested": {"frames": 12}, "name": "b32"})
    path = tmp_path / "out" / "args.json"
    dump_config(cfg, str(path))
    loaded = load_config_file(str(path))
    assert loaded.lr == 5e-6 and loaded.nested.frames == 12
    raw = json.loads(path.read_text())
    assert list(raw) == sorted(raw)


def test_noop_and_meters():
    assert NoOp().anything(1, key=2) is None
    m = basic.AverageMeter()
    m.update(2.0)
    m.update(4.0, n=3)
    assert np.isclose(m.avg, 3.5)
    assert basic.flat_list_of_lists([[1, 2], [3]]) == [1, 2, 3]
    assert basic.chunk_list([1, 2, 3, 4, 5], 2) == [[1, 2], [3, 4], [5]]
    r = RunningMeter("loss", smooth=0.5)
    for v in (2.0, float("nan"), 4.0):
        r(v)
    assert np.isclose(r.val, 3.0)


def test_pickle_jsonl_and_zip(tmp_path):
    obj = {"a": [1, 2, 3], "b": np.arange(4)}
    basic.save_pickle(obj, str(tmp_path / "x.pkl"))
    back = basic.load_pickle(str(tmp_path / "x.pkl"))
    assert back["a"] == [1, 2, 3]
    np.testing.assert_array_equal(back["b"], obj["b"])
    basic.save_jsonl([{"i": 1}, {"i": 2}], str(tmp_path / "r.jsonl"))
    assert basic.load_jsonl(str(tmp_path / "r.jsonl")) == [{"i": 1}, {"i": 2}]
    src = tmp_path / "src"
    (src / "keep").mkdir(parents=True)
    (src / "skip").mkdir()
    (src / "keep" / "a.py").write_text("x")
    (src / "keep" / "b.pyc").write_text("x")
    (src / "skip" / "c.py").write_text("x")
    basic.make_zipfile(str(src), str(tmp_path / "code.zip"), enclosing_dir="code", exclude_dirs=["skip"],
                       exclude_extensions=[".pyc"])
    with zipfile.ZipFile(tmp_path / "code.zip") as zf:
        assert zf.namelist() == ["code/keep/a.py"]


# -- utils/prng.py ---------------------------------------------------------------------


def test_set_host_seed_determinism():
    set_host_seed(123)
    a = (random.random(), np.random.rand(3).tolist())
    set_host_seed(123)
    b = (random.random(), np.random.rand(3).tolist())
    set_host_seed(124)
    c = (random.random(), np.random.rand(3).tolist())
    assert a == b and a != c


def test_key_for_step_keeps_seed_plus_step_and_the_rank():
    def draw(g):
        return torch.rand(8, generator=g)

    assert torch.equal(draw(key_for_step(5, 3)), draw(torch.Generator().manual_seed(8)))  # seed + s
    assert not torch.equal(draw(key_for_step(5, 1)), draw(key_for_step(5, 2)))
    assert torch.equal(draw(key_for_step(5, 1)), draw(key_for_step(5, 1)))
    assert rank_seed(8, 0) == 8
    ranks = {tuple(draw(key_for_step(5, 3, rank=r)).tolist()) for r in range(4)}
    assert len(ranks) == 4


def test_split_dict_names_and_independence():
    gens = split_dict(7, ("dropout", "mtc", "sample"))
    assert set(gens) == {"dropout", "mtc", "sample"}
    assert len({tuple(torch.rand(4, generator=g).tolist()) for g in gens.values()}) == 3
    first, again = split_dict(7, ("dropout", "mtc")), split_dict(7, ("dropout", "mtc"))
    assert torch.equal(torch.rand(4, generator=first["mtc"]), torch.rand(4, generator=again["mtc"]))


def test_local_batch_size():
    mesh = DataMesh(rank=0, world_size=4, device=torch.device("cpu"), backend="gloo")
    assert local_batch_size(32, mesh) == 8
    with pytest.raises(ValueError):
        local_batch_size(33, mesh)


# -- data/video_reader.py, ops/patchify.py ----------------------------------------------------


def test_native_available_agrees_with_jax():
    from xpretrain_tpu.data import video_reader as jax_reader

    assert video_reader.native_available() == jax_reader.native_available()


def test_normalize_u8_matches_jax():
    import jax.numpy as jnp

    from xpretrain_tpu.ops.patchify import normalize_u8 as jax_normalize

    frames = np.full((2, 8, 8, 3), 128, np.uint8)
    out = normalize_u8(torch.from_numpy(frames), CLIP_MEAN, CLIP_STD).numpy()
    assert out.shape == (2, 3, 8, 8)
    assert np.isclose(out[0, 1, 0, 0], (128 / 255.0 - CLIP_MEAN[1]) / CLIP_STD[1], atol=1e-6)
    frames = np.random.default_rng(0).integers(0, 256, size=(2, 3, 5, 7, 3)).astype(np.uint8)
    want = np.asarray(jax_normalize(jnp.asarray(frames), CLIP_MEAN, CLIP_STD))
    np.testing.assert_allclose(normalize_u8(torch.from_numpy(frames), CLIP_MEAN, CLIP_STD).numpy(), want, atol=1e-6)
    assert normalize_u8(torch.from_numpy(frames), CLIP_MEAN, CLIP_STD, torch.bfloat16).dtype == torch.bfloat16


# -- train/evaluate.py:evaluate_multichoice_by_similarity ---------------------------------------


def _identity_step(params, batch):
    return {"vis_features": batch["vis"], "text_features": batch["txt"]}


def test_mc_by_similarity_picks_nearest():
    rng = np.random.default_rng(0)
    B, n_choice, D = 6, 5, 8
    vis = rng.normal(size=(B, D)).astype(np.float32)
    vis /= np.linalg.norm(vis, axis=-1, keepdims=True)
    labels = rng.integers(0, n_choice, size=B)
    txt = rng.normal(size=(B, n_choice, D)).astype(np.float32) * 0.1
    for i, lab in enumerate(labels):
        txt[i, lab] = vis[i]
    report = evaluate_multichoice_by_similarity(
        _identity_step, None, [{"vis": vis, "txt": txt.reshape(B * n_choice, D), "labels": labels}])
    assert report == {"accuracy": 1.0, "n": B}


def test_mc_valid_len_trim():
    vis = np.eye(4, 8, dtype=np.float32)
    txt = np.tile(vis[:, None], (1, 2, 1)).reshape(8, 8)
    txt[1::2] = 0
    report = evaluate_multichoice_by_similarity(
        _identity_step, None, [{"vis": vis, "txt": txt, "labels": np.zeros(4, dtype=int)}], valid_len=3)
    assert report["n"] == 3 and report["accuracy"] == 1.0


# -- optim/optimizer.py:build_multi_schedule_optimizer ---------------------------------------------


def test_multi_schedule_optimizer_lrs():
    named = {"cnn.conv.kernel": torch.nn.Parameter(torch.ones(3, 3)),
             "vision.kernel": torch.nn.Parameter(torch.ones(3, 3)),
             "vision.bias": torch.nn.Parameter(torch.ones(3))}
    opt, labels = build_multi_schedule_optimizer(named, {"cnn": (("cnn",), lambda s: 1e-4)},
                                                 default_schedule=lambda s: 1e-2, weight_decay=0.0,
                                                 max_grad_norm=None)
    assert labels == {"cnn.conv.kernel": "cnn_decay", "vision.kernel": "default_decay",
                      "vision.bias": "default_no_decay"}
    before = {k: v.detach().clone() for k, v in named.items()}
    opt.step([torch.ones_like(p) for p in named.values()])
    named = {k: v.detach() for k, v in named.items()}
    # Adam normalizes a gradient of ones: |update| ~ lr
    assert abs(float(named["cnn.conv.kernel"][0, 0] - before["cnn.conv.kernel"][0, 0])) < 1e-3
    assert abs(float(named["vision.kernel"][0, 0] - before["vision.kernel"][0, 0])) > 1e-3


def test_multi_schedule_optimizer_matches_jax():
    """Three groups with their own schedules, decay and clipping: two
    updates against ``optax``'s, on the same parameters and gradients."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.optim.optimizer import build_multi_schedule_optimizer as jax_build

    rng = np.random.default_rng(0)
    tree = {"encoder": {"cnn": {"kernel": rng.normal(size=(4, 6)), "bias": rng.normal(size=(6,))},
                        "transformer": {"kernel": rng.normal(size=(6, 5))}},
            "align": {"kernel": rng.normal(size=(5, 3))}, "head": {"kernel": rng.normal(size=(3, 2))}}
    tree = jax.tree_util.tree_map(lambda x: x.astype(np.float32), tree)
    grads = [jax.tree_util.tree_map(lambda x: rng.normal(size=x.shape).astype(np.float32) * 3, tree)
             for _ in range(2)]

    def sched(base):
        return lambda count: base * (1.0 + 0.5 * count)

    groups = {"cnn": (("cnn",), sched(1e-4)), "transformer": (("transformer",), sched(2e-3)),
              "align": (("align",), sched(5e-3))}
    tx, jax_labels = jax_build(tree, {k: (p, (lambda f: lambda c: jnp.asarray(f(c)))(f)) for k, (p, f) in
                                      groups.items()}, default_schedule=lambda c: jnp.asarray(sched(1e-3)(c)),
                               weight_decay=0.01, max_grad_norm=1.0)
    state, params = tx.init(tree), tree
    for g in grads:
        updates, state = tx.update(g, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    named = {k.replace("/", "."): torch.nn.Parameter(torch.from_numpy(np.array(v))) for k, v in flat.items()}
    opt, labels = build_multi_schedule_optimizer(named, groups, default_schedule=sched(1e-3), weight_decay=0.01,
                                                 max_grad_norm=1.0)
    for g in grads:
        gflat = {"/".join(str(getattr(k, "key", k)) for k in path): v
                 for path, v in jax.tree_util.tree_flatten_with_path(g)[0]}
        opt.step([torch.from_numpy(gflat[n.replace(".", "/")]) for n in opt.names])
    for path, want in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = ".".join(str(getattr(k, "key", k)) for k in path)
        np.testing.assert_allclose(named[key].detach().numpy(), np.asarray(want), atol=2e-6, rtol=0, err_msg=key)
    jax_flat = {".".join(str(getattr(k, "key", k)) for k in path): v
                for path, v in jax.tree_util.tree_flatten_with_path(jax_labels)[0]}
    assert labels == jax_flat
