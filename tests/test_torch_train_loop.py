"""The port's host loop and checkpoints (``xpretrain_tpu_torch/train/{loop,
checkpoints}.py``): stacked dispatch for ``steps_per_call`` and async saves,
mirroring the JAX package's ``tests/test_train_loop.py``; ``stack_batches``
is also held to the JAX original. The tests marked ``cuda`` (the stack
staged in page-locked memory and placed from it) need a card:
``python -m pytest tests/test_torch_train_loop.py -m cuda --noconftest``."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.parallel.train_step import _page_locked_owner, batch_to_device  # noqa: E402
from xpretrain_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402
from xpretrain_tpu_torch.train.loop import drive_train_loop, stack_batches  # noqa: E402
from xpretrain_tpu_torch.utils.profiling import count, counts  # noqa: E402


class _State:
    def __init__(self, step=0):
        self.step = step


def _drive(fake_step, num_train_steps, steps_per_call, **hooks):
    return drive_train_loop(
        train_step=fake_step,
        loader=iter(lambda: {"x": np.zeros((8, 2), np.float32)}, None),
        state=_State(0),
        place_batch=lambda b: {k: torch.from_numpy(v) for k, v in b.items()},
        seed=100,
        num_train_steps=num_train_steps,
        steps_per_call=steps_per_call,
        **{"log_every": 100, "valid_every": 100, "save_every": 100, **hooks},
    )


def test_stack_batches_matches_jax_and_raises_on_mixed_schemas():
    from xpretrain_tpu.train.loop import stack_batches as jax_stack

    good = [{"x": np.full((4, 2), i, np.float32), "y": np.arange(3) + i} for i in range(3)]
    got, want = stack_batches(good), jax_stack(good)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="identical batches"):
        stack_batches([{"x": np.zeros((4, 2))}, {"x": np.zeros((4, 3))}])  # shape
    with pytest.raises(ValueError, match="identical batches"):
        stack_batches([{"x": np.zeros((4, 2))}, {"y": np.zeros((4, 2))}])  # keys
    with pytest.raises(ValueError, match="identical batches"):
        stack_batches([{"x": np.zeros((4, 2))}, {"x": np.zeros((4, 2), np.float32)}])  # dtype
    with pytest.raises(ValueError, match="dict batches"):
        stack_batches([np.zeros((4, 2)), np.zeros((4, 2))])


def test_stack_batches_scalar_leaf_raises():
    with pytest.raises(ValueError, match="rank >= 1"):
        stack_batches([{"x": np.zeros((4, 2)), "n": np.float32(1.0)}] * 2)
    with pytest.raises(ValueError, match="rank >= 1"):
        stack_batches([{"x": np.zeros((4, 2)), "n": 3}] * 2)  # a python int


def _ingest_batch(i, frames=(2, 3, 16, 16, 3)):
    """A host batch of the leaf kinds a trainer stacks: u8 clips, int64 ids,
    a float32 mask and a bool flag, each filled from ``i``."""
    rng = np.random.default_rng(i)
    return {"video": rng.integers(0, 256, size=frames, dtype=np.uint8),
            "input_ids": rng.integers(0, 1000, size=(frames[0], 8)),
            "attention_mask": rng.random((frames[0], 8), dtype=np.float32),
            "flag": rng.random(frames[0]) > 0.5}


@pytest.fixture()
def card():
    """A card with CUDA initialised in this process (so ``stack_batches``
    stages), or a skip."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.zeros(1, device="cuda")
    assert torch.cuda.is_initialized()


@pytest.mark.parametrize("staged", [False, pytest.param(True, marks=pytest.mark.cuda)])
def test_stacked_chunks_held_at_once_do_not_share_memory(staged, request):
    """Three chunks of one schema, all held: each leaf has its own memory
    and ``np.stack``'s values, staged or not."""
    if staged:
        request.getfixturevalue("card")
    chunks = [[_ingest_batch(3 * c + i) for i in range(3)] for c in range(3)]
    got = [stack_batches(chunk) for chunk in chunks]
    for chunk, stacked in zip(chunks, got):
        for key, leaf in stacked.items():
            assert leaf.dtype == chunk[0][key].dtype
            np.testing.assert_array_equal(leaf, np.stack([b[key] for b in chunk]))
            assert isinstance(leaf.base, torch.Tensor) == staged
    for key in got[0]:
        for a in range(3):
            for b in range(a + 1, 3):
                assert not np.shares_memory(got[a][key], got[b][key]), key


def test_counts_count_and_cost_nothing_when_nothing_engages():
    """``count`` adds to a named total that ``counts`` copies out; without
    CUDA ``stack_batches`` stages nothing, so it counts nothing and returns
    plain arrays that the CPU placement takes as they are."""
    before = counts()
    count("xpt.test.counter")
    count("xpt.test.counter", 2)
    now = counts()
    assert now["xpt.test.counter"] == before.get("xpt.test.counter", 0) + 3
    now["xpt.test.counter"] = -1
    assert counts()["xpt.test.counter"] == before.get("xpt.test.counter", 0) + 3
    if torch.cuda.is_initialized():
        pytest.skip("CUDA is initialised in this process: stack_batches stages")
    before = counts()
    stacked = stack_batches([_ingest_batch(i) for i in range(2)])
    assert counts() == before
    assert all(not isinstance(leaf.base, torch.Tensor) and _page_locked_owner(leaf) is None
               for leaf in stacked.values())
    placed = batch_to_device("cpu")(stacked)
    for key, leaf in stacked.items():
        np.testing.assert_array_equal(placed[key].numpy(), leaf)


def test_count_loses_nothing_across_threads():
    """Counts from more threads than cores, switching every microsecond,
    add up: the read-modify-write is under a lock."""
    import sys
    import threading

    threads, each = 16, 2000
    before = counts().get("xpt.test.threads", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=lambda: [count("xpt.test.threads") for _ in range(each)])
                   for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert counts()["xpt.test.threads"] == before + threads * each


def test_page_locked_owner_finds_nothing_in_pageable_memory():
    """A plain array, a view of one and a view of a pageable tensor have no
    page-locked owner, so ``batch_to_device`` places them as it always has."""
    plain = np.arange(12).reshape(3, 4)
    tensor_view = torch.arange(12).reshape(3, 4).numpy()
    assert _page_locked_owner(plain) is None and _page_locked_owner(plain[1:]) is None
    assert isinstance(tensor_view.base, torch.Tensor) and _page_locked_owner(tensor_view) is None
    assert _page_locked_owner(tensor_view[1:]) is None


@pytest.mark.cuda
def test_staged_leaves_are_page_locked_and_equal_np_stack(card):
    """With CUDA initialised, every leaf is the numpy view of a page-locked
    tensor holding ``np.stack``'s values; one ``xpt.ingest.staged`` each."""
    chunk = [_ingest_batch(i) for i in range(3)]
    before = counts().get("xpt.ingest.staged", 0)
    stacked = stack_batches(chunk)
    assert counts()["xpt.ingest.staged"] == before + len(chunk[0])
    for key, leaf in stacked.items():
        owner = leaf.base
        assert isinstance(owner, torch.Tensor) and owner.is_pinned() and _page_locked_owner(leaf) is owner
        assert owner.data_ptr() == leaf.ctypes.data and tuple(owner.shape) == leaf.shape
        np.testing.assert_array_equal(leaf, np.stack([b[key] for b in chunk]))
        assert leaf.dtype == chunk[0][key].dtype


@pytest.mark.cuda
def test_batch_to_device_places_a_staged_leaf_from_its_own_block(card, monkeypatch):
    """A staged leaf goes to the card in one copy from its page-locked block:
    nothing is pinned again. A part of a staged leaf, and a leaf that was not
    staged, go through the pinning path, with the same values."""
    pinned = []
    pin_memory = torch.Tensor.pin_memory

    def spy(self, *args, **kwargs):
        pinned.append(tuple(self.shape))
        return pin_memory(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "pin_memory", spy)
    place = batch_to_device("cuda")
    chunk = [_ingest_batch(i) for i in range(3)]
    stacked = stack_batches(chunk)
    placed = place(stacked)
    assert pinned == []
    part = place({"video": stacked["video"][1:]})
    plain = place(chunk[0])
    assert pinned == [stacked["video"][1:].shape] + [b.shape for b in chunk[0].values()]
    torch.cuda.synchronize()
    for key, leaf in stacked.items():
        assert placed[key].device.type == "cuda"
        np.testing.assert_array_equal(placed[key].cpu().numpy(), leaf)
        np.testing.assert_array_equal(plain[key].cpu().numpy(), chunk[0][key])
    np.testing.assert_array_equal(part["video"].cpu().numpy(), stacked["video"][1:])


@pytest.mark.cuda
def test_a_queued_copy_keeps_its_block_from_the_next_stack(card):
    """The hazard: with the stream asleep, a staged chunk is placed and
    dropped, and a chunk of the same schema is stacked while its copy still
    waits. The allocator must not hand the first chunk's block to the second:
    the first chunk's device tensors hold the first values."""
    place = batch_to_device("cuda")
    first = [_ingest_batch(i) for i in range(3)]
    second = [_ingest_batch(10 + i) for i in range(3)]
    torch.cuda._sleep(1 << 30)  # ~0.5 s of the stream ahead of the copy
    placed = place(stack_batches(first))  # the host chunk is dropped at once
    again = stack_batches(second)
    assert not torch.cuda.current_stream().query(), "the copy should still be queued"
    torch.cuda.synchronize()
    for key in placed:
        np.testing.assert_array_equal(placed[key].cpu().numpy(), np.stack([b[key] for b in first]))
        np.testing.assert_array_equal(again[key], np.stack([b[key] for b in second]))


@pytest.mark.cuda
def test_stage_fresh_stops_growing_after_two_calls(card):
    """Call after call of one schema, placed and followed by device work as
    the train loop does: the allocator hands back warm blocks, so
    ``xpt.ingest.stage_fresh`` grows in the first two calls at most."""
    place = batch_to_device("cuda")
    frames = (3, 8, 64, 64, 3)  # a block size no other test uses
    before = counts().get("xpt.ingest.stage_fresh", 0)
    fresh = []
    for call in range(8):
        placed = place(stack_batches([_ingest_batch(3 * call + i, frames) for i in range(3)]))
        placed["video"].float().mean()
        fresh.append(counts()["xpt.ingest.stage_fresh"])
    torch.cuda.synchronize()
    assert fresh[0] > before
    assert fresh[1] == fresh[-1], fresh


def test_log_density_preserved_when_a_chunk_exceeds_log_every():
    """steps_per_call 4 with log_every 2 logs every 2 steps, each from its
    own sub-step row; each chunk gets seed + its first step."""
    seeds = []

    def fake_step(state, batch, seed):
        k = batch["x"].shape[0]
        seeds.append(seed)
        state.step += k
        return state, {"loss": torch.arange(k, dtype=torch.float32) + state.step - k}

    logged = []
    state = _drive(fake_step, 8, 4, log_every=2, on_log=lambda step, m, sps: logged.append((step, float(m["loss"]))))
    assert state.step == 8 and seeds == [100, 104]
    assert logged == [(2, 1.0), (4, 3.0), (6, 5.0), (8, 7.0)]


def test_tail_chunk_and_save_validate_boundaries():
    """5 steps at K = 2: chunks of 2, 2 and a shorter 1 (stacked, with a
    leading axis of 1); saves and validations after the chunk that holds
    their boundary; on_step after every chunk."""
    calls, events = [], []

    def fake_step(state, batch, seed):
        k = batch["x"].shape[0]
        assert batch["x"].shape[1:] == (8, 2)
        calls.append((k, seed))
        state.step += k
        return state, {"loss": torch.zeros(k)}

    state = _drive(fake_step, 5, 2, save_every=2, valid_every=3,
                   on_save=lambda step, st: events.append(("save", step)),
                   on_validate=lambda step, st: events.append(("validate", step)),
                   on_step=lambda step: events.append(("step", step)))
    assert state.step == 5
    assert calls == [(2, 100), (2, 102), (1, 104)]
    assert events == [("save", 2), ("step", 2), ("validate", 4), ("save", 4), ("step", 4), ("step", 5)]


def test_one_step_per_call_takes_unstacked_batches():
    shapes = []

    def fake_step(state, batch, seed):
        shapes.append((batch["x"].shape, seed))
        state.step += 1
        return state, {"loss": torch.zeros(())}

    logged = []
    _drive(fake_step, 3, 1, log_every=1, on_log=lambda step, m, sps: logged.append(step))
    assert shapes == [((8, 2), 100), ((8, 2), 101), ((8, 2), 102)] and logged == [1, 2, 3]


# -- async checkpoints (JAX tests/test_train_loop.py:124, :138, :384) --------


def test_async_checkpoint_roundtrip(tmp_path):
    w = torch.arange(8, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    mgr.save(3, {"w": w, "step": 3})  # returns before durable
    mgr.save(5, {"w": w * 2, "step": 5})  # waits for step 3's write first
    mgr.wait()
    assert mgr.latest_step() == 5 and mgr.steps() == [3, 5]
    restored = mgr.restore()
    assert restored["step"] == 5 and torch.equal(restored["w"], w * 2)
    assert torch.equal(mgr.restore(3)["w"], w)


def test_async_checkpoint_snapshots_before_the_next_update(tmp_path):
    """The port updates tensors in place: what an async save writes is the
    state at its call, not what the next steps write into the same tensors."""
    w = torch.zeros(1000)
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    mgr.save(1, {"model": {"w": w}})
    w.add_(1.0)  # the next step, in place
    mgr.wait()
    assert torch.equal(mgr.restore(1)["model"]["w"], torch.zeros(1000))


def test_async_checkpoint_wait_retries_failed_save(tmp_path, monkeypatch):
    """An in-flight write that fails is retried synchronously by wait()."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    real = mgr._write_once
    calls = {"n": 0}

    def flaky(step, state):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("simulated storage failure")
        return real(step, state)

    monkeypatch.setattr(mgr, "_write_once", flaky)
    w = torch.arange(4, dtype=torch.float32)
    mgr.save(1, {"w": w})
    mgr.wait()  # must not raise: retries the step-1 save synchronously
    assert calls["n"] == 2 and mgr.latest_step() == 1
    assert torch.equal(mgr.restore()["w"], w)


def test_async_checkpoint_failure_is_superseded_by_the_next_save(tmp_path, monkeypatch, caplog):
    """A save waits for the previous write; a failure there is a warning and
    the newer save becomes the resume point."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    real = mgr._write_once

    def fail_step_1(step, state):
        if step == 1:
            raise OSError("simulated storage failure")
        return real(step, state)

    monkeypatch.setattr(mgr, "_write_once", fail_step_1)
    mgr.save(1, {"w": torch.ones(2)})
    with caplog.at_level("WARNING"):
        mgr.save(2, {"w": torch.full((2,), 2.0)})
        mgr.wait()
    assert "previous async checkpoint failed" in caplog.text
    assert mgr.steps() == [2] and torch.equal(mgr.restore()["w"], torch.full((2,), 2.0))


def test_async_checkpoint_poll_releases_host_copy(tmp_path):
    """poll() drops the host copy (parameters and both moments) once the
    write has landed."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=True)
    mgr.save(1, {"w": torch.ones(4)})
    assert mgr._last_async is not None  # held while in flight
    for _ in range(100):
        mgr.poll()
        if mgr._last_async is None:
            break
        time.sleep(0.05)
    assert mgr._last_async is None, "poll never released the host copy"
    assert torch.equal(mgr.restore()["w"], torch.ones(4))


def test_sync_save_retries_a_transient_failure(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), retries=3)
    real = mgr._write_once
    calls = {"n": 0}

    def flaky(step, state):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("simulated transient failure")
        return real(step, state)

    monkeypatch.setattr(mgr, "_write_once", flaky)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    mgr.save(1, {"w": torch.ones(2)})
    assert calls["n"] == 2 and mgr.latest_step() == 1
