"""The port's host loop and checkpoints (``xpretrain_tpu_torch/train/{loop,
checkpoints}.py``): stacked dispatch for ``steps_per_call`` and async saves,
mirroring the JAX package's ``tests/test_train_loop.py``; ``stack_batches``
is also held to the JAX original."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402
from xpretrain_tpu_torch.train.loop import drive_train_loop, stack_batches  # noqa: E402


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
