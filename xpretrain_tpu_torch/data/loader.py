"""Host data loading: batch iteration (the port's copy of the parts of
``xpretrain_tpu/data/loader.py`` it uses; numpy only, no torch).


- :class:`BatchLoader` — map-style dataset -> numpy batches with per-process
  sharding (the ``DistributedSampler`` role) and seeded shuffling.
- :class:`SequentialEvalLoader` — ordered, padded-to-divisible eval sharding
  with ``valid_len`` trimming (ref ``SequentialDistributedSampler``
  ``hd-vila/src/utils/distributed.py:206-245``; trim at
  ``run_video_retrieval.py:152-153``).
- :class:`InfiniteIterator` — epoch-incrementing wrapper
  (ref ``dataloader.py:160-177``).
- :class:`MetaLoader` — ratio-weighted multi-task draw
  (ref ``dataloader.py:15-62``).
- :class:`ShardedReloadLoader` — an infinite loader that swaps annotation
  shards every ``reload_steps`` (``data/metadata.py:ShardedAnnotations``).
- :class:`PrefetchLoader` — device placement from a background thread, with
  a bounded queue (ref ``dataloader.py:65-157``, the reference's CUDA-stream
  ``PrefetchLoader``): on a card the copy runs on a stream of the producer's
  own and the consumer's stream waits on its event. Torch is imported only
  there.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import numpy as np


class BatchLoader:
    """Iterate a map-style dataset in seeded, optionally sharded batches.

    ``num_workers >= 1`` decodes items through a shared thread pool, pipelined
    ``prefetch_batches`` ahead — the production-rate ingest path replacing the
    reference's torch ``DataLoader(n_workers=4)`` decode processes
    (``CLIP-ViP/src/datasets/dataloader.py:65-157``); ``num_workers=1`` is one
    background decode thread (torch semantics), 0 is the serial inline path.
    Threads suffice
    because the native reader's ctypes calls release the GIL during
    libav decode (``data/video_reader.py``); batch order is identical to the
    serial path (futures are consumed in index order).
    """

    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        collate_fn: Callable[[list], Any],
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        num_workers: int = 0,
        prefetch_batches: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.process_index = process_index
        self.process_count = process_count
        self.num_workers = num_workers
        self.prefetch_batches = max(1, prefetch_batches)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # pad to a multiple of (process_count * batch) so shards stay equal
        world_batch = self.batch_size * self.process_count
        if self.drop_last:
            order = order[: (n // world_batch) * world_batch]
        else:
            pad = (-n) % world_batch
            order = np.concatenate([order, order[:pad]]) if pad else order
        return order[self.process_index :: self.process_count]

    def __len__(self) -> int:
        return len(self._indices()) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        idx = self._indices()
        starts = range(0, len(idx) - self.batch_size + 1, self.batch_size)
        if self.num_workers < 1:
            for start in starts:
                items = [self.dataset[int(i)] for i in idx[start : start + self.batch_size]]
                yield self.collate_fn(items)
            return
        yield from self._iter_pooled(idx, starts)

    def _iter_pooled(self, idx: np.ndarray, starts: range) -> Iterator[Any]:
        """Thread-pool item decode, pipelined ``prefetch_batches`` ahead."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        try:

            def submit(start):
                return [
                    pool.submit(self.dataset.__getitem__, int(i))
                    for i in idx[start : start + self.batch_size]
                ]

            pending: deque = deque()
            it = iter(starts)
            for _ in range(self.prefetch_batches):
                start = next(it, None)
                if start is None:
                    break
                pending.append(submit(start))
            while pending:
                futures = pending.popleft()
                start = next(it, None)
                if start is not None:
                    pending.append(submit(start))
                yield self.collate_fn([f.result() for f in futures])
        finally:
            # abandoned generator (consumer broke out / islice / GC): drop the
            # queued decode work instead of churning it in the background —
            # submitted-but-unconsumed items otherwise keep decoding (and keep
            # retrying against a corpus the caller may already have deleted)
            pool.shutdown(wait=False, cancel_futures=True)


class SequentialEvalLoader:
    """Ordered eval loader padded to an even per-process split.

    ``valid_len`` is the true dataset size: after features from all processes
    are gathered (in rank-interleaved order), callers trim ``[:valid_len]``.
    """

    def __init__(
        self,
        dataset: Sequence,
        batch_size: int,
        collate_fn: Callable[[list], Any],
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.process_index = process_index
        self.process_count = process_count
        self.valid_len = len(dataset)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        world_batch = self.batch_size * self.process_count
        pad = (-n) % world_batch
        order = np.concatenate([np.arange(n), np.zeros(pad, dtype=np.int64)]) if pad else np.arange(n)
        # batch-interleaved so global order is restored by simple concat of
        # per-batch gathers: batch b holds items [b*WB + rank*B, ...)
        for start in range(0, len(order), world_batch):
            block = order[start : start + world_batch]
            mine = block[self.process_index * self.batch_size : (self.process_index + 1) * self.batch_size]
            yield self.collate_fn([self.dataset[int(i)] for i in mine])

    def __len__(self) -> int:
        n = len(self.dataset)
        world_batch = self.batch_size * self.process_count
        return (n + world_batch - 1) // world_batch


class InfiniteIterator:
    """Restart the underlying loader forever, bumping its epoch each pass."""

    def __init__(self, loader):
        self.loader = loader
        self.epoch = 0
        self._it = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self._it)
        except StopIteration:
            self.epoch += 1
            if hasattr(self.loader, "set_epoch"):
                self.loader.set_epoch(self.epoch)
            self._it = iter(self.loader)
            return next(self._it)

    def close(self) -> None:
        """Close the underlying iterator now (cancels a pooled BatchLoader's
        queued decodes) instead of waiting for GC."""
        close = getattr(self._it, "close", None)
        if close is not None:
            close()


class MetaLoader:
    """Ratio-weighted multi-task round-robin (ref ``dataloader.py:15-62``).

    ``loaders`` maps name -> (loader, ratio). The per-step task sequence is
    drawn from a generator seeded identically on every process, so all ranks
    train the same task each step with zero communication.
    """

    def __init__(self, loaders: Mapping[str, tuple[Any, int]], seed: int = 0):
        if not loaders:
            raise ValueError("empty loaders")
        self.names: list[str] = []
        self.iters: dict[str, InfiniteIterator] = {}
        for name, (loader, ratio) in loaders.items():
            self.names.extend([name] * int(ratio))
            self.iters[name] = loader if isinstance(loader, InfiniteIterator) else InfiniteIterator(loader)
        self.rng = np.random.default_rng(seed)

    def __iter__(self):
        return self

    def __next__(self) -> tuple[str, Any]:
        task = self.names[int(self.rng.integers(0, len(self.names)))]
        return task, next(self.iters[task])


class ShardedReloadLoader:
    """Infinite loader that swaps annotation shards every ``reload_steps``.

    The hd-vila sharded-annotation pattern
    (``run_pretrain_stage1_group.py:265-277, 344-347, 482-488``): a 100M-row
    corpus is split into epoch-sized jsonl shards; the train loader is rebuilt
    on the next shard every RELOAD_STEPS so at most one shard is resident.

    ``dataset_factory(rows) -> dataset``; ``shards`` is a
    :class:`~xpretrain_tpu_torch.data.metadata.ShardedAnnotations`.
    """

    def __init__(
        self,
        shards,
        dataset_factory: Callable[[list], Sequence],
        batch_size: int,
        collate_fn: Callable[[list], Any],
        reload_steps: int = 1000,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.shards = shards
        self.dataset_factory = dataset_factory
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.reload_steps = reload_steps
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self._steps_on_shard = 0
        self._reloads = 0
        self._it: Iterator | None = None

    def _build(self):
        loader = BatchLoader(
            self.dataset_factory(self.shards.current()),
            self.batch_size,
            self.collate_fn,
            seed=self.seed + 104729 * self._reloads,  # distinct stream per shard
            process_index=self.process_index,
            process_count=self.process_count,
        )
        return InfiniteIterator(loader)

    def __iter__(self):
        return self

    def __next__(self):
        if self._it is None:
            self._it = self._build()
        if self._steps_on_shard >= self.reload_steps:
            self.shards.advance()
            self._reloads += 1
            self._steps_on_shard = 0
            self._it = self._build()
        self._steps_on_shard += 1
        return next(self._it)


def _tensors(item) -> list:
    """The torch tensors in a batch: a dict's values, or a (task, batch) pair's."""
    if isinstance(item, dict):
        return [v for v in item.values() if hasattr(v, "record_stream")]
    if isinstance(item, (tuple, list)):
        return [t for sub in item for t in _tensors(sub)]
    return [item] if hasattr(item, "record_stream") else []


class PrefetchLoader:
    """Stage batches onto the device from a background thread.

    ``place_fn`` does the host->device transfer (on a card,
    ``parallel/train_step.py:batch_to_device``: pinned memory, ``non_blocking``
    copies); a bounded queue of ``depth`` in-flight batches overlaps the
    upload with the previous step's compute. With a card present the producer
    runs ``place_fn`` on a CUDA stream of its own and records an event; the
    consumer's current stream waits on that event, and each CUDA tensor of
    the batch is recorded on the consumer's stream, before the batch is
    yielded."""

    def __init__(self, source: Iterable, place_fn: Callable[[Any], Any], depth: int = 2):
        self.source = source
        self.place_fn = place_fn
        self.depth = depth

    def __iter__(self):
        import torch

        cuda = torch.cuda.is_available()
        stream = torch.cuda.Stream() if cuda else None
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        sentinel = object()
        error: list[BaseException] = []

        def producer():
            try:
                for item in self.source:
                    if stream is None:
                        q.put((self.place_fn(item), None))
                        continue
                    with torch.cuda.stream(stream):
                        placed = self.place_fn(item)
                        event = torch.cuda.Event()
                        event.record(stream)
                    q.put((placed, event))
            except BaseException as e:  # noqa: BLE001 - surfaced to consumer
                error.append(e)
            finally:
                q.put(sentinel)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            entry = q.get()
            if entry is sentinel:
                if error:
                    raise error[0]
                return
            item, event = entry
            if event is not None:
                current = torch.cuda.current_stream()
                current.wait_event(event)
                for t in _tensors(item):
                    if t.is_cuda:
                        t.record_stream(current)
            yield item
