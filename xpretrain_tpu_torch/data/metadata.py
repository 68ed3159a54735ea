"""Metadata stores for 100M-scale pretraining corpora (the port's copy of
``xpretrain_tpu/data/metadata.py``; numpy only, no torch).

The reference keeps 92M subtitles / 8.5M sample records in LMDB
(``CLIP-ViP/src/datasets/dataset_pretrain_stage1_all_source.py:63-104``,
``LF-VILA/src/datasets/pretrain_dataset.py:50-57``). This image has no LMDB,
and the access pattern is write-once/read-random — exactly what a packed
mmap store does better on a training host (zero page-cache duplication across
dataloader threads, no transactions):

- :class:`PackedRecordStore` — a ``.bin`` blob + ``.idx`` uint64 offset
  table; ``build()`` streams records in, reads are ``mmap`` slices by index
  or by key hash. Records are arbitrary bytes (json/msgpack/pickled).
- :class:`ShardedAnnotations` — the hd-vila sharded-annotation pattern
  (``run_pretrain_stage1_group.py:265-277``): epoch-sized jsonl shards
  cycled with periodic reloads, so a 100M-row corpus never sits in RAM.
"""

from __future__ import annotations

import hashlib
import json
import mmap
import os
import struct
from typing import Any, Iterable, Iterator

import numpy as np


class PackedRecordStore:
    """Write-once packed record store with O(1) mmap random access."""

    MAGIC = b"XPTREC1\0"

    def __init__(self, path_prefix: str):
        self.prefix = path_prefix
        self._data_f = open(path_prefix + ".bin", "rb")
        self._mm = mmap.mmap(self._data_f.fileno(), 0, access=mmap.ACCESS_READ)
        head = self._mm[: len(self.MAGIC)]
        if head != self.MAGIC:
            raise ValueError(f"bad store magic in {path_prefix}.bin")
        self._offsets = np.fromfile(path_prefix + ".idx", dtype=np.uint64)
        self._keys: dict[bytes, int] | None = None

    def __len__(self) -> int:
        return len(self._offsets) - 1

    def get(self, index: int) -> bytes:
        lo, hi = int(self._offsets[index]), int(self._offsets[index + 1])
        return self._mm[lo:hi]

    def get_json(self, index: int) -> Any:
        return json.loads(self.get(index))

    # -- key lookup (optional .keys file) -----------------------------------

    def _load_keys(self) -> dict[bytes, int]:
        if self._keys is None:
            keys_path = self.prefix + ".keys"
            self._keys = {}
            if os.path.exists(keys_path):
                with open(keys_path, "rb") as f:
                    n = struct.unpack("<Q", f.read(8))[0]
                    for i in range(n):
                        klen = struct.unpack("<H", f.read(2))[0]
                        self._keys[f.read(klen)] = i
        return self._keys

    def get_by_key(self, key: str) -> bytes:
        idx = self._load_keys().get(key.encode())
        if idx is None:
            raise KeyError(key)
        return self.get(idx)

    def close(self) -> None:
        self._mm.close()
        self._data_f.close()

    # -- writing a store ----------------------------------------------------

    @classmethod
    def build(
        cls,
        path_prefix: str,
        records: Iterable[bytes | str | dict],
        keys: Iterable[str] | None = None,
    ) -> "PackedRecordStore":
        offsets = [len(cls.MAGIC)]
        with open(path_prefix + ".bin", "wb") as f:
            f.write(cls.MAGIC)
            for rec in records:
                if isinstance(rec, dict):
                    rec = json.dumps(rec).encode()
                elif isinstance(rec, str):
                    rec = rec.encode()
                f.write(rec)
                offsets.append(offsets[-1] + len(rec))
        np.asarray(offsets, dtype=np.uint64).tofile(path_prefix + ".idx")
        if keys is not None:
            key_list = list(keys)
            with open(path_prefix + ".keys", "wb") as f:
                f.write(struct.pack("<Q", len(key_list)))
                for k in key_list:
                    kb = k.encode()
                    f.write(struct.pack("<H", len(kb)))
                    f.write(kb)
        return cls(path_prefix)


class PackedStoreDataset:
    """Map-style dataset view over a PackedRecordStore of json rows."""

    def __init__(self, store: PackedRecordStore):
        self.store = store

    def __len__(self) -> int:
        return len(self.store)

    def __getitem__(self, index: int) -> Any:
        return self.store.get_json(index)


class ShardedAnnotations:
    """Cycle through part{i}.jsonl shards, reloading every epoch.

    ``current()`` returns the in-memory rows of the active shard;
    ``advance()`` loads the next shard (wrapping), the equivalent of the
    reference's loader rebuild every RELOAD_STEPS.
    """

    def __init__(self, pattern: str, num_shards: int, start_shard: int = 0):
        self.pattern = pattern
        self.num_shards = num_shards
        self.shard = start_shard % num_shards
        self._rows: list | None = None

    def current(self) -> list:
        if self._rows is None:
            path = self.pattern.format(self.shard)
            with open(path) as f:
                self._rows = [json.loads(line) for line in f if line.strip()]
        return self._rows

    def advance(self) -> int:
        self.shard = (self.shard + 1) % self.num_shards
        self._rows = None
        return self.shard


def stable_hash(key: str, buckets: int) -> int:
    """Deterministic string->bucket hash (shard assignment)."""
    return int(hashlib.md5(key.encode()).hexdigest()[:12], 16) % buckets
