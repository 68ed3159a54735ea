"""Small IO / container helpers (the port's copy of ``xpretrain_tpu/utils/basic.py``).

Covers the capability surface of the reference's ``basic_utils``
(``CLIP-ViP/src/utils/basic_utils.py``): json/jsonl/pickle IO, list
flattening, running averages, zip snapshots.
"""

from __future__ import annotations

import json
import os
import pickle
import zipfile
from typing import Any, Iterable, Sequence


def load_json(path: str) -> Any:
    with open(path, "r") as f:
        return json.load(f)


def save_json(data: Any, path: str, pretty: bool = False) -> None:
    with open(path, "w") as f:
        if pretty:
            json.dump(data, f, indent=2, sort_keys=True)
        else:
            json.dump(data, f)


def load_jsonl(path: str) -> list[Any]:
    with open(path, "r") as f:
        return [json.loads(line) for line in f if line.strip()]


def save_jsonl(rows: Iterable[Any], path: str) -> None:
    with open(path, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")


def load_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def save_pickle(data: Any, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(data, f)


def flat_list_of_lists(lists: Sequence[Sequence[Any]]) -> list[Any]:
    """[[a, b], [c]] -> [a, b, c]."""
    return [item for sub in lists for item in sub]


def chunk_list(items: Sequence[Any], chunk_size: int) -> list[list[Any]]:
    return [list(items[i : i + chunk_size]) for i in range(0, len(items), chunk_size)]


def make_zipfile(
    src_dir: str,
    save_path: str,
    enclosing_dir: str = "",
    exclude_dirs: Sequence[str] = (),
    exclude_extensions: Sequence[str] = (),
    exclude_dirs_substring: str | None = None,
) -> None:
    """Zip a source tree (code snapshot saved next to checkpoints)."""
    abs_src = os.path.abspath(src_dir)
    with zipfile.ZipFile(save_path, "w", zipfile.ZIP_DEFLATED) as zf:
        for dirname, subdirs, files in os.walk(src_dir):
            if exclude_dirs_substring is not None:
                subdirs[:] = [d for d in subdirs if exclude_dirs_substring not in d]
            subdirs[:] = [d for d in subdirs if d not in exclude_dirs]
            arc_dir = os.path.join(enclosing_dir, dirname[len(abs_src) + 1 :])
            for filename in files:
                if any(filename.endswith(ext) for ext in exclude_extensions):
                    continue
                zf.write(os.path.join(dirname, filename), os.path.join(arc_dir, filename))


class AverageMeter:
    """Running average of a scalar stream."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
