"""Small JSON / JSONL helpers (the port's copy of the parts of
``xpretrain_tpu/utils/basic.py`` it uses)."""

from __future__ import annotations

import json
from typing import Any


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
