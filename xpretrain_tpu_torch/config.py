"""Config system: JSON/YAML files + argparse CLI with "explicit CLI wins" merge
(the port's copy of ``xpretrain_tpu/config.py``).

Reproduces the reference's config semantics
(``CLIP-ViP/src/configs/config.py:12-30, 260-267``):

- a ``--config`` file provides values for every flag;
- a flag explicitly passed on the command line overrides the file;
- defaults fill anything neither provides;
- integers 0/1 are coerced to bool for flags declared boolean.

LF-VILA-style YAML configs (``mmcv.Config.fromfile`` at
``LF-VILA/src/run_pretrain.py:38``) are covered by the YAML loader; nested
dicts are exposed with attribute access via :class:`ConfigDict`.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Any, Mapping, Sequence


class ConfigDict(dict):
    """Dict with attribute access, recursively wrapping nested dicts."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __deepcopy__(self, memo):
        return ConfigDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        def unwrap(value):
            if isinstance(value, ConfigDict):
                return {k: unwrap(v) for k, v in value.items()}
            if isinstance(value, list):
                return [unwrap(v) for v in value]
            return value

        return unwrap(self)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node



def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigDict):
        return value
    if isinstance(value, Mapping):
        return ConfigDict(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def deep_update(base: ConfigDict, override: Mapping[str, Any]) -> ConfigDict:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    for key, value in override.items():
        if key in base and isinstance(base[key], ConfigDict) and isinstance(value, Mapping):
            deep_update(base[key], value)
        else:
            base[key] = value
    return base


def load_config_file(path: str) -> ConfigDict:
    """Load a .json or .yaml/.yml config file."""
    ext = os.path.splitext(path)[1].lower()
    with open(path, "r") as f:
        if ext == ".json":
            data = json.load(f)
        elif ext in (".yaml", ".yml"):
            import yaml

            data = yaml.safe_load(f)
        else:
            raise ValueError(f"unsupported config extension: {path}")
    if not isinstance(data, Mapping):
        raise ValueError(f"config root must be a mapping: {path}")
    return ConfigDict(data)



def _explicit_cli_keys(parser: argparse.ArgumentParser, argv: Sequence[str]) -> set[str]:
    """Which destinations were explicitly provided on the command line."""
    explicit: set[str] = set()
    option_to_dest = {}
    for action in parser._actions:  # noqa: SLF001 - argparse has no public API for this
        for opt in action.option_strings:
            option_to_dest[opt] = action.dest
    for token in argv:
        if not token.startswith("-"):
            continue
        opt = token.split("=", 1)[0]
        if opt in option_to_dest:
            explicit.add(option_to_dest[opt])
    return explicit


def _coerce_bools(cfg: ConfigDict, bool_keys: set[str]) -> None:
    for key in bool_keys:
        if key in cfg and isinstance(cfg[key], int) and not isinstance(cfg[key], bool):
            if cfg[key] in (0, 1):
                cfg[key] = bool(cfg[key])


def parse_with_config(
    parser: argparse.ArgumentParser,
    argv: Sequence[str] | None = None,
) -> ConfigDict:
    """Parse CLI args merged with an optional ``--config`` file.

    Precedence: explicit CLI flag > config-file value > argparse default.
    """
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    cfg = ConfigDict(vars(args))

    config_path = cfg.get("config")
    if config_path:
        file_cfg = load_config_file(config_path)
        explicit = _explicit_cli_keys(parser, argv)
        for key, value in file_cfg.items():
            if key not in explicit:
                cfg[key] = value

    bool_keys = {
        action.dest
        for action in parser._actions  # noqa: SLF001
        if isinstance(action.default, bool) or isinstance(action, argparse._StoreTrueAction)
    }
    _coerce_bools(cfg, bool_keys)
    return cfg


def dump_config(cfg: ConfigDict, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(cfg.to_dict(), f, indent=2, sort_keys=True, default=str)
