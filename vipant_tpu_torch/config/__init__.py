"""Composable YAML config with lazy ``${a.b.c}`` interpolation.

The port's own copy of ``vipant_tpu/config/__init__.py`` and its
``defaults/`` tree (the port imports nothing of the JAX package): a
dependency-free equivalent of a hydra/omegaconf stack, one ``default.yaml``
plus group directories, with hydra's override grammar:

* ``compose(["+running=bimodal", "+model/image=vit_val", "running.batch_size=8"])``
  loads ``defaults/default.yaml``, merges each ``+group=name`` file under the
  group's config path (``model/image`` → ``cfg.model.image``), then applies
  dotted overrides.
* String values of the form ``${a.b.c}`` resolve lazily against the root, so
  overrides applied after composition are still seen by interpolations
  (omegaconf semantics).
"""

from __future__ import annotations

import copy
import os
import re
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

import yaml

_INTERP_FULL = re.compile(r"^\$\{([^}]+)\}$")
_INTERP_PART = re.compile(r"\$\{([^}]+)\}")

DEFAULTS_DIR = os.path.join(os.path.dirname(__file__), "defaults")


class Config:
    """Attribute-style view over a nested dict, with interpolation.

    Every non-root Config keeps a pointer to the root dict so ``${...}``
    references resolve globally.
    """

    __slots__ = ("_data", "_root")

    def __init__(self, data: Optional[Dict[str, Any]] = None, _root: Optional[Dict] = None):
        object.__setattr__(self, "_data", data if data is not None else {})
        object.__setattr__(self, "_root", _root if _root is not None else self._data)

    # -- resolution ---------------------------------------------------------
    def _resolve(self, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, _root=self._root)
        if isinstance(value, list):
            return [self._resolve(v) for v in value]
        if isinstance(value, str):
            m = _INTERP_FULL.match(value)
            if m:  # full interpolation keeps the referenced value's type
                return self._lookup_path(m.group(1))
            if _INTERP_PART.search(value):
                return _INTERP_PART.sub(
                    lambda mm: str(self._lookup_path(mm.group(1))), value
                )
        return value

    def _lookup_path(self, path: str) -> Any:
        node: Any = self._root
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise KeyError(f"interpolation ${{{path}}} failed at {part!r}")
            node = node[part]
        return Config(node, _root=self._root) if isinstance(node, dict) else (
            self._resolve(node) if isinstance(node, (str, list)) else node
        )

    # -- mapping / attribute API -------------------------------------------
    def __getattr__(self, key: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if key in data:
            return self._resolve(data[key])
        raise AttributeError(f"config key {key!r} not found (have: {sorted(data)})")

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = _plain(value)

    def __getitem__(self, key: str) -> Any:
        return self.__getattr__(key)

    def __setitem__(self, key: str, value: Any) -> None:
        self.__setattr__(key, value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    # slots + __getattr__ break default pickling (unpickle would route
    # through __getattr__ before _data exists); datasets carry Configs into
    # process-pool loader workers, so spell the protocol out
    def __getstate__(self):
        return (
            object.__getattribute__(self, "_data"),
            object.__getattribute__(self, "_root"),
        )

    def __setstate__(self, state):
        object.__setattr__(self, "_data", state[0])
        object.__setattr__(self, "_root", state[1])

    def __iter__(self):
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._resolve(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self._resolve(v)) for k, v in self._data.items())

    def to_dict(self, resolve: bool = False) -> Dict[str, Any]:
        if not resolve:
            return copy.deepcopy(self._data)
        out: Dict[str, Any] = {}
        for k in self._data:
            v = self._resolve(self._data[k])
            out[k] = v.to_dict(resolve=True) if isinstance(v, Config) else _plain(v)
        return out

    def merge(self, other: Union["Config", Dict[str, Any]]) -> "Config":
        _merge_into(self._data, other._data if isinstance(other, Config) else other)
        return self

    def set_path(self, path: str, value: Any) -> None:
        node = self._data
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise TypeError(f"cannot descend into non-dict at {part!r} in {path!r}")
        node[parts[-1]] = _plain(value)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __deepcopy__(self, memo):
        return Config(copy.deepcopy(self._data, memo))


def _plain(value: Any) -> Any:
    if isinstance(value, Config):
        return copy.deepcopy(value._data)
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def _merge_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge_into(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def _parse_value(text: str) -> Any:
    # leading-zero digit strings stay strings: YAML 1.1 reads "00000005"
    # as octal 5, silently corrupting checkpoint-step names (model_file)
    if re.fullmatch(r"0\d+", text):
        return text
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def compose(
    overrides: Sequence[str] = (),
    config_dir: Optional[str] = None,
    base: str = "default.yaml",
) -> Config:
    """Hydra-style composition.

    ``overrides`` entries are either ``+group/sub=name`` (merge
    ``{config_dir}/group/sub/{name}.yaml`` under ``cfg.group.sub``) or
    ``dotted.key=value`` (yaml-parsed scalar override).
    Group selections are applied in order, then all dotted overrides.
    """
    config_dir = config_dir or DEFAULTS_DIR
    cfg = Config(load_yaml(os.path.join(config_dir, base)))

    dotted: List[str] = []
    for item in overrides:
        item = item.strip()
        if not item:
            continue
        if item.startswith("+"):
            group, _, name = item[1:].partition("=")
            path = os.path.join(config_dir, group, f"{name}.yaml")
            sub = load_yaml(path)
            key_path = group.replace("/", ".")
            node = cfg._data
            for part in key_path.split(".")[:-1]:
                node = node.setdefault(part, {})
            leaf = key_path.split(".")[-1]
            if leaf in node and isinstance(node[leaf], dict):
                _merge_into(node[leaf], sub)
            else:
                node[leaf] = sub
        else:
            dotted.append(item)

    for item in dotted:
        key, _, value = item.partition("=")
        cfg.set_path(key.strip(), _parse_value(value.strip()))
    return cfg
