"""Minimal string→class registry.

Plays the role of fvcore's ``Registry``: every model, encoder head, encoder
stage and loss head is chosen by name from config. The port's own copy of
``vipant_tpu/utils/registry.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional


class Registry:
    def __init__(self, name: str):
        self._name = name
        self._map: Dict[str, Any] = {}

    @property
    def name(self) -> str:
        return self._name

    def register(self, obj: Optional[Any] = None, *, name: Optional[str] = None):
        """Use as ``@REG.register()`` or ``REG.register(cls)``."""
        if obj is None:
            def deco(inner):
                self._do_register(name or inner.__name__, inner)
                return inner
            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name: str, obj: Any) -> None:
        if name in self._map:
            raise KeyError(f"{name!r} already registered in {self._name}")
        self._map[name] = obj

    def get(self, name: str) -> Any:
        if name not in self._map:
            known = ", ".join(sorted(self._map))
            raise KeyError(f"{name!r} not found in registry {self._name} (known: {known})")
        return self._map[name]

    def __contains__(self, name: str) -> bool:
        return name in self._map

    def __iter__(self) -> Iterator[str]:
        return iter(self._map)

    def keys(self):
        return self._map.keys()
