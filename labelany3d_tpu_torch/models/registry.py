"""Lazy model registry with pluggable (and fakeable) backends.

Counterpart of `labelany3d_tpu/models/registry.py`: factories registered
under string keys, built on first `get`, swappable in tests with
`register(name, factory, override=True)`. The registry is an object the
caller creates and passes; `pipeline/backends.py::default_registry` fills one.
"""

from __future__ import annotations

import threading
from typing import Any, Callable


class ModelRegistry:
    def __init__(self) -> None:
        self._factories: dict[str, Callable[..., Any]] = {}
        self._loaded: dict[str, Any] = {}
        self._lock = threading.Lock()

    def register(self, name: str, factory: Callable[..., Any], override: bool = False) -> None:
        with self._lock:
            if name in self._factories and not override:
                raise ValueError(f"Model backend '{name}' already registered")
            self._factories[name] = factory
            self._loaded.pop(name, None)

    def get(self, name: str, **kwargs) -> Any:
        with self._lock:
            if name in self._loaded:
                return self._loaded[name]
            if name not in self._factories:
                raise KeyError(f"No backend registered for '{name}'. "
                               f"Available: {sorted(self._factories)}")
            factory = self._factories[name]
        model = factory(**kwargs)
        with self._lock:
            self._loaded[name] = model
        return model
