"""Application registry.

The port's own copy of ``rag_arc_tpu/framework/registry.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Parity with the reference's ``framework/register.py:8-26`` +
``framework/singleton_decorator.py``: a process-wide singleton that reads a
JSON config file, validates it into a typed ``AbstractConfig``, calls
``build()``, and stores the built instance under an app name for later
``get_object()`` lookup. Extended with in-memory registration (no temp
files needed in tests/serving) and introspection.
"""

from __future__ import annotations

import json
import logging
import threading
from pathlib import Path
from typing import Any, Dict, Type, TypeVar

from rag_arc_tpu_torch.framework.config import AbstractConfig

logger = logging.getLogger(__name__)

T = TypeVar("T")


def singleton(cls: Type[T]) -> Type[T]:
    """Class decorator: one shared instance per process (thread-safe)."""
    lock = threading.Lock()
    instances: Dict[type, Any] = {}
    orig_new = cls.__new__

    def __new__(klass, *args: Any, **kwargs: Any):  # noqa: N807
        with lock:
            if klass not in instances:
                if orig_new is object.__new__:
                    instances[klass] = orig_new(klass)
                else:
                    instances[klass] = orig_new(klass, *args, **kwargs)
                instances[klass]._singleton_initialized = False
            return instances[klass]

    cls.__new__ = __new__  # type: ignore[method-assign]
    return cls


@singleton
class Register:
    """Singleton app registry: config file/dict → built module instance."""

    def __init__(self) -> None:
        if getattr(self, "_singleton_initialized", False):
            return
        self._singleton_initialized = True
        self.registrations: Dict[str, Any] = {}
        self.configs: Dict[str, AbstractConfig] = {}

    def register(
        self,
        config_path: str | Path,
        app_name: str,
        config_type: Type[AbstractConfig],
    ) -> Any | None:
        """Read JSON at ``config_path``, validate, build, store. Returns the
        built instance, or None on failure (reference prints-and-continues;
        we log the error and return None)."""
        try:
            raw = Path(config_path).read_text(encoding="utf-8")
            data = json.loads(raw)
            config = config_type.model_validate(data)
            return self.register_config(config, app_name)
        except Exception as exc:  # noqa: BLE001 — registry is fail-soft by contract
            logger.error("failed to register %r from %s: %s", app_name, config_path, exc)
            print(f"Error registering {app_name}: {exc}")
            return None

    def register_config(self, config: AbstractConfig, app_name: str) -> Any:
        """Validate-and-build from an in-memory config object."""
        instance = config.build()
        if app_name in self.registrations:
            logger.warning("overwriting registration %r", app_name)
        self.registrations[app_name] = instance
        self.configs[app_name] = config
        return instance

    def get_object(self, app_name: str) -> Any | None:
        return self.registrations.get(app_name)

    def get_config(self, app_name: str) -> AbstractConfig | None:
        return self.configs.get(app_name)

    def list_apps(self) -> list[str]:
        return sorted(self.registrations)

    def clear(self) -> None:
        """Drop all registrations (test isolation helper)."""
        self.registrations.clear()
        self.configs.clear()
