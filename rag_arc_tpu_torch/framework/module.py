"""Module base: pairs a built module with the config that built it.

The port's own copy of ``rag_arc_tpu/framework/module.py``, its behaviour
unchanged, so the port imports nothing of the JAX package.

Parity with the reference's ``framework/module.py:9-11`` (a marker
dataclass). Modules are free to subclass this or simply accept a
``config=`` kwarg; the registry only requires ``build()`` to return
*something*.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any


@dataclass
class AbstractModule:
    config: Any = None

    @classmethod
    def from_config(cls, config: Any, **overrides: Any) -> "AbstractModule":
        return cls(config=config, **overrides)
