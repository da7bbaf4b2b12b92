from rag_arc_tpu_torch.framework.config import AbstractConfig
from rag_arc_tpu_torch.framework.module import AbstractModule
from rag_arc_tpu_torch.framework.registry import Register, singleton

__all__ = ["AbstractConfig", "AbstractModule", "Register", "singleton"]
