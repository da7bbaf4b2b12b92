"""Serving: the query micro-batcher, ``RagPipeline``, the HTTP app and the
typed pipeline configs.

``PipelineConfig`` (pydantic) loads on first access, so serving a snapshot
(``app --store``) imports no pydantic.
"""

from rag_arc_tpu_torch.serving.batcher import QueryBatcher
from rag_arc_tpu_torch.serving.pipeline import RagPipeline

__all__ = ["QueryBatcher", "RagPipeline", "PipelineConfig"]


def __getattr__(name: str):
    if name == "PipelineConfig":
        from rag_arc_tpu_torch.serving.configs import PipelineConfig

        return PipelineConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
