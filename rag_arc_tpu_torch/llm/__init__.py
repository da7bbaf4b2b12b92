from rag_arc_tpu_torch.llm.base import LLMBase
from rag_arc_tpu_torch.llm.fake import FakeLLM
from rag_arc_tpu_torch.llm.openai_compat import OpenAICompatLLM

__all__ = ["LLMBase", "FakeLLM", "OpenAICompatLLM"]
