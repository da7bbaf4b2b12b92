"""sentence-transformers adapter (counterpart of
``rag_arc_tpu/models/st_embeddings.py``, over the port's ``Embeddings``).

Capability parity with the reference's ``HuggingFaceEmbeddings``
(``core/file_management/embeddings/huggingface.py:9``): wraps a local
``SentenceTransformer`` checkpoint behind the same ``Embeddings``
interface (``model_kwargs`` / ``encode_kwargs`` passthrough, newline
stripping, ``embed_query`` = single-doc path). This is the
*compatibility* path for users with existing sentence-transformers
checkpoints; the port's own path is ``TorchEncoderEmbeddings`` (or
``models/bert.py::BertEmbeddings`` for BERT weights). Gated: the package
is imported when the adapter is built, and it needs weights already on
disk (``model_name_or_path`` pointing at a local directory). ``device``
is required, as on every constructor of the port, and overrides a
``device`` in ``model_kwargs``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from rag_arc_tpu_torch.models.embeddings import Embeddings


class SentenceTransformerEmbeddings(Embeddings):
    def __init__(
        self,
        model_name_or_path: str,
        model_kwargs: Optional[Dict[str, Any]] = None,
        encode_kwargs: Optional[Dict[str, Any]] = None,
        *,
        device: torch.device | str,
    ):
        try:
            from sentence_transformers import SentenceTransformer
        except ImportError as exc:  # pragma: no cover
            raise ImportError(
                "sentence-transformers is not installed; use "
                "TorchEncoderEmbeddings or HashEmbeddings"
            ) from exc
        self.model = SentenceTransformer(
            model_name_or_path, **dict(model_kwargs or {}, device=str(device))
        )
        self.encode_kwargs = dict(encode_kwargs or {})
        self.encode_kwargs.setdefault("normalize_embeddings", True)
        self.encode_kwargs.setdefault("batch_size", 32)
        self.dim = int(self.model.get_sentence_embedding_dimension())

    def encode(self, texts: List[str]) -> np.ndarray:
        if not texts:
            return np.empty((0, self.dim), dtype=np.float32)
        cleaned = [t.replace("\n", " ") for t in texts]  # huggingface.py:116
        out = self.model.encode(
            cleaned, convert_to_numpy=True, **self.encode_kwargs
        )
        return np.asarray(out, dtype=np.float32)

    def embed_documents(self, texts: List[str]) -> List[List[float]]:
        return self.encode(texts).tolist()
