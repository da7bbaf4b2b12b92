"""PyTorch text embeddings (counterpart of
``rag_arc_tpu/models/flax_embeddings.py::FlaxEncoderEmbeddings``).

Documents of at most ``PACK_MAX_TOKENS`` tokens are packed several to a
``PACK_ROW_LEN``-token row (``PackedTextEncoder``); longer ones are padded
to a length bucket (``TextEncoder``). Newlines are stripped before
encoding. Tokenization and packing use the port's copies of
``HashTokenizer`` and ``pack_token_lists`` (``models/tokenizer.py``,
``models/packing.py``).

Spans (``utils/tracing.py``): ``encoder.tokenize``; ``encoder.pack``,
packing and each chunk's host padding, with ``tokens`` (real tokens) and
``slots`` (the token slots the forward runs); ``encoder.forward`` (a
chunk's uploads and launches); ``encoder.readback``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from rag_arc_tpu_torch.models.embeddings import Embeddings
from rag_arc_tpu_torch.models.packing import pack_token_lists
from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
from rag_arc_tpu_torch.models.encoder import (
    PackedTextEncoder,
    TextEncoder,
    TransformerConfig,
    init_encoder,
)
from rag_arc_tpu_torch.utils.tracing import stage

LENGTH_BUCKETS = (16, 32, 64, 128, 256, 512)
PACK_MAX_TOKENS = 64
PACK_ROW_LEN = 128
PACK_MAX_SEGMENTS = 8
# encode() reads results back once per window of chunks, bounding the
# device memory that finished outputs hold
MAX_INFLIGHT_CHUNKS = 16


class TorchEncoderEmbeddings(Embeddings):
    def __init__(
        self,
        cfg: Optional[TransformerConfig] = None,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        tokenizer=None,
        batch_size: int = 64,
        seed: int = 0,
        pack_short: bool = True,
        *,
        device: torch.device | str,
    ):
        self.cfg = cfg or TransformerConfig()
        self.device = torch.device(device)
        # reproducible iff a fresh instance re-derives identical vectors
        self._reproducible = state_dict is None and tokenizer is None
        self._seed = seed
        self.model = init_encoder(self.cfg, seed, self.device)
        if state_dict is not None:
            self.model.load_state_dict(state_dict)
        self.packed_model = PackedTextEncoder(
            self.cfg, max_segments=PACK_MAX_SEGMENTS, trunk=self.model.trunk
        ).eval()
        self.tokenizer = tokenizer or HashTokenizer(
            vocab_size=self.cfg.vocab_size, max_len=self.cfg.max_len
        )
        self.batch_size = batch_size
        self.dim = self.cfg.dim
        # False: every text padded to its length bucket, none packed
        self.pack_short = bool(pack_short)
        # packed positions run up to the doc length: stay inside the table
        self._pack_max = min(PACK_MAX_TOKENS, self.cfg.max_len)

    def describe(self) -> dict:
        c = self.cfg
        return {
            "kind": "torch",
            "dim": self.dim,
            "seed": self._seed,
            "reproducible": self._reproducible,
            "cfg": {
                "vocab_size": c.vocab_size,
                "dim": c.dim,
                "depth": c.depth,
                "heads": c.heads,
                "mlp_ratio": c.mlp_ratio,
                "max_len": c.max_len,
                "causal": False,
                "dtype": str(c.dtype).removeprefix("torch."),
                "param_dtype": str(c.param_dtype).removeprefix("torch."),
            },
        }

    def _bucket_len(self, n: int) -> int:
        for b in LENGTH_BUCKETS:
            if b >= n and b <= self.cfg.max_len:
                return b
        return self.cfg.max_len

    @staticmethod
    def _pad_count(n: int) -> int:
        """Power-of-two batch padding, as the JAX package pads."""
        return 1 << math.ceil(math.log2(max(n, 1)))

    def _token_lists(self, texts: List[str]) -> List[List[int]]:
        with stage("encoder.tokenize"):
            if hasattr(self.tokenizer, "encode"):
                return [self.tokenizer.encode(t) for t in texts]
            out: List[List[int]] = []
            for start in range(0, len(texts), 256):
                chunk = texts[start : start + 256]
                ids, mask = self.tokenizer.batch_encode(chunk)
                out.extend(ids[i, mask[i]].tolist() for i in range(len(chunk)))
            return out

    def encode(self, texts: List[str]) -> np.ndarray:
        if not texts:
            return np.empty((0, self.dim), dtype=np.float32)
        cleaned = [t.replace("\n", " ") for t in texts]
        out = np.empty((len(cleaned), self.dim), dtype=np.float32)
        token_lists = self._token_lists(cleaned)
        pack_max = self._pack_max if self.pack_short else -1
        short = [i for i, tl in enumerate(token_lists) if len(tl) <= pack_max]
        long = [i for i, tl in enumerate(token_lists) if len(tl) > pack_max]
        if short:
            out[short] = self._encode_packed([token_lists[i] for i in short])
        if long:
            out[long] = self._encode_bucketed([token_lists[i] for i in long])
        return out

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    @torch.inference_mode()
    def _encode_packed(self, token_lists: List[List[int]]) -> np.ndarray:
        """Short docs: several to a row, block-diagonal attention, segment
        pooling; one readback per window of chunks."""
        with stage("encoder.pack"):
            ids, pos, seg, mapping = pack_token_lists(
                token_lists, row_len=PACK_ROW_LEN, max_segments=PACK_MAX_SEGMENTS
            )
            map_rows = np.asarray([r for r, _ in mapping], dtype=np.int64)
            map_segs = np.asarray([s for _, s in mapping], dtype=np.int64)
        n_rows = ids.shape[0]
        rows_per = max(self.batch_size, 65536 // PACK_ROW_LEN)
        out = np.empty((len(token_lists), self.dim), dtype=np.float32)
        window: list = []

        def drain() -> None:
            with stage("encoder.readback"):
                fetched = torch.cat([o for o, _, _ in window]).cpu().numpy()
            offset = 0
            for _, start, r in window:
                sel = np.nonzero((map_rows >= start) & (map_rows < start + r))[0]
                out[sel] = fetched[offset + map_rows[sel] - start, map_segs[sel]]
                offset += r
            window.clear()

        for start in range(0, n_rows, rows_per):
            with stage("encoder.pack") as span:
                cids = ids[start : start + rows_per]
                cpos = pos[start : start + rows_per]
                cseg = seg[start : start + rows_per]
                r = cids.shape[0]
                span["tokens"] = int(np.count_nonzero(cseg >= 0))
                r_pad = self._pad_count(r)
                if r_pad > r:
                    cids = np.pad(cids, ((0, r_pad - r), (0, 0)))
                    cpos = np.pad(cpos, ((0, r_pad - r), (0, 0)))
                    cseg = np.pad(cseg, ((0, r_pad - r), (0, 0)), constant_values=-1)
                span["slots"] = cids.size
            with stage("encoder.forward"):
                emb = self.packed_model(
                    self._upload(cids).long(), self._upload(cpos).long(),
                    self._upload(cseg).long(),
                )
            window.append((emb[:r], start, r))
            if len(window) >= MAX_INFLIGHT_CHUNKS:
                drain()
        drain()
        return out

    @torch.inference_mode()
    def _encode_bucketed(self, token_lists: List[List[int]]) -> np.ndarray:
        """Long docs: one per row, padded to a length bucket."""
        out = np.empty((len(token_lists), self.dim), dtype=np.float32)
        bs = self.batch_size
        window: list = []

        def drain() -> None:
            with stage("encoder.readback"):
                fetched = torch.cat([e for _, _, e in window]).cpu().numpy()
            offset = 0
            for start, n, _ in window:
                out[start : start + n] = fetched[offset : offset + n]
                offset += n
            window.clear()

        for start in range(0, len(token_lists), bs):
            with stage("encoder.pack") as span:
                chunk = token_lists[start : start + bs]
                length = self._bucket_len(max(len(tl) for tl in chunk))
                b_pad = self._pad_count(len(chunk))
                ids2 = np.zeros((b_pad, length), dtype=np.int64)
                mask2 = np.zeros((b_pad, length), dtype=bool)
                tokens = 0
                for i, tl in enumerate(chunk):
                    tl = tl[:length]
                    ids2[i, : len(tl)] = tl
                    mask2[i, : len(tl)] = True
                    tokens += len(tl)
                span["tokens"], span["slots"] = tokens, ids2.size
            with stage("encoder.forward"):
                emb = self.model(self._upload(ids2), self._upload(mask2))
            window.append((start, len(chunk), emb[: len(chunk)]))
            if len(window) >= MAX_INFLIGHT_CHUNKS:
                drain()
        drain()
        return out

    def embed_documents(self, texts: List[str]) -> List[List[float]]:
        return self.encode(texts).tolist()

    @torch.inference_mode()
    def encode_device(self, ids: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """Device-to-device path: (B, L) ids and mask on the encoder's
        device → (B, dim) f32 embeddings that stay there, for the chained
        encode → search."""
        return self.model(ids.long(), mask)
