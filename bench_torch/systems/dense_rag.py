"""Dense RAG as the port serves it: the 768×12 encoder chained into the
bf16 cosine ``DeviceFlatIndex`` of a ``TorchVectorStore`` over a
``BlobDocstore``, behind ``RagPipeline`` and the HTTP app, with an optional
Qwen3 cross-encoder reranker.

Set-up makes the fixed corpus once per checkout as a docstore (the
program's ``BlobDocstore.add``, kept under ``.bench_cache/`` by a digest of
the corpus's parameters, the text generator and the docstore's source, and
read through once a run so that its pages are in memory), then every
run makes the weights from its seed on the card and adds the corpus
vectors through ``DeviceFlatIndex.add`` (host f32 in blocks, as
``tools/serving_bench.py`` injects a corpus). An ingest cell starts from an
empty store sized as ``tools/ingest.py`` sizes one.

Checks, against the plain references (``bench_torch/reference``):

- served: each kept answer's rank gap against the exact top-k of the
  f32 encoder's query vector over the stored (bf16) rows, the resolved
  content against the passage, and with a reranker the f32 Qwen3's
  yes-minus-no logit of each pair;
- ingest: each sampled document read back by id, its content and its
  stored vector against the f32 encoder's vector rounded as stored.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
import queue
import shutil
import threading
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from bench_torch import data, roofline, weights
from bench_torch.reference import encoder as ref_encoder
from bench_torch.reference import exact_f32, f32_mm
from bench_torch.reference import qwen3 as ref_qwen3
from bench_torch.reference import text as ref_text
from bench_torch.reference.topk import exact_topk, stored_rows
from bench_torch.trace import wrap


def _dtype(torch, name: str):
    return getattr(torch, name)


class DenseRag:
    def __init__(self, cfg: dict, seed: int, device, cache_dir: Path, run_dir: Path, torch):
        self.cfg, self.seed, self.device, self.torch = cfg, seed, device, torch
        self.cache_dir, self.run_dir = cache_dir, run_dir
        self.enc_cfg = cfg["encoder"]
        self.corpus = cfg["corpus"]
        self.rr_cfg = cfg.get("reranker")
        self.pipeline = self.store = self.reranker = None
        self.stages: Dict[str, float] = {}  # set-up seconds by stage, for the log

    # -- building -------------------------------------------------------------

    def _embeddings(self):
        torch = self.torch
        from rag_arc_tpu_torch.models.encoder import TransformerConfig
        from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

        c = self.enc_cfg
        tcfg = TransformerConfig(
            vocab_size=c["vocab_size"], dim=c["hidden_size"], depth=c["num_hidden_layers"],
            heads=c["num_attention_heads"], mlp_ratio=c["intermediate_size"] // c["hidden_size"],
            max_len=c["max_position_embeddings"], dtype=_dtype(torch, c["dtype"]),
            param_dtype=_dtype(torch, c["param_dtype"]))
        sd = weights.encoder_weights(c, self.seed, self.device, _dtype(torch, c["param_dtype"]))
        return TorchEncoderEmbeddings(tcfg, state_dict=sd, device=self.device)

    def _reranker(self):
        torch = self.torch
        from rag_arc_tpu_torch.models.qwen3 import Qwen3Config, Qwen3LM
        from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
        from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker

        c = self.rr_cfg
        dt = _dtype(torch, c["dtype"])
        qcfg = Qwen3Config(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"], num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            max_position_embeddings=c["max_position_embeddings"], rope_theta=c["rope_theta"],
            rms_norm_eps=c["rms_norm_eps"], tie_word_embeddings=c["tie_word_embeddings"],
            dtype=dt, param_dtype=dt)
        model = Qwen3LM(qcfg, device="meta").to_empty(device=self.device)
        model.load_state_dict(weights.qwen3_weights(c, self.seed, self.device, dt))
        model.eval()
        self.qcfg = qcfg
        tok = HashTokenizer(vocab_size=qcfg.vocab_size, max_len=c["max_prompt_tokens"])
        return CrossEncoderReranker.from_causal_lm(model, None, tok, device=self.device)

    def _docstore_dir(self) -> Path:
        """The corpus's documents, made once per checkout through the
        program's ``BlobDocstore.add`` and reopened by every later run. The
        directory is named by a digest of what its bytes follow from, so a
        changed corpus or docstore format builds a new one."""
        from rag_arc_tpu_torch.index import blob_docstore
        from rag_arc_tpu_torch.utils.data_model import Document

        c = self.corpus
        digest = hashlib.sha256(json.dumps(c, sort_keys=True).encode())
        for src in (data.__file__, blob_docstore.__file__):
            digest.update(Path(src).read_bytes())
        final = self.cache_dir / f"docstore_{self.cfg['name']}_{digest.hexdigest()[:16]}"
        if (final / "index.npz").exists():
            return final
        tmp = final.with_name(final.name + ".partial")
        shutil.rmtree(tmp, ignore_errors=True)
        store = blob_docstore.BlobDocstore(tmp, cache_docs=0)
        law = c["passage_words"]
        for chunk in range(data.n_blocks(c["rows"], data.TEXT_CHUNK)):
            texts = data.passage_chunk(c["seed"], chunk, c["rows"], law)
            lo = chunk * data.TEXT_CHUNK
            store.add([Document(content=t, id=data.passage_id(lo + i)) for i, t in enumerate(texts)],
                      list(range(lo, lo + len(texts))))
        store.save(tmp)
        store.close()
        tmp.rename(final)
        return final

    @staticmethod
    def _read_through(path: Path) -> None:
        """Read every file of ``path`` once, so the served window's random
        record reads find their pages in memory, as a server's do once it
        has run a while."""
        for f in sorted(path.iterdir()):
            if f.is_file():
                with open(f, "rb") as fh:
                    while fh.read(64 << 20):
                        pass

    def _add_corpus(self, index) -> None:
        """Every corpus block made on the card, read back as host f32 and
        added through ``DeviceFlatIndex.add`` (which normalizes on the
        host); the next block is made while the index adds this one."""
        torch, c = self.torch, self.corpus
        blocks: "queue.Queue" = queue.Queue(maxsize=2)

        def produce() -> None:
            try:
                for b in range(data.n_blocks(c["rows"], data.VECTOR_BLOCK)):
                    x = data.vector_block(torch, c["seed"], b, c["rows"], c["dim"], self.device)
                    blocks.put(x.cpu().numpy())
            except BaseException as exc:  # noqa: BLE001 — handed to the consumer
                blocks.put(exc)
                return
            blocks.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = blocks.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            index.add(item)
        t.join()
        if index.size != c["rows"]:
            raise RuntimeError(f"index holds {index.size} rows, not {c['rows']}")

    def build_served(self) -> None:
        torch = self.torch
        from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
        from rag_arc_tpu_torch.serving.pipeline import RagPipeline

        c, p = self.corpus, self.cfg["pipeline"]
        t = time.time()
        docs = self._docstore_dir()
        self.stages["docstore"] = time.time() - t
        t = time.time()
        self._read_through(docs)
        self.stages["docstore_read"] = time.time() - t
        t = time.time()
        self.emb = self._embeddings()
        self.stages["encoder"] = time.time() - t
        t = time.time()
        self.store = TorchVectorStore(self.emb, dim=c["dim"], metric=c["metric"],
                                      capacity=c["rows"], dtype=_dtype(torch, c["dtype"]),
                                      docstore_path=str(docs), device=self.device)
        if len(self.store.docstore) != c["rows"]:
            raise RuntimeError(f"docstore holds {len(self.store.docstore)} documents")
        self._add_corpus(self.store.index)
        self.stages["corpus_add"] = time.time() - t
        if self.rr_cfg is not None:
            t = time.time()
            self.reranker = self._reranker()
            self.stages["reranker"] = time.time() - t
        self.pipeline = RagPipeline(
            self.store.as_retriever(search_kwargs={"k": p["top_k"]}), reranker=self.reranker,
            top_k=p["top_k"], recall_k=p["recall_k"], batch_max=p["batch_max"],
            batch_wait_ms=p["batch_wait_ms"])

    def build_ingest(self) -> None:
        torch = self.torch
        from rag_arc_tpu_torch.index.vector_store import TorchVectorStore

        c = self.corpus
        t = time.time()
        self.emb = self._embeddings()
        self.stages["encoder"] = time.time() - t
        shutil.rmtree(self.run_dir / "ingest_docstore", ignore_errors=True)
        self.store = TorchVectorStore(self.emb, dim=c["dim"], metric=c["metric"],
                                      capacity=max(c["rows"], 1024),
                                      dtype=_dtype(torch, c["dtype"]),
                                      docstore_path=str(self.run_dir / "ingest_docstore"),
                                      device=self.device)

    # -- warm-up ----------------------------------------------------------------

    def warmup_served(self, traffic: dict) -> None:
        """Every padded batch size up to the traffic's ``warm_max_batch``
        (the largest its coalesced batches reach; default the batcher's
        cap), at each query length bucket it reaches; with a reranker, each
        prompt length bucket its pairs reach."""
        from rag_arc_tpu_torch.utils.data_model import Document

        rng = np.random.default_rng(data.subseed(self.seed, 5))
        cap = traffic["query_words"]["cap"]
        word_counts = sorted({1, cap})
        top = int(traffic.get("warm_max_batch", self.cfg["pipeline"]["batch_max"]))
        sizes = [1 << i for i in range(top.bit_length())]
        for words in word_counts:
            for b in sizes:
                texts = data.random_texts(rng, np.full(b, words))
                self.pipeline.query_batch(texts)
        if self.reranker is not None:
            law = self.corpus["passage_words"]
            for words in sorted({law["cap"], int(law["mean"]), 8}):
                docs = [Document(content=t) for t in data.random_texts(rng, np.full(100, words))]
                self.reranker.rerank_batch(["warm up query"], [docs], k=10)
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def warmup_ingest(self, batches) -> None:
        """The encoder at the ingest batch's packed and bucketed shapes."""
        for batch in batches:
            self.emb.encode([t for _, t in batch])

    # -- the ingest job ---------------------------------------------------------

    def ingest(self, batch) -> int:
        from rag_arc_tpu_torch.utils.data_model import Document

        ids = self.store.add_documents([Document(content=t, id=i) for i, t in batch])
        return len(ids)

    # -- tracing ----------------------------------------------------------------

    def instrument(self, spans, kind: str) -> None:
        """Ranges and host spans around the layers (traced runs only)."""
        torch = self.torch
        if kind == "ingest":
            wrap(self.emb, "encode", "encode", spans, torch)
            wrap(self.store.index, "add", "index_add", spans, torch, host=True)
            wrap(self.store.docstore, "add", "docstore_add", spans, torch, host=True)
            return
        batcher = self.pipeline.batcher
        inner_fn = batcher.batch_fn

        def batch_fn(queries, **kw):
            spans.local.batch = len(queries)
            with torch.profiler.record_function("bench.batch"):
                return inner_fn(queries, **kw)

        batcher.batch_fn = batch_fn
        wrap(self.emb, "encode_device", "encode", spans, torch)
        index = self.store.index

        def search_work(args, kwargs):
            b = getattr(spans.local, "batch", args[0].shape[0])
            spans.record("search", (time.time(), [(b, index.n_active)]))

        wrap(index, "search_device", "search", spans, torch, before=search_work)
        wrap(self.store, "_resolve", "resolve", spans, torch, host=True, ranged=False)
        if self.reranker is not None:
            from rag_arc_tpu_torch.models import qwen3 as q3

            rr = self.reranker

            def rerank_work(args, kwargs):
                spans.record("rerank_queries", (time.time(), [len(args[0])]))

            wrap(rr, "rerank_batch", "rerank", spans, torch, before=rerank_work)
            encode = rr._encode_bucketed

            def encode_recorded(prompts):
                ids, mask = encode(prompts)
                spans.record("pairs", (time.time(), mask.sum(axis=1).tolist()))
                return ids, mask

            rr._encode_bucketed = encode_recorded
            wrap(q3, "rope_prep", "attn", spans, torch)
            wrap(q3, "flash_attention", "attn", spans, torch)

    # -- work counts ------------------------------------------------------------

    def query_flops(self, words: List[int]) -> float:
        """Encoder over each query's real tokens, and its exact scoring."""
        c, n = self.enc_cfg, self.corpus
        total = 0.0
        for w in words:
            length = min(w + 2, c["max_position_embeddings"])
            total += roofline.encoder_flops(length, c["hidden_size"], c["num_hidden_layers"],
                                            c["intermediate_size"])
            total += roofline.search_flops(1, n["rows"], n["dim"])
        return total

    def passage_flops(self, words: List[int]) -> float:
        c = self.enc_cfg
        return sum(roofline.encoder_flops(min(w + 2, c["max_position_embeddings"]),
                                          c["hidden_size"], c["num_hidden_layers"],
                                          c["intermediate_size"]) for w in words)

    def rerank_flops(self, pair_lengths: List[int]) -> float:
        return sum(roofline.rerank_model_flops(self.qcfg, int(n)) for n in pair_lengths)

    def attention_bound_s(self, pair_lengths: List[int]) -> float:
        q = self.qcfg
        return q.num_hidden_layers * sum(
            roofline.attention_layer_bound_s(int(n), q.num_attention_heads,
                                             q.num_key_value_heads, q.head_dim)
            for n in pair_lengths)

    def search_bound_s(self, searches) -> float:
        d = self.corpus["dim"]
        row_bytes = {"bfloat16": 2, "float32": 4, "int8": 1}[self.corpus["dtype"]]
        k = self.cfg["pipeline"]["recall_k"] if self.reranker else self.cfg["pipeline"]["top_k"]
        return sum(roofline.search_bound_s(b, n, d, row_bytes, k) for b, n in searches)

    # -- freeing ----------------------------------------------------------------

    def free(self) -> None:
        """Drop the program's state before the references run."""
        if self.store is not None and hasattr(self.store.docstore, "close"):
            self.store.docstore.close()
        self.pipeline = self.store = self.reranker = self.emb = None
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    # -- checks -----------------------------------------------------------------

    def served_answers(self, kept: Dict[int, dict], queries_of: Dict[int, List[str]]):
        """What the timed path answered for the kept requests: per query its
        served positions, contents and rerank probabilities (None without a
        reranker), and the count of answers of the wrong shape."""
        c, k = self.corpus, self.cfg["pipeline"]["top_k"]
        qs, positions, contents, probs, bad = [], [], [], [], 0
        for rid, resp in sorted(kept.items()):
            results = resp.get("results")
            if results is None or len(results) != len(queries_of[rid]):
                bad += 1
                continue
            for q, docs in zip(queries_of[rid], results):
                row, cont, pr = [], [], []
                for d in docs[:k]:
                    pid = str(d.get("id", ""))
                    pos = int(pid[1:]) if pid[:1] == "p" and pid[1:].isdigit() else -1
                    row.append(pos if 0 <= pos < c["rows"] else -1)
                    cont.append(d.get("content"))
                    pr.append(float((d.get("metadata") or {}).get("rerank_score", math.nan)))
                if len(row) != k:
                    bad += 1
                pad = k - len(row)
                qs.append(q)
                positions.append(row + [-1] * pad)
                contents.append(cont + [None] * pad)
                probs.append(pr + [math.nan] * pad)
        return qs, positions, contents, (probs if self.rr_cfg is not None else None), bad

    def control_answers(self, qs: List[str], mm):
        """The plain references in the program's place, computing with ``mm``
        (the control: fp8): the same entry, recall, rerank and top k."""
        c, p = self.corpus, self.cfg["pipeline"]
        k = p["top_k"]
        exact_f32()
        qv = self._ref_queries(qs, mm)
        depth = p["recall_k"] if self.rr_cfg is not None else k
        _, ref_p, _ = exact_topk(qv, depth, c, self.device, mm=mm)
        cand = ref_p.tolist()
        texts = data.passages_at(c["seed"], {x for r in cand for x in r}, c["rows"],
                                 c["passage_words"])
        if self.rr_cfg is None:
            return [r[:k] for r in cand], [[texts[x] for x in r[:k]] for r in cand], None
        gaps = self._ref_rerank(qs, cand, texts, mm)
        positions, contents, probs = [], [], []
        for i, row in enumerate(cand):
            order = sorted(row, key=lambda x: -gaps[(i, x)])[:k]
            positions.append(order)
            contents.append([texts[x] for x in order])
            probs.append([1.0 / (1.0 + math.exp(-gaps[(i, x)])) for x in order])
        return positions, contents, probs

    def _ref_queries(self, qs: List[str], mm):
        e = self.enc_cfg
        w = weights.encoder_weights(e, self.seed, self.device,
                                    _dtype(self.torch, e["param_dtype"]))
        toks = [ref_text.tokens(q, e["vocab_size"], e["max_position_embeddings"]) for q in qs]
        return ref_encoder.encode(w, toks, e, self.device, mm=mm)

    def _ref_rerank(self, qs, cand_rows, texts, mm) -> Dict[tuple, float]:
        """{(query index, position): yes-minus-no logit} of the reference."""
        rc = self.rr_cfg
        vocab = rc["vocab_size"]
        yes, no = ref_text.token_id("yes", vocab), ref_text.token_id("no", vocab)
        prompts, owner = [], []
        for i, row in enumerate(cand_rows):
            for x in row:
                prompts.append(ref_text.tokens(ref_text.rerank_prompt(qs[i], texts[x]), vocab,
                                               rc["max_prompt_tokens"], keep="tail"))
                owner.append((i, x))
        w = weights.qwen3_weights(rc, self.seed, self.device, _dtype(self.torch, rc["dtype"]))
        gaps = ref_qwen3.yes_no_gap(w, prompts, rc, yes, no, self.device, mm=mm).tolist()
        return dict(zip(owner, gaps))

    def evaluate_served(self, qs, positions, contents, probs, bad: int) -> Dict[str, float]:
        """The numbers compared, against the f32 references:

        - ``bad_answers``: answers missing, failed or not k long;
        - ``content_mismatch``: served documents whose id is no corpus
          position or whose content is not that passage's;
        - ``rank_gap`` (no reranker): the largest amount by which the
          reference's r-th best score exceeds the score of the served r-th;
        - ``retrieval_gap`` (reranker): the largest amount by which a served
          document scores below the reference's recall_k-th best;
        - ``rerank_gap``: as ``rank_gap`` in the reranker's yes-minus-no
          logit, over the robust candidates and the served ones;
        - ``rerank_score_err``: the largest |logit(served P(yes)) - reference|.
        """
        exact_f32()
        c, p = self.corpus, self.cfg["pipeline"]
        k = p["top_k"]
        out = {"bad_answers": float(bad)}
        if not qs:
            out["bad_answers"] = float(max(bad, 1))
            return out
        texts = data.passages_at(c["seed"], {x for r in positions for x in r if x >= 0},
                                 c["rows"], c["passage_words"])
        out["content_mismatch"] = float(sum(
            1 for row, cont in zip(positions, contents) for x, t in zip(row, cont)
            if x < 0 or t != texts.get(x)))
        qv = self._ref_queries(qs, f32_mm)
        depth = p["recall_k"] if self.rr_cfg is not None else k
        ref_s, ref_p, ex_s = exact_topk(qv, depth, c, self.device, extra=positions)
        if self.rr_cfg is None:
            out["rank_gap"] = float((ref_s[:, :k] - ex_s).max())
            return out
        out["retrieval_gap"] = float((ref_s[:, depth - 1:depth] - ex_s).max())
        margin = self.cfg["limits"]["retrieval_gap"]
        cand = []
        for i in range(len(qs)):
            edge = float(ref_s[i, depth - 1])
            core = {int(x) for s_, x in zip(ref_s[i].tolist(), ref_p[i].tolist())
                    if s_ >= edge + margin}
            cand.append(sorted(core | {x for x in positions[i] if x >= 0}))
        need = {x for row in cand for x in row} - set(texts)
        texts.update(data.passages_at(c["seed"], need, c["rows"], c["passage_words"]))
        ref = self._ref_rerank(qs, cand, texts, f32_mm)
        rank_gap, score_err = -math.inf, 0.0
        for i, row in enumerate(cand):
            best = sorted((ref[(i, x)] for x in row), reverse=True)
            for r, (x, prob) in enumerate(zip(positions[i], probs[i])):
                if x < 0:
                    continue
                rank_gap = max(rank_gap, best[r] - ref[(i, x)])
                if not 0.0 < prob < 1.0:
                    score_err = math.inf
                    continue
                score_err = max(score_err, abs(math.log(prob / (1.0 - prob)) - ref[(i, x)]))
        out["rerank_gap"] = rank_gap
        out["rerank_score_err"] = score_err
        return out

    def ingest_answers(self, sample: List[tuple]):
        """Each sampled document read back by id: (content or None, stored
        row as host f32 or None)."""
        store = self.store
        got = {d.id: d for d in store.get_by_ids([i for i, _, _ in sample])}
        out = []
        for i, _, _ in sample:
            if i not in got:
                out.append((None, None))
                continue
            pos = store.docstore.position_of(i)
            out.append((got[i].content, store.index.take(np.asarray([pos]))[0]))
        return out

    def control_ingest_answers(self, sample: List[tuple], mm):
        torch = self.torch
        exact_f32()
        rows = stored_rows(self._ref_queries([t for _, t, _ in sample], mm),
                           _dtype(torch, self.corpus["dtype"]))
        return [(t, rows[j].cpu().numpy()) for j, (_, t, _) in enumerate(sample)]

    def evaluate_ingest(self, sample: List[tuple], answers) -> Dict[str, float]:
        """``missing``: documents not found by id; ``content_mismatch``;
        ``vector_err``: the largest L2 distance between a stored row and the
        f32 encoder's vector of the text, rounded as the index stores it."""
        torch = self.torch
        exact_f32()
        missing = sum(1 for cont, _ in answers if cont is None)
        mismatch = sum(1 for (_, t, _), (cont, _) in zip(sample, answers)
                       if cont is not None and cont != t)
        present = [(t, row) for (_, t, _), (cont, row) in zip(sample, answers) if row is not None]
        out = {"missing": float(missing), "content_mismatch": float(mismatch)}
        if not present:
            out["vector_err"] = math.inf
            return out
        want = stored_rows(self._ref_queries([t for t, _ in present], f32_mm),
                           _dtype(torch, self.corpus["dtype"]))
        got = torch.from_numpy(np.stack([r for _, r in present])).to(self.device).float()
        out["vector_err"] = float((got - want).norm(dim=1).max())
        return out


SYSTEM = DenseRag
