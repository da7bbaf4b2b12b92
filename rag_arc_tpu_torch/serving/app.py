"""HTTP serving frontend (counterpart of ``rag_arc_tpu/serving/app.py``).

The reference intended a FastAPI layer but left it an empty stub
(``api/main.py``, 0 bytes). This is that layer: a threaded stdlib HTTP
server over a registry-built ``RagPipeline``.

Endpoints:
  POST /query   {"query": str, "k": int?}        → {"documents": [...]}
  POST /batch   {"queries": [str], "k": int?}    → {"results": [[...]]}
  POST /add     {"texts": [str], "metadatas"?}   → {"ids": [...]}
  POST /delete  {"ids": [str]}                    → {"deleted": bool}
  GET  /health                                    → {"status": "ok", ...}
  GET  /stats                                     → pipeline + batcher stats

Run: ``python -m rag_arc_tpu_torch.serving.app --config pipeline.json [--port N]``
where the JSON validates against ``PipelineConfig``, or ``--store DIR`` to
serve a ``tools/ingest.py`` snapshot. ``--device`` (default ``cuda``)
places a ``--store`` pipeline; a ``--config`` document names its own
``device``. The registry and the configs (pydantic) are imported only for
``--config``, so the handler and ``--store`` need no pydantic.
"""

from __future__ import annotations

import argparse
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional

from rag_arc_tpu_torch.serving.pipeline import RagPipeline
from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.utils.tracing import new_id, stage

logger = logging.getLogger(__name__)


class _BadRequest(ValueError):
    """A request that fails validation: answered 400 with its message."""


def _doc_json(doc: Document) -> Dict[str, Any]:
    return {"id": doc.id, "content": doc.content, "metadata": doc.metadata}


def _doc_ids_json(doc: Document) -> Dict[str, Any]:
    """ids+scores response mode: no content/metadata serialization. At
    ~60-token documents the full-content JSON dominates the host budget
    of a loaded 1-CPU serving box (profiled: ~2/3 of the no-op-stack gap);
    clients that hydrate documents from their own store only need the id
    and the ranking signal."""
    md = doc.metadata
    score = md.get("rerank_score", md.get("fusion_score"))
    return {"id": doc.id, "score": score}


def _doc_serializer(payload: Dict[str, Any]):
    mode = payload.get("response", "full")
    if mode == "ids":
        return _doc_ids_json
    if mode == "full":
        return _doc_json
    raise _BadRequest(f"response must be 'full' or 'ids', got {mode!r}")


class RagRequestHandler(BaseHTTPRequestHandler):
    """Each POST runs in an ``http.request`` span under a new request id:
    ``http.parse`` (body read, JSON, validation), the pipeline's work,
    then ``http.serialise`` (document JSON, ``json.dumps``, the write)."""

    pipeline: RagPipeline  # class attribute installed by make_server
    protocol_version = "HTTP/1.1"  # keep-alive: no per-request socket churn

    def log_message(self, fmt, *args):  # route through logging, not stderr
        logger.debug("http: " + fmt, *args)

    def _send(self, code: int, payload) -> None:
        """``payload``: a dict, or a callable that builds it (the document
        JSON, timed as serialisation)."""
        with stage("http.serialise") as span:
            try:
                if callable(payload):
                    payload = payload()
                body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
            except Exception as exc:  # noqa: BLE001 — HTTP boundary
                logger.exception("request failed")
                code = 500
                body = json.dumps({"error": str(exc)}, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
            span["bytes"] = len(body)

    def _read_json(self) -> Dict[str, Any]:
        length = int(self.headers.get("Content-Length", 0))
        return json.loads(self.rfile.read(length) or b"{}")

    def do_GET(self):  # noqa: N802
        if self.path == "/health":
            self._send(200, {"status": "ok", **self.pipeline.stats()["stages"]})
        elif self.path == "/stats":
            self._send(200, self.pipeline.stats())
        else:
            self._send(404, {"error": f"unknown path {self.path}"})

    def do_POST(self):  # noqa: N802
        with stage("http.request", request=new_id(), route=self.path) as request:
            try:
                code, payload = self._post(request)
            except _BadRequest as exc:
                code, payload = 400, {"error": str(exc)}
            except Exception as exc:  # noqa: BLE001 — HTTP boundary
                logger.exception("request failed")
                code, payload = 500, {"error": str(exc)}
            self._send(code, payload)

    def _post(self, request: Dict[str, Any]):
        """(status, payload) of a POST; a validation failure raises
        ``_BadRequest``."""
        if self.path == "/query":
            with stage("http.parse"):
                payload = self._read_json()
                # validate THIS request before it coalesces: an empty
                # query would fail invoke_batch's whole-batch validation
                # and 500 every other user's in-flight request
                query = payload.get("query", "")
                if not isinstance(query, str) or not query.strip():
                    raise _BadRequest("query must be a non-empty string")
                ser = _doc_serializer(payload)
            request["queries"] = 1
            docs = self.pipeline.query(query, k=payload.get("k"))
            return 200, lambda: {"documents": [ser(d) for d in docs]}
        if self.path == "/batch":
            with stage("http.parse"):
                payload = self._read_json()
                queries = payload.get("queries", [])
                # a bare string would pass the element check char-by-char
                # and fan out one search per character — require a list
                if not isinstance(queries, list) or not all(
                    isinstance(q, str) and q.strip() for q in queries
                ):
                    raise _BadRequest("queries must be a list of non-empty strings")
                ser = _doc_serializer(payload)
            request["queries"] = len(queries)
            results = self.pipeline.query_batch_shared(queries, k=payload.get("k"))
            return 200, lambda: {"results": [[ser(d) for d in docs] for docs in results]}
        if self.path == "/add":
            with stage("http.parse"):
                payload = self._read_json()
                retriever = self.pipeline.retriever
                add = getattr(retriever, "add_documents", None)
                if add is None:
                    raise _BadRequest("retriever does not support adds")
                texts = payload["texts"]
                if not isinstance(texts, list) or not all(
                    isinstance(t, str) for t in texts
                ):
                    raise _BadRequest("texts must be a list of strings")
                metadatas = payload.get("metadatas") or [{}] * len(texts)
                if len(metadatas) != len(texts):
                    # zip truncation would silently drop documents
                    raise _BadRequest("texts and metadatas length mismatch")
                docs = [
                    Document(content=t, metadata=dict(m))
                    for t, m in zip(texts, metadatas)
                ]
            return 200, {"ids": add(docs)}
        if self.path == "/delete":
            with stage("http.parse"):
                payload = self._read_json()
                delete = getattr(self.pipeline.retriever, "delete", None)
                if delete is None:
                    raise _BadRequest("retriever does not support deletes")
            return 200, {"deleted": bool(delete(payload.get("ids", [])))}
        return 404, {"error": f"unknown path {self.path}"}


class _RagHTTPServer(ThreadingHTTPServer):
    request_queue_size = 128  # accept-backlog must be set before bind
    daemon_threads = True


def make_server(pipeline: RagPipeline, port: int = 0) -> ThreadingHTTPServer:
    handler = type("BoundHandler", (RagRequestHandler,), {"pipeline": pipeline})
    return _RagHTTPServer(("0.0.0.0", port), handler)


def serve_forever(pipeline: RagPipeline, port: int) -> None:
    server = make_server(pipeline, port)
    logger.info("serving on :%d", server.server_port)
    server.serve_forever()


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description="rag_arc_tpu_torch serving frontend")
    ap.add_argument("--config", help="PipelineConfig JSON path")
    ap.add_argument(
        "--store",
        help="serve a tools/ingest.py snapshot directory directly "
        "(default dense pipeline; embedding dims read from the manifest)",
    )
    ap.add_argument("--dim", type=int, default=None,
                    help="embedding dim override for --store")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda",
                    help="device of a --store pipeline (a --config document "
                    "names its own)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if bool(args.config) == bool(args.store):
        ap.error("pass exactly one of --config or --store")
    if args.store:
        pipeline = _pipeline_from_store(args.store, args.dim, args.k, device=args.device)
    else:
        from rag_arc_tpu_torch.framework.registry import Register
        from rag_arc_tpu_torch.serving.configs import PipelineConfig

        registrator = Register()
        pipeline = registrator.register(args.config, "pipeline", PipelineConfig)
        if pipeline is None:
            return 1
    serve_forever(pipeline, args.port)
    return 0


def _pipeline_from_store(
    path: str, dim: Optional[int], k: int, *, device: str = "cuda"
):
    """Default pipeline over an ingest snapshot on ``device``: the embedder
    the manifest records (hash, or a reproducible ``torch`` encoder rebuilt
    from its config and seed), micro-batcher on.

    Accepts either a dense snapshot directory itself or an ingest output
    directory (tools/ingest.py writes the dense snapshot under
    ``out/dense`` plus an optional ``out/bm25.json`` twin). When the BM25
    twin exists the pipeline serves hybrid retrieval: dense + BM25 fanned
    out by MultiPath with RRF fusion — the reference's two-command flow
    ends at a hybrid service, not a dense-only one.
    """
    import json as _json
    from pathlib import Path as _Path

    from rag_arc_tpu_torch.index.persistence import load_store
    from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    root = _Path(path)
    dense = root if (root / "manifest.json").exists() else root / "dense"
    if not (dense / "manifest.json").exists():
        raise FileNotFoundError(
            f"no snapshot manifest under {root} (or {root}/dense) — "
            "point --store at a tools/ingest.py output directory"
        )
    manifest = _json.loads(
        (dense / "manifest.json").read_text(encoding="utf-8")
    )
    spec = manifest.get("embedding")
    if dim is not None and spec and spec.get("dim") and int(spec["dim"]) != dim:
        logger.warning(
            "--dim %d ignored: the snapshot records its embedder (dim %d) "
            "and queries must match the indexed space — the override only "
            "applies to legacy snapshots without an embedding spec",
            dim, int(spec["dim"]),
        )
    if dim is None:
        dim = int(manifest["dim"])
    if spec is None:
        # pre-spec snapshot: the historical behavior (ingest's default)
        logger.warning(
            "snapshot has no embedding spec; assuming hash embeddings at "
            "dim %d — pass --config if the corpus was embedded differently",
            dim,
        )
        embedder = HashEmbeddings(dim=dim)
    elif spec.get("kind") == "hash":
        embedder = HashEmbeddings(dim=int(spec.get("dim") or dim))
    elif spec.get("kind") == "torch" and spec.get("reproducible"):
        import torch

        from rag_arc_tpu_torch.models.encoder import TransformerConfig
        from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

        cfg = dict(spec["cfg"])
        for key in ("dtype", "param_dtype"):
            if key in cfg:
                cfg[key] = getattr(torch, cfg[key])
        embedder = TorchEncoderEmbeddings(
            cfg=TransformerConfig(**cfg), seed=int(spec.get("seed", 0)), device=device
        )
    else:
        # a "flax" spec lands here too: the port cannot re-derive Flax's
        # seeded weights
        raise ValueError(
            f"snapshot was embedded with {spec.get('kind')!r} embeddings "
            "that cannot be rebuilt from the manifest (custom weights or "
            "tokenizer) — serve it through --config with the matching "
            "embedder instead of --store"
        )
    store = load_store(str(dense), embedder, device=device)
    retriever = store.as_retriever(search_kwargs={"k": k})

    bm25_path = root / "bm25.json"
    if bm25_path.exists():
        from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever
        from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever

        sparse = BM25Retriever.load_from_disk(bm25_path, device=device)
        retriever = MultiPathRetriever([retriever, sparse], top_k=k)
        logger.info("serving hybrid: dense(%s) + bm25(%s)", dense, bm25_path)
    return RagPipeline(retriever=retriever, top_k=k)


if __name__ == "__main__":
    raise SystemExit(main())
