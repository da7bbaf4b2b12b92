"""Vector-store snapshots (counterpart of ``rag_arc_tpu/index/persistence.py``,
flat indexes with a JSON docstore).

The format is the JAX package's ``rag_arc_tpu.store.v1``: a directory with
``manifest.json``, ``docstore.json`` and ``.npy`` arrays — ``emb.npy``
(f32 rows, or raw int8 codes), ``scales.npy`` (int8 block scales),
``valid.npy``, and for a residual sidecar ``res.npy`` / ``res_scales.npy``.
A snapshot either package writes loads in the other; int8 snapshots
restore bit-exactly through ``DeviceFlatIndex.restore_rows``. IVF and HNSW
indexes and the blob docstore are not ported yet.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from rag_arc_tpu_torch.models.embeddings import Embeddings
from rag_arc_tpu_torch.utils.data_model import Document
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore

FORMAT = "rag_arc_tpu.store.v1"

logger = logging.getLogger(__name__)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}

# fields the JAX package's loader reads for every snapshot; a flat store
# carries their defaults
_STORE_DEFAULTS = {
    "index_type": "flat",
    "nlist": 100,
    "nprobe": 8,
    "train_threshold": 100,
    "ivf_spill": 1,
    "ivf_spill_cap": 1.25,
}


def save_store(store: TorchVectorStore, path: str | Path) -> Path:
    """Write ``store`` as a snapshot directory at ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    index = store.index
    rows = [
        {"id": doc_id, "content": doc.content, "metadata": doc.metadata,
         "position": store.docstore.position_of(doc_id)}
        for doc_id, doc in store.docstore.items()
    ]
    (path / "docstore.json").write_text(json.dumps(rows, ensure_ascii=False), encoding="utf-8")
    manifest: Dict[str, Any] = {
        "docstore": "json",
        "format": FORMAT,
        "metric": store.metric,
        "dim": store._dim,
        **_STORE_DEFAULTS,
        "index_kind": None if index is None else "flat",
        "kf_mult": store.kf_mult,
        "embedding": store.embedding.describe(),
    }
    if index is not None:
        n = index.size
        manifest["dtype"] = _DTYPE_NAMES[index.dtype]
        if index.quantized:
            # raw int8 codes + block scales: a bit-exact round trip
            np.save(path / "emb.npy", index.emb[:n].cpu().numpy())
            np.save(path / "scales.npy", index.sqnorm[:n].cpu().numpy())
        else:
            np.save(path / "emb.npy", index.emb[:n].float().cpu().numpy())
        np.save(path / "valid.npy", index.valid[:n].cpu().numpy())
        manifest.update(
            size=n,
            quantized=index.quantized,
            n_deleted=index.n_deleted,
            gap_rows=index._gap_rows,
            refine=index.refine,
        )
        if index.refine:
            np.save(path / "res.npy", index.res[:n].cpu().numpy())
            np.save(path / "res_scales.npy", index.res_scale[:n].cpu().numpy())
    (path / "manifest.json").write_text(json.dumps(manifest), encoding="utf-8")
    return path


def _check_embedding(spec: Optional[dict], embedding: Embeddings) -> None:
    if not spec:
        return
    have = embedding.describe()
    if spec.get("dim") and have.get("dim") and spec["dim"] != have["dim"]:
        raise ValueError(
            f"snapshot was embedded at dim {spec['dim']} but the supplied "
            f"embedder is dim {have['dim']}"
        )
    if spec.get("kind") != have.get("kind"):
        logger.warning(
            "snapshot was embedded with %r but loading with %r — queries "
            "will score garbage unless these are equivalent",
            spec.get("kind"), have.get("kind"),
        )


def load_store(
    path: str | Path,
    embedding: Embeddings,
    dtype: Optional[torch.dtype] = None,
    *,
    device: torch.device | str,
) -> TorchVectorStore:
    """Load a snapshot directory into a new ``TorchVectorStore`` on
    ``device``. ``dtype`` defaults to the snapshot's storage dtype."""
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text(encoding="utf-8"))
    if manifest.get("format") != FORMAT:
        raise ValueError(f"unrecognized store snapshot format in {path}")
    if manifest.get("docstore") == "blob":
        raise NotImplementedError(
            "blob-docstore snapshots are not ported yet (ROADMAP Queue 1 #12)"
        )
    kind = manifest.get("index_kind")
    if kind not in ("flat", None):
        raise NotImplementedError(
            f"{kind} snapshots are not ported yet (ROADMAP Queue 1 #13)"
        )
    saved = {v: k for k, v in _DTYPE_NAMES.items()}.get(manifest.get("dtype"))
    if manifest.get("quantized"):
        if dtype not in (None, torch.int8):
            # raw int8 codes pasted into a float index would score garbage
            raise ValueError(
                f"snapshot at {path} stores int8 codes; load with dtype=None "
                f"(or torch.int8), not {dtype}"
            )
        dtype = torch.int8
    elif dtype is None:
        dtype = saved
    _check_embedding(manifest.get("embedding"), embedding)
    store = TorchVectorStore(
        embedding=embedding,
        dim=manifest["dim"],
        metric=manifest["metric"],
        # capacity from the snapshot: default-capacity growth doubles
        capacity=max(int(manifest.get("size") or 0), 1024),
        dtype=dtype,
        device=device,
        # snapshots without the key were built at the historical kf_mult 4
        kf_mult=manifest.get("kf_mult") or 4,
    )
    if kind == "flat":
        emb = np.load(path / "emb.npy")
        valid = np.load(path / "valid.npy")
        if emb.size and manifest.get("quantized") and (path / "scales.npy").exists():
            has_res = bool(manifest.get("refine")) and (path / "res.npy").exists()
            store.index.restore_rows(
                emb,
                np.load(path / "scales.npy"),
                valid,
                n_deleted=manifest.get("n_deleted", 0),
                gap_rows=manifest.get("gap_rows", 0),
                res=np.load(path / "res.npy") if has_res else None,
                res_scale=np.load(path / "res_scales.npy") if has_res else None,
                refine=manifest.get("refine"),
            )
        elif emb.size:
            # f32 rows already went through add-time preprocessing
            store.index.add(emb)
            dead = np.nonzero(~valid)[0]
            if dead.size:
                store.index.mark_deleted(dead)
    rows = json.loads((path / "docstore.json").read_text(encoding="utf-8"))
    docs = [Document(content=r["content"], metadata=r["metadata"], id=r["id"]) for r in rows]
    store.docstore.add(docs, [r["position"] for r in rows])
    return store
