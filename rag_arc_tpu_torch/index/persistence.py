"""Vector-store snapshots (counterpart of ``rag_arc_tpu/index/persistence.py``).

The format is the JAX package's ``rag_arc_tpu.store.v1``: a directory with
``manifest.json``, ``docstore.json`` and ``.npy`` arrays, by index kind:

- flat: ``emb.npy`` (f32 rows, or raw int8 codes), ``scales.npy`` (int8
  block scales), ``valid.npy``, and for a residual sidecar ``res.npy`` /
  ``res_scales.npy``; int8 snapshots restore bit-exactly through
  ``DeviceFlatIndex.restore_rows``;
- ivf: ``centroids.npy``, ``lists.npy`` (f32 rows, or the raw int8
  residual codes), ``sqnorm.npy`` (squared norms or scales), ``valid.npy``,
  ``pos.npy`` and ``fill.npy``; the slot maps are rebuilt from ``pos``;
- hnsw: ``hnsw.bin``, the native engine's own snapshot (vectors, links,
  deleted flags), with ``hnsw.bin.refine.npz`` for a PQ refine copy.

A snapshot either package writes loads in the other. The port also
writes the IVF lists' storage dtype as the manifest's ``dtype`` (the JAX
package writes it for flat indexes only and reloads IVF lists as f32 or
int8); an IVF snapshot without it reloads as f32. A store on the disk-backed ``BlobDocstore`` snapshots its blob and
position arrays under ``docstore_blob/`` (manifest ``"docstore": "blob"``)
instead of ``docstore.json``, and a loaded blob snapshot reattaches in
place.
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
from rag_arc_tpu_torch.index.blob_docstore import BlobDocstore
from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
from rag_arc_tpu_torch.index.hnsw import HNSWIndex
from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
from rag_arc_tpu_torch.index.vector_store import TorchVectorStore

FORMAT = "rag_arc_tpu.store.v1"

logger = logging.getLogger(__name__)

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.int8: "int8"}
_DTYPES = {v: k for k, v in _DTYPE_NAMES.items()}


def save_store(store: TorchVectorStore, path: str | Path) -> Path:
    """Write ``store`` as a snapshot directory at ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    index = store.index
    if isinstance(store.docstore, BlobDocstore):
        # disk-backed store: the blob and its position arrays, never the
        # corpus materialized in RAM
        store.docstore.save(path / "docstore_blob")
        docstore_kind = "blob"
    else:
        rows = [
            {"id": doc_id, "content": doc.content, "metadata": doc.metadata,
             "position": store.docstore.position_of(doc_id)}
            for doc_id, doc in store.docstore.items()
        ]
        (path / "docstore.json").write_text(
            json.dumps(rows, ensure_ascii=False), encoding="utf-8"
        )
        docstore_kind = "json"
    manifest: Dict[str, Any] = {
        "docstore": docstore_kind,
        "format": FORMAT,
        "metric": store.metric,
        "index_type": store.index_type,
        "dim": store._dim,
        "nlist": store.nlist,
        "nprobe": store.nprobe,
        "train_threshold": store.train_threshold,
        "index_kind": None if index is None else index.stats()["kind"],
        "kf_mult": store.kf_mult,
        "ivf_spill": store.ivf_spill,
        "ivf_spill_cap": store.ivf_spill_cap,
        "embedding": store.embedding.describe(),
    }
    if isinstance(index, DeviceIVFIndex):
        _save_ivf(index, path, manifest)
    elif isinstance(index, HNSWIndex):
        # the native snapshot carries vectors, links and deleted flags
        index.save(path / "hnsw.bin")
        manifest.update(size=index.size, M=index.M, ef_search=index.ef_search)
    elif isinstance(index, DeviceFlatIndex):
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
    elif index is not None:
        raise NotImplementedError(
            f"save_store has no serializer for index kind {type(index).__name__};"
            " refusing to write a vectorless snapshot"
        )
    (path / "manifest.json").write_text(json.dumps(manifest), encoding="utf-8")
    return path


def _save_ivf(index: DeviceIVFIndex, path: Path, manifest: Dict[str, Any]) -> None:
    np.save(path / "centroids.npy", index.centroids.cpu().numpy())
    # int8 lists as raw residual codes (scales in sqnorm.npy): bit-exact
    np.save(path / "lists.npy", index.lists.cpu().numpy() if index.quantized
            else index.lists.float().cpu().numpy())
    np.save(path / "sqnorm.npy", index.sqnorm.cpu().numpy())
    np.save(path / "valid.npy", index.valid.cpu().numpy())
    np.save(path / "pos.npy", index.pos.cpu().numpy())
    np.save(path / "fill.npy", index._fill)
    manifest.update(
        size=index.size,
        lmax=index.lmax,
        n_deleted=index.n_deleted,
        quantized=index.quantized,
        spill=index.spill,
        spill_cap=index.spill_cap,
        dtype=_DTYPE_NAMES[index.dtype],
    )


def _load_ivf(path: Path, manifest: Dict[str, Any], dtype: Optional[torch.dtype],
              device) -> DeviceIVFIndex:
    """The IVF index of a snapshot, its slot maps rebuilt from ``pos``:
    spilled rows appear once per copy, occurrence 0 feeding the primary
    maps and the rest the extra maps (``mark_deleted`` clears every
    copy)."""
    nlist = manifest["nlist"]
    index = DeviceIVFIndex(
        dim=manifest["dim"], nlist=nlist, nprobe=manifest["nprobe"],
        metric=manifest["metric"], dtype=dtype or torch.float32,
        spill=manifest.get("spill", 1),
        spill_cap=manifest.get("spill_cap", 1.25), device=device,
    )
    centroids = np.load(path / "centroids.npy")
    # a snapshot from a mesh may carry a padded cluster axis
    index.nlist_pad = centroids.shape[0]
    cluster_valid = np.zeros(index.nlist_pad, dtype=bool)
    cluster_valid[:nlist] = True
    index._centroids_np = centroids[:nlist].astype(np.float32)
    index.lmax = manifest["lmax"]
    pos = np.load(path / "pos.npy")
    index._place(np.load(path / "lists.npy"), np.load(path / "sqnorm.npy"),
                 np.load(path / "valid.npy"), pos, centroids, cluster_valid)
    index._fill = np.load(path / "fill.npy")
    size = index.size = manifest["size"]
    index.n_deleted = manifest["n_deleted"]
    cl, sl = np.nonzero(pos >= 0)
    p = pos[cl, sl]
    index._pos_cluster = np.full(size, -1, dtype=np.int32)
    index._pos_slot = np.full(size, -1, dtype=np.int32)
    if index.spill > 1:
        index._pos_xcluster = np.full((size, index.spill - 1), -1, dtype=np.int32)
        index._pos_xslot = np.full((size, index.spill - 1), -1, dtype=np.int32)
        order = np.argsort(p, kind="stable")
        ps, cls, sls = p[order], cl[order], sl[order]
        occ = np.arange(len(ps)) - np.searchsorted(ps, ps, side="left")
        prim = occ == 0
        index._pos_cluster[ps[prim]] = cls[prim].astype(np.int32)
        index._pos_slot[ps[prim]] = sls[prim].astype(np.int32)
        extra = ~prim
        index._pos_xcluster[ps[extra], occ[extra] - 1] = cls[extra].astype(np.int32)
        index._pos_xslot[ps[extra], occ[extra] - 1] = sls[extra].astype(np.int32)
    else:
        index._pos_cluster[p] = cl.astype(np.int32)
        index._pos_slot[p] = sl.astype(np.int32)
    return index


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
    blob_backed = manifest.get("docstore") == "blob"
    kind = manifest.get("index_kind")
    if kind not in ("flat", "ivf", "hnsw", None):
        raise ValueError(f"unknown index kind {kind!r} in {path}")
    saved = _DTYPES.get(manifest.get("dtype"))
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
    elif kind == "ivf" and dtype == torch.int8:
        # float lists pasted into int8 storage would score garbage
        raise ValueError(
            f"snapshot at {path} stores float IVF lists; load with dtype=None "
            f"or a float dtype, not {dtype}"
        )
    _check_embedding(manifest.get("embedding"), embedding)
    store = TorchVectorStore(
        embedding=embedding,
        dim=manifest["dim"],
        metric=manifest["metric"],
        # capacity from a flat snapshot: default-capacity growth doubles
        # (an IVF or HNSW snapshot replaces the store's first index)
        capacity=max(int(manifest.get("size") or 0) if kind == "flat" else 0, 1024),
        dtype=dtype,
        device=device,
        # snapshots without the key were built at the historical kf_mult 4
        kf_mult=manifest.get("kf_mult") or 4,
        # a blob snapshot reattaches in place: the loaded store reads (and,
        # if mutated, appends) in the snapshot directory
        docstore_path=str(path / "docstore_blob") if blob_backed else None,
        index_type=manifest.get("index_type", "flat"),
        nlist=manifest.get("nlist", 100),
        nprobe=manifest.get("nprobe", 8),
        ivf_spill=manifest.get("ivf_spill", 1),
        ivf_spill_cap=manifest.get("ivf_spill_cap", 1.25),
        train_threshold=manifest.get("train_threshold"),
    )
    if kind == "ivf":
        store.index = _load_ivf(path, manifest, dtype, device)
    elif kind == "hnsw":
        store.index = HNSWIndex.load(
            path / "hnsw.bin", metric=manifest["metric"],
            ef_search=manifest.get("ef_search", 64),
        )
    elif kind == "flat":
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
    if not blob_backed:
        rows = json.loads((path / "docstore.json").read_text(encoding="utf-8"))
        docs = [Document(content=r["content"], metadata=r["metadata"], id=r["id"])
                for r in rows]
        store.docstore.add(docs, [r["position"] for r in rows])
    return store
