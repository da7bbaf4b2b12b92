#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines and times:

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build: compile the ten CUDA sources of ``rag_arc_tpu_torch/csrc`` for
     sm_90a, one ``nvcc`` each, in parallel (nvcc's register / shared-memory
     report is printed);
  3. kernels against their plain PyTorch versions on the card (N = 262,144,
     d = 768, g = 16, ~3% dead rows), then compared again and timed in
     turns at B = 512, N = 2M:
     - ``subtile_max``: bf16 B in {1, 7, 128, 512}, f32 B = 64;
     - its l2 mode: bf16 B in {7, 512}, f32 B = 64;
     - the bf16 kernel's edges: B = 130, N off a 128-row tile, g in
       {16, 128, 256}, d = 100 and a view off a 16-byte boundary (the
       wrapper's copies), whole dead sub-tiles; and ``torch.matmul(q, x.T)``
       at B = 512, N = 2M as a second yardstick (the GEMM alone);
     - ``subtile_max_i8`` (s8 ``wgmma``): block scales B in {1, 7, 128,
       512}, per-row scales B = 64, B = 130 with g = 256, d = 100 on an
       offset view, exactly equal; at N = 2M both scale modes timed in
       turns, beside ``torch._int_mm(q, codes.t())`` (the GEMM alone);
     - ``subtile_select``: the select kernel on a real (512, 125,000) slab
       of sub-tile maxima and on a constructed one (ties past the k-th
       slot, -0.0 beside +0.0, all-NEG, half-NEG and nearly dead rows) at
       k in {10, 20, 100}: live picks, flags and residuals equal to the
       plain tournament's; timed in turns against it and beside
       ``torch.topk`` at each k; then the other shapes the paths send it
       (dense B = 256 and 160 at k 10 / 100, an int8 search's B 1 / 8 / 32
       at kf = 20, an IVF dispatch's and a BM25 batch's group maxima),
       held and timed the same way;
     - ``rope_prep`` at the reranker shape (B = 64, L = 512, nh/nkv 16/8,
       D = 128, bf16, left-padded positions, norm folded in), ragged,
       nh = nkv, D = 64 and f32 cases, with and without ``repeat_kv``;
       timed in turns at the reranker shape, both ways;
     - ``flash_attention`` at B = 64, L = 512, H = 16 (KV heads 16 and 8),
       D = 128 bf16 with random left-pad lengths, every row compared (pads
       included), and L in {64, 130, 200, 300}, D = 64, KV heads shared by
       2 or 3 query heads, f32, and ``out=`` a (B, L, H, D) buffer; timed
       in turns at the reranker shape (16/8 heads) beside SDPA;
     - ``add_rms_norm`` (the residual add + RMSNorm, Triton) at each served
       reranker's shape (T 15,360 x H 1,024 and T 14,336 x H 2,048, bf16):
       ``x_new`` bit-equal to torch's add, ``y`` to the plain chain on
       99.9% of elements and one bf16 step elsewhere; device time in turns
       against the plain chain, beside its byte bound and ``F.rms_norm``
       after an add;
     - ``subtile_max_piped`` (the warpgroup ping-pong): bf16 B in {1, 7,
       512}, f32 B = 64, int8 B in {7, 512}; its edges (B = 130, g = 64
       and 128/256 served from g = 64, d = 100 on offset views, dead
       sub-tiles); at N = 2M timed in turns against its plain version and
       against ``subtile_max.cu`` / ``subtile_max_i8.cu`` (int8 equal);
     - ``fused_mips_topk`` (``wgmma`` with a threshold filter): cosine,
       ip and l2 at B in {1, 7, 130, 256, 257, 512}, k in {1, 10, 100,
       128}, every skip/packed pair, ids equal up to ties at the k-th
       score; integer data bit for bit (d = 100 on an offset view, fewer
       live rows than k); at the probe's 2,002,944 rows timed in turns
       against its plain version and beside the GEMM alone and the GEMM
       plus ``torch.topk`` (yardsticks);
     - ``corpus_stream`` exactly, timed beside ``torch.amax``;
     then the kernel probe (``tools/kernel_probe.py``) at 2,000,000 x 768,
     B = 512: every config runs, recall@10 >= 0.99, the piped and scan
     producers' ids held to the stream producer's up to k-th-score ties;
  4. index: a 2,000,000 x 768 corpus, its queries and their f32 exact
     top-10 oracle, shared by three indexes, each searched in batches of
     512 queries (k = 10) with ids checked against the all-plain
     pipeline's (the producer's and the select's plain versions), the
     producer and select kernels' launches counted, and one batch split
     into producer, select and rescore (with the select at kf in {10, 20,
     100}):
     - bf16 cosine, 30 batches, the sustained run three times after an
       untimed warm-up pass: QPS and its spread, p50 batch time,
       recall@10;
     - then the bf16 passes read back one batch at a time and through one
       ``transfer_pool()`` flush a pass, in turns;
     - bm25 hybrid: a 2,000,000-document zipf CSR corpus (vocab 50,000,
       mean length 60, ``tools/bm25_synth.py``), the hybrid backend (f32
       head) beside the host C++ scorer built from the same CSR; the head,
       selective and mixed query profiles (B = 32, 4 batches streamed, 5
       passes) and selective again with ``host_budget=0`` (the tail-only
       program): ms per batch, QPS, routing, select launches, top-10
       agreement 1.0 with the host scorer and scores within 1e-4; one
       coalesced head batch split into head matmul, slab gather +
       scatter-add, group max, select kernel and ``select_topk``, whose
       kernel path is held against the plain tournament on the card; the
       doc-major backend at 262,144 documents against the host scorer;
     - multipath: the bf16 index and the 2M BM25 index over one position
       space, k_path 50, RRF k 60, B = 32, 4 batches of selective
       queries, each pass one ``transfer_pool()`` stream (one flush),
       fused ids equal to ``RRFusion``'s, one producer launch a dense
       batch;
     - crossover: the bf16 cosine search's direct path (``masked_topk``)
       against its two-level path (``two_level_topk``, the index's path on
       the card past 131,072 rows) at B in {1, 8, 32, 128} over 2,682,880
       (the NQ index), 2,000,000, 262,144, 131,072 and 65,536 rows, k =
       100, in turns: ms as issued and device ms with the host ahead, the
       bytes bound, positions equal but among equal scores; each corpus's
       B = 1 search split into producer, select and rescore;
     - bf16 l2 over the first 2^20 rows, 5 batches, recall@10 against an
       f32 l2 oracle;
     - int8 cosine with the default int4 residual refine and kf_mult 2, 30
       batches: QPS, p50, recall@10, bytes on the card, host quantization
       time, and one B = 1 search whose peak memory must stay under the
       index's resident bytes + 1 GiB (no f32 copy of the corpus);
     - ivf: ``tools/ivf_oracle.py``'s clustered corpus (1,000,000 x 768,
       256 centres, noise 0.3) and 1,024 queries, the exact f32 top-10 on
       the card and the FAISS-defaults numpy oracle's recall curve; four
       ``DeviceIVFIndex`` builds at nlist 100 (f32, bf16, bf16 spill 2,
       int8), each timed by stage (k-means, assignment, packing, upload)
       and searched at nprobe 1-32: recall@10 beside the oracle's, every
       search's ids held to the all-plain pipeline's (``ivf_scan_plain``
       + the select's tournament) up to k-th-score ties, one scan and one
       select launch a dispatch, spill 2's rows k distinct positions, f32
       recall >= 0.99 at nprobe 16 and 32; search ms and QPS at B 1 / 8 /
       32 and nprobe 8 / 16 / 32 beside the bf16 flat index at the same B;
       the exhaustive probe against the flat index up to ties;
       ``ivf_scan`` against its plain version (f32 / bf16 cosine and ip,
       int8, l2 on 2^18 f32 rows; B 1 / 7 / 33, nprobe 1 / 8 / 100; dead
       slots; d = 100 on offset views) and timed in turns at B = 32,
       nprobe 8 with its bound, then alone at B 1 / 8 / 32 / 256 x nprobe
       8 / 32 beside its bound; the kernels ``torch.profiler`` sees in one
       ``search_sub`` at B = 1 and 32, and its time, in a process of its
       own (``tools/kernel_ab.py --search``); an IVF store snapshot round
       trip;
     - hnsw: ``tools/hnsw_bench.py``'s corpus cut to 6,144 x 768 (the host
       engine's add is single-threaded), f32, SQ8 and PQ + refine
       built concurrently: build s, batch and single-query QPS, recall@10
       against the exact top-10, a snapshot round trip each;
     - graph (every kernel count set to 0 just before, read just after:
       ``launches_graph``): ``tools/graph_merge_bench.py --hard``'s corpus
       (the port's ``rag_arc_tpu_torch/tools/graph_merge_bench.py``, the
       JAX tool's draws) at 100,000 x 768 in an f32 ``ArrayGraphStore`` on
       the card (capacity 131,072): upserts and edges, embed + index, the
       merge's wall time split into the self-search (one 4,096-query chunk
       on CUDA events), the host pair loop and union-find + the edge
       rebuild; its pairs held to the all-plain pipeline's (plain producer
       + ``plain_select()``) outside ties within 1e-5 of the threshold or a
       row's k-th score; no dangling edges, no entity self-loops, every
       boundary negative kept, ``subtile_max`` (f32) and the select
       launched on every full chunk; the default corpus at 100,000 x 768
       with planted recall 1.0, then its rows as 100,000 events through
       ``disambiguate_events`` (cutoff 0.85), held and counted the same
       way; the f32 producer and the select at the
       chunk's shape (B 4,096, N 131,072, C 8,192, k 11) in turns with
       their bounds; then a GraphRAG flow: ``HyperRAGGraphExtractor`` over
       a scripted ``FakeLLM`` on 320 generated chunks,
       ``store_hyperrag_graph`` with the 768 x 12 ``TorchEncoderEmbeddings``
       on the card (merge, event KNN), entity-linked queries whose chunks
       all mention the entity, a snapshot round trip;
     - encoders (counts set to 0 and read the same way): ``BertModel`` at
       bert-base widths, seeded, f32 B = 64 L = 128 on the card against
       the same weights on the CPU within 1e-4 (TF32 off), timed;
       ``TextEncoderFast`` against ``TextEncoder`` on the same 768 x 12
       weights, bf16 (row error <= 1e-2 relative) and f32 (1e-5), both
       timed;
  5. end to end (the select kernel's launches counted as well):
     ``TorchEncoderEmbeddings`` at the full 768 x 12 config
     (seeded random weights) feeding ``TorchVectorStore.from_texts``:
     - bf16 with 262,144 generated documents; 4 batches of 512 verbatim
       document texts through ``batch_similarity_search_with_score`` and 8
       single queries through ``as_retriever().invoke``;
     - int8 with the first 16,384 of them; one batch of 512 verbatim texts
       and 4 single queries; then the store saved as a snapshot and loaded
       into a fresh store, with arrays and results compared bit for bit;
     - hybrid retriever: ``MultiPathRetriever(shared_id_space=True)`` over
       the bf16 store's retriever and ``BM25Retriever.from_documents`` of
       its documents; 512 document texts through ``dispatch_batch`` (one
       pool flush) and 8 through ``invoke``: the verbatim source in the
       fused top 10 for >= 0.99 of them, per-stage times;
  6. rerank model: ``Qwen3LM`` at Qwen3-0.6B widths (28 x 1024, 16/8 heads
     of 128, vocab 151,936), bf16, seeded N(0, 0.02) weights; ``last_logits``
     on B = 64 x L = 512 random ids timed (pairs/s, ms per 50-candidate
     query, MFU against 989 TFLOP/s), the attention calls checked (K/V
     unrepeated, attention written in place), 28 launches of each attention
     kernel and 57 of ``add_rms_norm`` a forward, one layer's stage times, the
     kernel path held against the einsum path on the same weights, and an
     f32 check at full width and 2 layers;
  7. retrieve -> rerank: the top 50 of the bf16 e2e store for 8 query texts
     through ``CrossEncoderReranker.from_causal_lm(qwen3, ...)
     .rerank_batch(k=10)``, checked (candidates, sorted, scores in [0, 1],
     order against the einsum path) and counted (both kernels launch once
     per layer); then one ``rerank_batch`` through the default
     ``CrossEncoderReranker()`` (768 x 12 causal);
  8. serving and ingest, every kernel count set to 0 just before and read
     just after (the ``launches_serving`` of the kernels line):
     - serve_ingest: 4,096 generated files (txt, md, docx, xlsx, pptx, and
       html where bs4 is installed; ``tools/doc_synth.py``) through
       ``tools/ingest.py``'s ``main()`` with the 768 x 12 encoder on the
       card, the BM25 twin and bf16, once with the JSON docstore and once
       with ``--blob-docstore``; every file parsed; each snapshot served
       through the app's ``--store`` path (``make_server``, port 0): every
       endpoint answers 200, 512 chunk texts find their own chunk in the
       top 10 (>= 0.99), ``/batch`` ids equal ``query_batch``'s,
       ``response=ids`` carries the ``full`` ids, ``/add`` then ``/delete``
       changes the answers, and the blob snapshot answers as the JSON one;
       an IVF snapshot's dispatches (counted by the phase) equal its
       ``ivf_scan`` and select launches;
     - serve_2m: ``tools/serving_bench.py``'s configuration (2M x 768 bf16,
       the index phase's rows, documents in a ``BlobDocstore``, queries
       encoded on the card and chained into the search,
       ``RagPipeline(batch_max=512, batch_wait_ms=3)``), 32 clients x 10
       requests (the tool sends 40) x 64 queries on keep-alive
       connections, three ``response=ids`` passes and one ``full``: QPS,
       request p50/p95, the coalesced batch sizes, single-query latency
       (60 solo requests, the first 10 dropped), one coalesced B=512
       batch's device split; served ids equal the direct search's, the
       producer and select kernels launched by the served traffic, MMR
       ids equal ``mmr_select`` over the store's own top 20;
     - serve_ingest also ingests the files dense-only as IVF (bf16, nlist
       ~ sqrt(chunks), trained on every chunk) and as HNSW (SQ8) and serves
       each snapshot through ``--store`` with the same checks;
     - serve_rerank: serve_2m's retriever with the Qwen3 cross-encoder
       (recall 50, top 10) behind the app, 4 requests of 8 queries: each
       answer a sorted subset of the retrieved 50 in ``rerank_batch``'s
       order, ``rope_prep`` and ``flash_attention`` exactly 28 launches and
       ``add_rms_norm`` 57 for each forward the phase counts;
     - serve_config: a ``PipelineConfig`` document (MULTIPATH over
       ``TORCH_EMBEDDINGS`` 768 x 12 and BM25, REWRITE with FAKE_LLM)
       through ``Register``, 64 queries over HTTP; then a DENSE config with
       ``index_type: "ivf"`` (nlist 64) over the same 4,096 documents,
       one scan and one select launch for each dispatch;
  9. lfm2: LFM2-8B-A1B at its published widths (24 layers: 18 short conv,
     6 attention 32/8 of 64; 22 MoE of 32 experts, top 4), bf16, seeded
     weights. At the ``nq_lfm2moe.chat`` cell's shapes (28 packed rows of
     512, ~98% live) ``short_conv``, the SwiGLU pass and ``moe_experts``
     (``torch._grouped_mm`` over the experts' rows) are held against their
     plain versions and timed in turns beside their bounds; then 4 single
     queries through ``RagPipeline`` (recall 100 of 4,096 passages, top 10)
     behind the app on the packed path: every forward packed, and
     ``short_conv`` 18, the SwiGLU pass 22, ``rope_prep`` and
     ``flash_attention`` 6 and ``add_rms_norm`` 49 launches a forward,
     counted from 0 before each request;
 10. granite: granite-4.0-h-small at its published widths with experts
     0-35 of 72 held (40 layers: 36 Mamba-2, 4 NoPE attention 32/8 of 128;
     every layer's sparse block top 10 beside a shared expert), bf16,
     seeded weights. At the same 28 packed rows ``mamba_conv``,
     ``ssd_scan``, ``gated_rms_norm`` and the held experts' FFN are held
     against their plain versions and timed in turns beside their bounds,
     and the scan and a bf16-state control against the f32 token
     recurrence; then 4 single queries served as in lfm2: every forward
     packed, and ``mamba_conv``, ``ssd_scan`` and ``gated_rms_norm`` 36,
     ``add_rms_norm`` 81, the SwiGLU pass 40 and ``flash_attention`` 4
     launches a forward.

With ``--parent DIR`` (a tree of an earlier commit, e.g. unpacked by
``git archive``), the select and ivf phases also time that tree's
``subtile_select.cu`` and ``ivf_scan.cu`` in turns beside these
(``tools/kernel_ab.py``; each pair held to agree), the bf16 index phase
its B=512 search and sustained QPS with that tree's select in this one's
place, and the ivf phase its ``search_sub`` (kernels and ms) in turns
with this tree's, each in a process of its own.

Every check that fails ends the run with a non-zero exit; a serving phase
fails on any response other than 200 and on any client error. Without a
CUDA card it exits non-zero at once. The second-to-last line is a JSON object
describing each kernel and the crossover's rows; the last line is the run's
JSON status.
"""

from __future__ import annotations

import contextlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

# the card's peak rates, the bound and CUDA-event timing: one copy, the
# kernel A/B tool's
from rag_arc_tpu_torch.tools.kernel_ab import (H100_BF16_PEAK, H100_F32_PEAK, H100_INT8_PEAK,
                                               ab_turns, bound, cuda_ms, queued_ms)

SEED = 0
K = 10
G = 16
DIM = 768
KERNEL_N = 262_144
KERNEL_CASES = [("bf16", 1), ("bf16", 7), ("bf16", 128), ("bf16", 512), ("f32", 64)]
L2_CASES = [("bf16", 7), ("bf16", 512), ("f32", 64)]
# the wgmma kernel's edges: (B, N, d, g, storage offset, l2); a ragged
# 256-query block (B = 130), N off a 128-row tile, g up to 256 (served
# from g = 128), d = 100 (the wrapper's zero-padding copy) and a view off
# a 16-byte boundary (its aligning copy); 256 rows dead in each case
EDGE_CASES = [(130, 262_096, 768, 16, 0, False), (130, 262_096, 768, 16, 0, True),
              (512, 262_144, 768, 128, 0, False), (64, 262_144, 768, 256, 0, True),
              (7, 65_536, 100, 16, 0, False), (33, 65_536, 768, 16, 3, False)]
I8_CASES = [(True, 1), (True, 7), (True, 128), (True, 512), (False, 64)]  # (block scales, B)
# the s8 kernel's edges: (block scales, B, N, d, g, storage offset); a
# ragged 256-query block, g = 256 (served from g = 128), d = 100 (the
# wrapper's zero-padding copy to 112) on a view off a 16-byte boundary
I8_EDGES = [(True, 130, 262_144, 768, 256, 0), (False, 130, 262_144, 768, 128, 0),
            (True, 33, 65_536, 100, 16, 3), (False, 7, 65_536, 100, 32, 5)]
SELECT_KS = (10, 20, 100)  # select timings and checks; int8 searches at kf = 20
# the select's other dense batches: 256, as the text path pads a coalesced
# serving batch of 129-256 queries; 160, a batch of vectors searched as it
# comes (DeviceFlatIndex.search pads nothing)
SELECT_MORE_B = (256, 160)
SELECT_MORE_KS = (10, 100)
TIMING_N = 2_000_000
CORPUS_N = 2_000_000
BATCH = 512
N_BATCHES = 30
# the bf16 search's two paths in turns: the NQ index's rows (the served
# cells), the index phase's, and smaller corpora on both sides of the
# index's direct-path limit (flat.py's CARD_DIRECT_ROWS, 131,072), where
# the two-level path's launches decide
CROSS_NS = (2_682_880, 2_000_000, 262_144, 131_072, 65_536)
CROSS_BS = (1, 8, 32, 128)
CROSS_K = 100  # the served cells' recall depth
CROSS_TIE = 1e-6  # f32 sums of 768 exact bf16 products in another order
L2_N = 1 << 20
L2_BATCHES = 5
ORACLE_QUERIES = 128
N_DOCS = 262_144
I8_DOCS = 16_384
DOC_VOCAB = 30_000
STORE_CAPACITY = 2_097_152
E2E_BATCHES = 4
N_SINGLE = 8
I8_SINGLE = 4
TOL = 1e-4  # bf16 products are exact in f32: only the summation order differs
# the reranker: Qwen3-0.6B widths at bench.py::bench_rerank's B and L
RERANK_B = 64
RERANK_L = 512
RERANK_REPS = 5
# sparse and hybrid retrieval: bench.py::bench_bm25_hybrid's corpus recipe
# at 2M (its 10M waits for a benchmark), bench_multipath_e2e's fan-out
BM25_N = 2_000_000
BM25_VOCAB = 50_000
BM25_MEAN_LEN = 60
BM25_B = 32
BM25_BATCHES = 4
BM25_PASSES = 5
BM25_DEVICE_N = 262_144  # the doc-major backend's parity corpus
MULTI_K_PATH = 50
RRF_K = 60
HYBRID_QUERIES = 512
# the kernel probe's kernels: the pipelined producer, the fused top-k
# (tile_n 2048 as the probe's fused config) and the corpus stream
PIPED_CASES = [("bf16", 1), ("bf16", 7), ("bf16", 512), ("f32", 64), ("int8", 7),
               ("int8", 512)]
# the ping-pong kernel's edges: (dtype, B, N, d, g, storage offset); a
# ragged query block, g = 64 and g = 128/256 (served from g = 64), d = 100
# (the wrapper's zero-padding copy) on views off a 16-byte boundary; 256
# rows dead in each case
PIPED_EDGES = [("bf16", 130, 262_144, 768, 64, 0), ("bf16", 512, 262_144, 768, 256, 0),
               ("bf16", 33, 65_536, 100, 16, 3), ("int8", 130, 262_144, 768, 128, 0),
               ("int8", 33, 65_536, 100, 32, 5)]
# (B, skip_tiles, packed, k, metric): the probe's shapes first, then the
# wgmma kernel's batch and k edges (B off a 128-query block, k = 1, 100 and
# 128, where the lists take the 64-query layout)
FUSED_CASES = [(1, False, False, K, "cosine"), (7, True, True, K, "cosine"),
               (130, True, False, K, "cosine"), (512, False, True, K, "cosine"),
               (512, True, True, K, "cosine"), (256, True, True, 100, "ip"),
               (257, False, False, 128, "l2"), (512, True, True, 1, "cosine"),
               (7, False, True, 128, "ip")]
# integer data, bit for bit: (B, N, d, storage offset, live rows, metric)
FUSED_EXACT = [(512, 262_144, 768, 0, None, "ip"), (33, 65_536, 100, 3, None, "l2"),
               (9, 262_144, 768, 0, 3, "ip")]
FUSED_TILE = 2048
PROBE_N = 2_000_000
PROBE_STREAM = 8
PROBE_REPS = 3
PROBE_CONFIGS = [  # the probe's default sweep comes first
    {"kind": "stream", "tile_n": 2048, "g": 16, "producer": "stream"},
    {"kind": "stream", "tile_n": 2048, "g": 16, "producer": "stream_piped"},
    {"kind": "stream", "tile_n": 2048, "g": 16, "producer": "scan"},
    {"kind": "fused", "tile_n": 2048, "skip_tiles": True, "packed": True},
    {"kind": "fused", "tile_n": 2048, "skip_tiles": False, "packed": False},
    {"kind": "dma_only", "tile_n": 2048},
    {"kind": "dma_only", "tile_n": 2048, "dtype": "int8"},
    {"kind": "p1_stream", "tile_n": 2048, "g": 16},
    {"kind": "p1_stream", "tile_n": 2048, "g": 16, "pipelined": True},
]
ROPE_CASES = [  # (B, L, nh, nkv, D, dtype, repeat_kv)
    (RERANK_B, RERANK_L, 16, 8, 128, "bf16", True),
    (RERANK_B, RERANK_L, 16, 8, 128, "bf16", False),
    (3, 77, 16, 8, 128, "bf16", True), (3, 77, 16, 8, 128, "bf16", False),
    (4, 128, 8, 8, 128, "bf16", True), (4, 96, 8, 4, 64, "bf16", False),
    (4, 100, 16, 8, 128, "f32", True), (4, 100, 16, 8, 128, "f32", False),
]
FLASH_CASES = [  # (B, H, HKV, L, D, dtype), random left-pad lengths
    (RERANK_B, 16, 16, RERANK_L, 128, "bf16"), (RERANK_B, 16, 8, RERANK_L, 128, "bf16"),
    (8, 16, 16, 64, 128, "bf16"), (8, 16, 16, 200, 128, "bf16"), (4, 8, 8, 300, 64, "bf16"),
    (4, 8, 4, 300, 64, "bf16"), (6, 12, 4, 130, 128, "bf16"), (2, 4, 4, 160, 128, "f32"),
    (2, 4, 2, 160, 128, "f32"), (2, 4, 4, 96, 64, "f32"),
]
# (atol, rtol). rope_prep runs the plain version's f32 arithmetic up to FMA
# contraction and rounds once: one bf16 ulp (2^-7 relative at most), f32
# rounding noise. flash_attention rounds exp(s - running max) to bf16 for
# P·V where the plain version rounds exp(s - final max): two bf16 ulps at
# |out| < 4 plus 1%; at f32 only the summation order differs.
ROPE_TOL = {"bf16": (1e-2, 8e-3), "f32": (1e-5, 1e-6)}
FLASH_TOL = {"bf16": (3e-2, 1e-2), "f32": (1e-5, 1e-5)}
# kernel path against the einsum path on the same weights: the two round
# bf16 at different points (models/qwen3.py), 28 layers deep
LOGIT_BOUND = 0.1
P_BOUND = 0.05
F32_B, F32_L, F32_BOUND = 4, 256, 1e-4  # f32, full width, 2 layers
RERANK_QUERIES = 8
RERANK_CANDIDATES = 50
# serving and ingest: the two-command flow (tools/ingest.py, then the app's
# --store) on a generated multi-format corpus, and tools/serving_bench.py's
# configuration (2M x 768 bf16 in the blob docstore, the 768 x 12 encoder
# on the card, batch_max 512, 32 clients x 64-query requests, k 10)
INGEST_FILES = 4096
INGEST_QUERIES = 512
SERVE_BATCH_MAX = 512
SERVE_WAIT_MS = 3.0
SERVE_CLIENTS = 32
SERVE_REQUESTS = 10  # tools/serving_bench.py sends 40: cut to keep the run short
SERVE_QPR = 64
SERVE_IDS_PASSES = 3
SERVE_SOLO = 60
SERVE_SOLO_DROP = 10
SERVE_MMR_QUERIES = 4
SERVE_RERANK_REQUESTS = 4
# the lfm2 phase: the nq_lfm2moe.chat cell's shapes (one query's 100 pairs
# of ~143 tokens packed into 28 rows of 512) and a small served corpus
LFM2_ROWS = 28
LFM2_ROW_LEN = 512
LFM2_PAIR_TOKENS = (60, 230)
LFM2_DOCS = 4096
LFM2_PASSAGE_WORDS = 70
LFM2_RECALL = 100
LFM2_REQUESTS = 4
# the add + RMSNorm kernel at each served reranker's shape: one query's 100
# NQ pairs packed into 30 (Qwen3) and 28 (LFM2) rows of 512 tokens
# granite-4.0-h-small, experts 0-35 of 72 held (the cell's share): its
# kernels at the LFM2 phase's packed rows, then served as the LFM2 model is
GRANITE_HELD = (0, 36)
# the scan's state readout against the f32 token recurrence, the worst
# head's relative L2 error (tests/test_torch_granite_hybrid.py's limit)
SSD_STATE_TOL = 0.0035
RMS_NORM_SHAPES = ((30 * 512, 1024, "Qwen3-Reranker-0.6B, 30 rows of 512"),
                   (28 * 512, 2048, "LFM2-8B-A1B, 28 rows of 512"))
SERVE_RERANK_QPR = 8
SERVE_CONFIG_DOCS = 4096
SERVE_CONFIG_QUERIES = 64
SERVE_CONFIG_NLIST = 64  # the IVF config's lists over its 4,096 documents
# the ivf phase: tools/ivf_oracle.py's clustered corpus at the JAX
# package's r5 operating point (nlist 100, the FAISS reference default)
IVF_N = 1_000_000
IVF_NLIST = 100
IVF_QUERIES = 1024
IVF_NPROBES = (1, 2, 4, 8, 16, 32)
IVF_BUILDS = (("f32", 1), ("bf16", 1), ("bf16", 2), ("int8", 1))
IVF_TIMED_B = (1, 8, 32)
IVF_TIMED_NPROBES = (8, 16, 32)
IVF_SCAN_B = (1, 8, 32, 256)  # ivf_scan alone, each with its bound
IVF_SCAN_NPROBES = (8, 32)
IVF_REPS = 5
IVF_PLAIN_B = 64  # queries a dispatch of the all-plain pipeline
IVF_L2_N = 1 << 18  # the l2 build's rows
IVF_SNAP_N = 1 << 17  # the snapshot round trip's rows
IVF_TOL = 1e-5  # f32 sums of 768 exact products in another order; |scores| <= ~2
IVF_FLAT_TIE = 1e-3  # the flat index's bf16 query normalization moves scores ~1e-4
IVF_RECALL_MIN = 0.99
# the hnsw phase: tools/hnsw_bench.py's corpus and settings
HNSW_N = 6_144  # tools/hnsw_bench.py builds 100,000: cut so the f32 build stays under 60 s
HNSW_QUERIES = 512
HNSW_EF = 64
HNSW_SINGLE = 64

GRAPH_N = 100_000  # tools/graph_merge_bench.py's published merge scale, x 768
GRAPH_TOP_K = 10  # the store's knn_top_k: each self-search asks top_k + 1
GRAPH_THRESHOLD = 0.95  # the store's merge threshold
GRAPH_TIE = 1e-5  # f32 sums of 768 products in another order: pairs this close to a boundary
GRAPH_CHUNKS = 320  # generated chunks through the HyperRAG extractor
GRAPH_QUERIES = 8  # entity-linked chunk queries
BERT_B, BERT_L = 64, 128
BERT_TOL = 1e-4  # f32, TF32 off: the card's sums against the CPU's
FAST_B, FAST_L = 64, 128
FAST_TOL = {"f32": 1e-5, "bf16": 1e-2}  # abs at f32; relative row error at bf16

CARD = ""
ROOT = Path(__file__).resolve().parent
PARENT: Path | None = None  # --parent: another tree whose scan and select are timed in turns


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def report(msg: str) -> None:
    """A measured line, tagged with the card it was measured on."""
    print(f"  {msg}  [{CARD}]", flush=True)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def in_turns(kernel, plain, name: str, ops: float, unit: str, nbytes: float,
             bytes_label: str = "of corpus") -> dict:
    """Time kernel and plain version in turns (plain, kernel, kernel,
    plain) and report both, with the kernel's rates: ``ops`` per call in
    ``unit`` (ops / 1e12 per second) and ``nbytes`` per call in GB/s."""
    p1 = cuda_ms(plain, 3)
    k1 = cuda_ms(kernel, 10)
    k2 = cuda_ms(kernel, 10)
    p2 = cuda_ms(plain, 3)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    report(f"{name}: kernel {k1:.3f} / {k2:.3f} ms, plain {p1:.3f} / {p2:.3f} ms "
           f"(CUDA events; in turns plain, kernel, kernel, plain); kernel "
           f"{ops / kernel_ms / 1e9:.1f} {unit}, {nbytes / kernel_ms / 1e6:.1f} GB/s "
           f"{bytes_label}")
    return {"ms": kernel_ms, "plain_ms": plain_ms}


def library_ms(fn, name: str) -> float:
    """Mean ms of one PyTorch call that computes a kernel's function (a
    yardstick the port never calls): one call outside the window, then 10."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = cuda_ms(fn, 10)
    report(f"{name}: library call {ms:.3f} ms (CUDA events, mean of 10)")
    return ms


def unit_rows(gen, n: int, d: int, dtype, device):
    import torch

    x = torch.rand((n, d), generator=gen, device=device) - 0.5
    return (x / torch.linalg.norm(x, dim=1, keepdim=True)).to(dtype)


def phase_environment(torch) -> None:
    global CARD
    phase("environment")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    CARD = smi[0].strip()
    print(CARD, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
          f"count {torch.cuda.device_count()}; TF32 off", flush=True)


def phase_build(modules) -> None:
    phase("build (one nvcc per source, in parallel)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modules)) as pool:
        builds = list(pool.map(lambda m: m.load(), modules))
    report(f"{len(builds)} kernel libraries ready in {time.perf_counter() - t0:.2f} s")
    for built in builds:
        report(f"built {built.path.name} for sm_90a in {built.seconds:.2f} s "
               f"(0 = reused an earlier build)")
        for line in built.ptxas.splitlines():
            if "registers" in line or "Compiling entry" in line or "spill" in line:
                print("  ptxas:", line.strip().removeprefix("ptxas info    : "), flush=True)


def phase_kernel(torch, sm, dev) -> tuple[dict, dict]:
    """The bf16/f32 kernel and its l2 mode against their plain versions."""
    phase("kernel against its plain version: subtile_max, and its l2 mode")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for dt_name, b in KERNEL_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        x = unit_rows(gen, KERNEL_N, DIM, dtype, dev)
        valid = torch.rand(KERNEL_N, generator=gen, device=dev) > 0.03
        x[~valid] = 0
        q = unit_rows(gen, b, DIM, dtype, dev)
        got = sm.subtile_max(q, x, valid, G)
        torch.cuda.synchronize()
        want = sm.subtile_max_plain(q, x, valid, G)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        report(f"{dt_name} B={b} N={KERNEL_N} d={DIM} g={G}: max|kernel - plain| = "
               f"{err:.3e} (atol {TOL:g}), dead rows {int((~valid).sum())}")
        check(got.shape == (b, KERNEL_N // G), f"kernel output shape {tuple(got.shape)}")
        check(err <= TOL, f"kernel disagrees with its plain version: {err} > {TOL}")

    l2_err = 0.0
    for dt_name, b in L2_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        x = unit_rows(gen, KERNEL_N, DIM, dtype, dev)
        valid = torch.rand(KERNEL_N, generator=gen, device=dev) > 0.03
        x[~valid] = 0
        sq = (x.float() * x.float()).sum(1)
        q = unit_rows(gen, b, DIM, dtype, dev)
        got = sm.subtile_max(q, x, valid, G, sqnorm=sq)
        torch.cuda.synchronize()
        err = float((got - sm.subtile_max_plain(q, x, valid, G, sqnorm=sq)).abs().max())
        l2_err = max(l2_err, err)
        report(f"l2 {dt_name} B={b} N={KERNEL_N} d={DIM} g={G}: max|kernel - plain| = "
               f"{err:.3e} (atol {TOL:g})")
        check(err <= TOL, f"l2 kernel disagrees with its plain version: {err} > {TOL}")
    del x, valid, q, sq, got

    for b, n, d, g, offset, l2 in EDGE_CASES:
        x = unit_rows(gen, n, d, torch.bfloat16, dev)
        valid = torch.rand(n, generator=gen, device=dev) > 0.03
        valid[4096 : 4096 + 256] = False  # whole sub-tiles dead, at every g
        x[~valid] = 0
        q = unit_rows(gen, b, d, torch.bfloat16, dev)
        sq = (x.float() * x.float()).sum(1) if l2 else None
        xv, qv = x, q
        if offset:  # contiguous views off a 16-byte boundary
            xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
            qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
        got = sm.subtile_max(qv, xv, valid, g, sqnorm=sq)
        torch.cuda.synchronize()
        want = sm.subtile_max_plain(q, x, valid, g, sqnorm=sq)
        err = float((got - want).abs().max())
        dead = bool((got[:, 4096 // g : (4096 + 256) // g] == sm.NEG).all())
        if l2:
            l2_err = max(l2_err, err)
        else:
            max_err = max(max_err, err)
        report(f"{'l2 ' if l2 else ''}bf16 B={b} N={n} d={d} g={g} storage offset {offset}: "
               f"max|kernel - plain| = {err:.3e} (atol {TOL:g}); dead sub-tiles NEG: {dead}")
        check(got.shape == (b, n // g) and err <= TOL and dead,
              f"kernel disagrees with its plain version at B={b} N={n} d={d} g={g}: {err}")
    del x, valid, q, sq, got, want, xv, qv

    x = unit_rows(gen, TIMING_N, DIM, torch.bfloat16, dev)
    valid = torch.rand(TIMING_N, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    n = TIMING_N - TIMING_N % G
    x, valid = x[:n].contiguous(), valid[:n].contiguous()
    q = unit_rows(gen, BATCH, DIM, torch.bfloat16, dev)
    flops = 2.0 * BATCH * n * DIM
    kernel = lambda: sm.subtile_max(q, x, valid, G)  # noqa: E731
    plain = lambda: sm.subtile_max_plain(q, x, valid, G)  # noqa: E731
    got, want = kernel(), plain()  # also warms both up
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    report(f"bf16 B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = {err:.3e} "
           f"(atol {TOL:g}), dead rows {int((~valid).sum())}")
    check(err <= TOL, f"kernel disagrees with its plain version at N={n}: {err} > {TOL}")
    del got, want
    ip = in_turns(kernel, plain, f"bf16 B={BATCH} N={n} d={DIM} g={G}", flops,
                  "TFLOP/s", n * DIM * 2)

    sq = (x.float() * x.float()).sum(1)
    kernel = lambda: sm.subtile_max(q, x, valid, G, sqnorm=sq)  # noqa: E731
    plain = lambda: sm.subtile_max_plain(q, x, valid, G, sqnorm=sq)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    l2_err = max(l2_err, err)
    report(f"l2 bf16 B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = {err:.3e} "
           f"(atol {TOL:g})")
    check(err <= TOL, f"l2 kernel disagrees with its plain version at N={n}: {err} > {TOL}")
    del got, want
    l2 = in_turns(kernel, plain, f"l2 bf16 B={BATCH} N={n} d={DIM} g={G}", flops,
                  "TFLOP/s", n * DIM * 2)
    del sq
    # what the library reaches on the same products: not one call computing
    # this function (it writes all B x N scores), so not library_ms
    gemm = lambda: torch.matmul(q, x.T)  # noqa: E731
    gemm()
    torch.cuda.synchronize()
    gemm_ms = cuda_ms(gemm, 10)
    report(f"GEMM alone, writes the scores: torch.matmul(q, x.T) bf16 B={BATCH} N={n} "
           f"d={DIM} {gemm_ms:.3f} ms (CUDA events, mean of 10), {flops / gemm_ms / 1e9:.1f} "
           f"TFLOP/s; the kernel {ip['ms']:.3f} ms")
    del x, valid, q
    torch.cuda.empty_cache()
    nbytes = n * DIM * 2 + n + BATCH * DIM * 2 + 4 * BATCH * (n // G)
    return ({"max_abs_err": max_err, **ip, **bound(flops, H100_BF16_PEAK, nbytes),
             "library_ms": None, "gemm_alone_ms": gemm_ms},
            {"max_abs_err": l2_err, **l2,
             **bound(flops, H100_BF16_PEAK, nbytes + 4 * n + 4 * BATCH), "library_ms": None})


def i8_inputs(torch, gen, n, b, block, dev):
    """Random int8 codes with positive scales (one per 32-row block, or
    one per row), ~3% dead rows zeroed, and random int8 query codes."""
    codes = torch.randint(-127, 128, (n, DIM), generator=gen, device=dev, dtype=torch.int8)
    if block:
        scale = torch.rand(n // 32, generator=gen, device=dev).repeat_interleave(32)
    else:
        scale = torch.rand(n, generator=gen, device=dev)
    scale = (scale + 0.1) * 1e-2
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    codes[~valid] = 0
    q = torch.randint(-127, 128, (b, DIM), generator=gen, device=dev, dtype=torch.int8)
    return q, codes, scale, valid


def int_mm_ms(torch, q, codes) -> tuple[float | None, str]:
    """The GEMM alone at the int8 kernel's shape, ``torch._int_mm(q,
    codes.t())`` (it writes all B x N int32 dots): mean ms of 10, or None
    and the reason when this torch build refuses the shape."""
    gemm = lambda: torch._int_mm(q, codes.t())  # noqa: E731
    try:
        gemm()
        torch.cuda.synchronize()
    except RuntimeError as exc:  # a yardstick the port never calls: reported, not fatal
        return None, f"refused: {str(exc).splitlines()[0]}"
    return cuda_ms(gemm, 10), "CUDA events, mean of 10"


def phase_kernel_i8(torch, smi8, dev) -> dict:
    phase("kernel against its plain version: subtile_max_i8 (s8 wgmma, exact)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    max_err = 0.0
    for block, b in I8_CASES:
        q, codes, scale, valid = i8_inputs(torch, gen, KERNEL_N, b, block, dev)
        got = smi8.subtile_max_i8(q, codes, scale, valid, G, block_scales=block)
        torch.cuda.synchronize()
        want = smi8.subtile_max_i8_plain(q, codes, scale, valid, G, block_scales=block)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        report(f"int8 {'block' if block else 'per-row'} scales B={b} N={KERNEL_N} d={DIM} "
               f"g={G}: max|kernel - plain| = {err:.3e} (must be 0), dead rows "
               f"{int((~valid).sum())}")
        check(got.shape == (b, KERNEL_N // G), f"int8 kernel output shape {tuple(got.shape)}")
        check(err == 0.0, f"int8 kernel differs from its plain version: {err}")
    del q, codes, scale, valid, got, want

    for block, b, n, d, g, offset in I8_EDGES:
        codes = torch.randint(-127, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)
        q = torch.randint(-127, 128, (b, d), generator=gen, device=dev, dtype=torch.int8)
        scale = (torch.rand(n, generator=gen, device=dev) + 0.1) * 1e-2
        if block:  # one scale per g-row sub-tile
            scale = scale[::g].repeat_interleave(g)
        valid = torch.rand(n, generator=gen, device=dev) > 0.03
        valid[4096 : 4096 + 256] = False  # whole sub-tiles dead, at every g
        codes[~valid] = 0
        cv, qv = codes, q
        if offset:  # contiguous views off a 16-byte boundary
            cv = torch.cat([codes.new_zeros(offset), codes.flatten()])[offset:].view(codes.shape)
            qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
        got = smi8.subtile_max_i8(qv, cv, scale, valid, g, block_scales=block)
        torch.cuda.synchronize()
        want = smi8.subtile_max_i8_plain(q, codes, scale, valid, g, block_scales=block)
        same = bool(torch.equal(got, want))
        dead = bool((got[:, 4096 // g : (4096 + 256) // g] == smi8.NEG).all())
        report(f"int8 {'block' if block else 'per-row'} scales B={b} N={n} d={d} g={g} "
               f"storage offset {offset}: bit-equal to plain: {same}; dead sub-tiles NEG: {dead}")
        check(same and dead, f"int8 kernel differs from its plain version at B={b} N={n} "
              f"d={d} g={g}")
    del q, codes, scale, valid, got, want, cv, qv

    n = TIMING_N - TIMING_N % G
    ops = 2.0 * BATCH * n * DIM
    q, codes, scale, valid = i8_inputs(torch, gen, n, BATCH, True, dev)
    block_k = kernel = lambda: smi8.subtile_max_i8(q, codes, scale, valid, G)  # noqa: E731
    plain = lambda: smi8.subtile_max_i8_plain(q, codes, scale, valid, G)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    report(f"int8 block scales B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = "
           f"{err:.3e} (must be 0)")
    check(err == 0.0, f"int8 kernel differs from its plain version at N={n}: {err}")
    del got, want
    timed = in_turns(kernel, plain, f"int8 block scales B={BATCH} N={n} d={DIM} g={G}",
                     ops, "TOP/s", n * DIM)

    row_scale = (torch.rand(n, generator=gen, device=dev) + 0.1) * 1e-2
    kernel = lambda: smi8.subtile_max_i8(q, codes, row_scale, valid, G, block_scales=False)  # noqa: E731
    plain = lambda: smi8.subtile_max_i8_plain(q, codes, row_scale, valid, G,  # noqa: E731
                                              block_scales=False)
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    report(f"int8 per-row scales B={BATCH} N={n} d={DIM} g={G}: max|kernel - plain| = "
           f"{err:.3e} (must be 0)")
    check(err == 0.0, f"int8 per-row kernel differs from its plain version at N={n}: {err}")
    del got, want
    per_row = in_turns(kernel, plain, f"int8 per-row scales B={BATCH} N={n} d={DIM} g={G}",
                       ops, "TOP/s", n * DIM)
    # the GEMM alone (it writes all B x N int32 dots: not this function,
    # so not library_ms), in turns with both modes of the kernel
    gemm_ms, how = int_mm_ms(torch, q, codes)
    b1, r1 = cuda_ms(block_k, 10), cuda_ms(kernel, 10)
    gemm2, _ = int_mm_ms(torch, q, codes)
    b2, r2 = cuda_ms(block_k, 10), cuda_ms(kernel, 10)
    if gemm_ms is not None:
        gemm_ms = (gemm_ms + gemm2) / 2
        how = f"{how}, twice in turns with the kernel; {ops / gemm_ms / 1e9:.1f} TOP/s"
    report(f"GEMM alone, writes the dots: torch._int_mm(q, codes.t()) int8 B={BATCH} N={n} "
           f"d={DIM}: {'not measured' if gemm_ms is None else f'{gemm_ms:.3f} ms'} ({how}); "
           f"in turns the kernel block {b1:.3f} / {b2:.3f} ms, per-row {r1:.3f} / {r2:.3f} ms")
    del q, codes, scale, row_scale, valid
    torch.cuda.empty_cache()
    nbytes = n * DIM + n + 4 * n + BATCH * DIM + 4 * BATCH * (n // G)
    return {"max_abs_err": max_err, **timed, **bound(ops, H100_INT8_PEAK, nbytes),
            "library_ms": None, "gemm_alone_ms": gemm_ms,
            "per_row_ms": per_row["ms"], "per_row_plain_ms": per_row["plain_ms"]}


def select_equal(torch, got, want, c: int) -> bool:
    """Live picks, flags and residuals equal; every pick in range and the
    picks of a row distinct (the kernel never re-picks)."""
    (gi, gl, gr), (wi, wl, wr) = got, want
    srt = torch.sort(gi, dim=1).values
    return (torch.equal(gl, wl) and torch.equal(torch.where(wl, gi, -1), torch.where(wl, wi, -1))
            and torch.equal(gr, wr) and int(gi.min()) >= 0 and int(gi.max()) < c
            and bool((srt[:, 1:] != srt[:, :-1]).all()))


def tie_slab(b: int, c: int, k: int, seed: int) -> np.ndarray:
    """(B, C) f32 sub-tile maxima, one pattern a row (row index mod 6):
    random with 3% dead entries; more ties at the k-th value than slots;
    -0.0 beside +0.0 around the k-th; all NEG; half NEG; three live."""
    rng = np.random.default_rng(seed)
    neg = np.float32(-3.0e38)
    x = rng.uniform(-0.2, 0.9, (b, c)).astype(np.float32)
    for r in range(b):
        kind = r % 6
        if kind == 0:
            x[r, rng.random(c) < 0.03] = neg
        elif kind == 1:
            x[r] = rng.uniform(-0.5, 0.4, c)
            x[r, rng.choice(c, min(c, 3 * k + 2), replace=False)] = 0.5
            x[r, rng.choice(c, k // 2, replace=False)] = 0.75
        elif kind == 2:
            x[r] = rng.uniform(-1.0, -0.1, c)
            zeros = rng.choice(c, min(c, 2 * k + 4), replace=False)
            x[r, zeros] = np.where(np.arange(len(zeros)) % 2, np.float32(-0.0), np.float32(0.0))
            x[r, rng.choice(c, k // 3, replace=False)] = 0.25
        elif kind == 3:
            x[r] = neg
        elif kind == 4:
            x[r, : c // 2] = neg
        else:
            x[r] = neg
            x[r, rng.choice(c, 3, replace=False)] = rng.uniform(0.1, 0.9, 3)
    return x


def phase_select(torch, sm, ss, dev) -> dict:
    """The select kernel against the plain tournament on a real slab (a
    B=512 batch's sub-tile maxima over 2M rows) and a constructed one,
    then timed in turns against it and beside torch.topk, and at the other
    shapes the paths send it."""
    from rag_arc_tpu_torch.tools import kernel_ab as ab

    n = TIMING_N - TIMING_N % G
    c = n // G
    phase(f"kernel against its plain version: subtile_select, B={BATCH} C={c}, "
          f"k in {SELECT_KS}")
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = unit_rows(gen, n, DIM, torch.bfloat16, dev)
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    pick = torch.randint(0, n, (BATCH,), generator=gen, device=dev)
    q = x[pick].float() + 0.1 * torch.randn((BATCH, DIM), generator=gen, device=dev)
    q = (q / torch.linalg.norm(q, dim=1, keepdim=True)).to(torch.bfloat16)
    real = sm.subtile_max(q, x, valid, G)
    del x, valid, q
    torch.cuda.empty_cache()
    ties = torch.from_numpy(tie_slab(BATCH, c, max(SELECT_KS), SEED)).to(dev)
    max_err = 0.0
    for name, slab in (("real", real), ("constructed", ties)):
        for k in SELECT_KS:
            got = ss.iterative_argmax_resid(slab, k)
            torch.cuda.synchronize()
            want = ss.iterative_argmax_resid_plain(slab, k)
            same = select_equal(torch, got, want, c)
            max_err = max(max_err, float((got[2] - want[2]).abs().max()))
            live = int(got[1].sum())
            report(f"select {name} slab B={BATCH} C={c} k={k}: live picks, flags and "
                   f"residuals equal to the plain tournament's: {same} ({live} of "
                   f"{BATCH * k} picks live)")
            check(same, f"subtile_select differs from its plain version ({name}, k={k})")
    del ties

    out, times = {}, []
    for k in SELECT_KS:
        kernel = lambda k=k: ss.iterative_argmax_resid(real, k)  # noqa: E731
        plain = lambda k=k: ss.iterative_argmax_resid_plain(real, k)  # noqa: E731
        lib = lambda k=k: torch.topk(real, k, dim=1)  # noqa: E731
        kernel(), plain()
        timed = in_turns(kernel, plain, f"select B={BATCH} C={c} k={k}", BATCH * c,
                         "T entries/s", BATCH * c * 4, "of sub-tile maxima")
        lib_ms = library_ms(lib, f"torch.topk(x, {k}, dim=1) f32 B={BATCH} C={c} (its own "
                            f"tie order)")
        nbytes = BATCH * c * 4 + BATCH * k * 9 + BATCH * 4
        times.append(f"k={k} kernel {timed['ms']:.3f} / plain {timed['plain_ms']:.3f} / "
                     f"topk {lib_ms:.3f} ms")
        out[k] = {**timed, **bound(BATCH * c, H100_F32_PEAK, nbytes), "library_ms": lib_ms}
    report(f"select, in turns on the real slab: " + "; ".join(times)
           + f"; bound {out[10]['bound_ms']:.3f} ms (k=10, bytes)")
    # the other shapes the paths send: dense batches of 256 and 160, and the
    # int8, IVF and BM25 paths' (the slab's front columns)
    shapes = [(f"dense B={b}", b, c, k) for b in SELECT_MORE_B for k in SELECT_MORE_KS]
    shapes += [(f"{what} B={b}", b, cc, k) for what, b, cc, k in ab.SELECT_PATHS]
    more = {}
    for what, b, cc, k in shapes:
        x = real[:b, :cc].contiguous()
        got = ss.iterative_argmax_resid(x, k)
        torch.cuda.synchronize()
        check(select_equal(torch, got, ss.iterative_argmax_resid_plain(x, k), cc),
              f"subtile_select differs from its plain version ({what}, C={cc}, k={k})")
        t = in_turns(lambda x=x, k=k: ss.iterative_argmax_resid(x, k),
                     lambda x=x, k=k: ss.iterative_argmax_resid_plain(x, k),
                     f"select {what} C={cc} k={k}", b * cc, "T entries/s", b * cc * 4,
                     "of sub-tile maxima")
        more[f"{what} C={cc} k={k}"] = {**t, **bound(b * cc, H100_F32_PEAK, b * cc * 4)}
    report("select at the paths' other shapes, equal to the plain tournament: " + "; ".join(
        f"{name} {t['ms']:.4f} ms (bound {t['bound_ms']:.4f}, bytes)" for name, t in more.items()))
    # what holds it: a row's time with one block an SM (B=132) against two
    # (B=264), and a slab whose rows keep few live entries (deep shrinks)
    waves = {bb: cuda_ms(lambda bb=bb: ss.iterative_argmax_resid(real[:bb], 10), 10)
             for bb in (132, 264)}
    sparse = torch.full_like(real, ss.NEG)
    sparse[:, ::1000] = real[:, ::1000]
    sparse_ms = cuda_ms(lambda: ss.iterative_argmax_resid(sparse, 10), 10)
    report(f"select k=10 (CUDA events, mean of 10): B=132 (one "
           f"block an SM) {waves[132]:.3f} ms, B=264 (two) {waves[264]:.3f} ms; B={BATCH} on a "
           f"slab live only every 1000th entry {sparse_ms:.3f} ms")
    del sparse
    if PARENT is not None:
        rows = ab.ab_select(ab.OtherKernels(PARENT), real, CARD)
        check(all(r["equal"] for r in rows), "the parent's select and this one's disagree")
    del real
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **out[10],
            "k20_ms": out[20]["ms"], "k100_ms": out[100]["ms"],
            "k20_plain_ms": out[20]["plain_ms"], "k100_plain_ms": out[100]["plain_ms"],
            "other_shapes_ms": {name: t["ms"] for name, t in more.items()}}


def phase_kernel_piped(torch, sm, smi8, smp, dev) -> dict:
    """The pipelined producer against its plain version, then in turns
    against the stream kernels it would replace."""
    phase("kernel against its plain version: subtile_max_piped (bf16/f32, int8 exact)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    max_err = 0.0
    for dt_name, b in PIPED_CASES:
        if dt_name == "int8":
            q, x, scale, valid = i8_inputs(torch, gen, KERNEL_N, b, True, dev)
        else:
            dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
            x = unit_rows(gen, KERNEL_N, DIM, dtype, dev)
            valid = torch.rand(KERNEL_N, generator=gen, device=dev) > 0.03
            x[~valid] = 0
            q, scale = unit_rows(gen, b, DIM, dtype, dev), None
        got = smp.subtile_max_piped(q, x, valid, G, scale=scale)
        torch.cuda.synchronize()
        want = smp.subtile_max_piped_plain(q, x, valid, G, scale=scale)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        bar = 0.0 if dt_name == "int8" else TOL
        report(f"piped {dt_name} B={b} N={KERNEL_N} d={DIM} g={G}: max|kernel - plain| = "
               f"{err:.3e} (bound {bar:g}), dead rows {int((~valid).sum())}")
        check(got.shape == (b, KERNEL_N // G), f"piped output shape {tuple(got.shape)}")
        check(err <= bar, f"subtile_max_piped disagrees with its plain version: {err}")
    del q, x, valid, got, want

    for dt_name, b, n, d, g, offset in PIPED_EDGES:
        valid = torch.rand(n, generator=gen, device=dev) > 0.03
        valid[4096 : 4096 + 256] = False  # whole sub-tiles dead, at every g
        if dt_name == "int8":
            x = torch.randint(-127, 128, (n, d), generator=gen, device=dev, dtype=torch.int8)
            q = torch.randint(-127, 128, (b, d), generator=gen, device=dev, dtype=torch.int8)
            scale = (torch.rand(n // g, generator=gen, device=dev) + 0.1).repeat_interleave(g)
        else:
            x = unit_rows(gen, n, d, torch.bfloat16, dev)
            q, scale = unit_rows(gen, b, d, torch.bfloat16, dev), None
        x[~valid] = 0
        xv, qv = x, q
        if offset:  # contiguous views off a 16-byte boundary
            xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
            qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
        got = smp.subtile_max_piped(qv, xv, valid, g, scale=scale)
        torch.cuda.synchronize()
        want = smp.subtile_max_piped_plain(q, x, valid, g, scale=scale)
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        bar = 0.0 if dt_name == "int8" else TOL
        dead = bool((got[:, 4096 // g : (4096 + 256) // g] == sm.NEG).all())
        report(f"piped {dt_name} B={b} N={n} d={d} g={g} storage offset {offset}: "
               f"max|kernel - plain| = {err:.3e} (bound {bar:g}); dead sub-tiles NEG: {dead}")
        check(got.shape == (b, n // g) and err <= bar and dead,
              f"subtile_max_piped disagrees with its plain version at B={b} d={d} g={g}")
    del q, x, valid, got, want, xv, qv

    n = TIMING_N - TIMING_N % G
    x = unit_rows(gen, n, DIM, torch.bfloat16, dev)
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    q = unit_rows(gen, BATCH, DIM, torch.bfloat16, dev)
    kernel = lambda: smp.subtile_max_piped(q, x, valid, G)  # noqa: E731
    plain = lambda: smp.subtile_max_piped_plain(q, x, valid, G)  # noqa: E731
    stream = lambda: sm.subtile_max(q, x, valid, G)  # noqa: E731
    got, want = kernel(), plain()
    err = float((got - want).abs().max())
    max_err = max(max_err, err)
    # the two kernels sum in another order (WMMA against wgmma): equal
    # within TOL, like each against the plain version
    gap = float((got - stream()).abs().max())
    report(f"piped bf16 B={BATCH} N={n}: max|kernel - plain| = {err:.3e} (atol {TOL:g}); "
           f"max|piped - subtile_max.cu| = {gap:.3e} (atol {TOL:g})")
    check(err <= TOL, f"subtile_max_piped disagrees with its plain version at N={n}: {err}")
    check(gap <= TOL, f"subtile_max_piped and subtile_max.cu disagree at N={n}: {gap}")
    del got, want
    flops = 2.0 * BATCH * n * DIM
    timed = in_turns(kernel, plain, f"piped bf16 B={BATCH} N={n} d={DIM} g={G}", flops,
                     "TFLOP/s", n * DIM * 2)
    s1, p1, p2, s2 = (cuda_ms(f, 10) for f in (stream, kernel, kernel, stream))
    report(f"piped against subtile_max.cu, bf16 B={BATCH} N={n}, in turns (stream, piped, "
           f"piped, stream): piped {p1:.3f} / {p2:.3f} ms ({2 * flops / (p1 + p2) / 1e9:.1f} "
           f"TFLOP/s), stream {s1:.3f} / {s2:.3f} ms ({2 * flops / (s1 + s2) / 1e9:.1f} "
           f"TFLOP/s)")
    nbytes = n * DIM * 2 + n + BATCH * DIM * 2 + 4 * BATCH * (n // G)
    out = {"max_abs_err": max_err, **timed, **bound(flops, H100_BF16_PEAK, nbytes),
           "library_ms": None, "stream_ms": (s1 + s2) / 2}
    del x, valid, q

    q, codes, scale, valid = i8_inputs(torch, gen, n, BATCH, True, dev)
    piped = lambda: smp.subtile_max_piped(q, codes, valid, G, scale=scale)  # noqa: E731
    stream = lambda: smi8.subtile_max_i8(q, codes, scale, valid, G)  # noqa: E731
    same = bool(torch.equal(piped(), stream()))
    s1, p1, p2, s2 = (cuda_ms(f, 10) for f in (stream, piped, piped, stream))
    report(f"piped int8 B={BATCH} N={n}: equal to subtile_max_i8.cu's output: {same}; in "
           f"turns: piped {p1:.3f} / {p2:.3f} ms ({2 * flops / (p1 + p2) / 1e9:.1f} TOP/s), "
           f"subtile_max_i8 {s1:.3f} / {s2:.3f} ms ({2 * flops / (s1 + s2) / 1e9:.1f} TOP/s); "
           f"bound {bound(flops, H100_INT8_PEAK, n * DIM + 5 * n + BATCH * DIM + 4 * BATCH * (n // G))['bound_ms']:.3f} "
           f"ms (int8 ops)")
    check(same, "piped int8 differs from subtile_max_i8 at N=2M")
    out["i8_ms"], out["i8_stream_ms"] = (p1 + p2) / 2, (s1 + s2) / 2
    del q, codes, scale, valid
    torch.cuda.empty_cache()
    return out


def probe_corpus(torch, gen, n, dev):
    """The probe's recipe: N(0, 1) unit rows (bf16), 3% dead and zeroed,
    queries that are corpus rows plus 0.1 noise."""
    x = torch.randn((n, DIM), generator=gen, device=dev)
    x /= torch.linalg.norm(x, dim=1, keepdim=True)
    valid = torch.rand(n, generator=gen, device=dev) > 0.03
    x[~valid] = 0
    return x.to(torch.bfloat16), valid


def probe_queries(torch, gen, x, b, dev):
    idx = torch.randint(0, x.shape[0], (b,), generator=gen, device=dev)
    q = x[idx].float() + 0.1 * torch.randn((b, DIM), generator=gen, device=dev)
    return q / torch.linalg.norm(q, dim=1, keepdim=True)


def compare_topk(torch, fm, got, want, packed: bool, what: str, exact: bool = False) -> float:
    """Checks the fused kernel's (scores, ids) against its plain version's:
    not packed, scores within TOL and ids equal except between candidates
    within TOL of the k-th score; packed, quantized scores equal or one
    quantum apart, and ids equal except within one quantum of the k-th;
    ``exact`` (integer data), both bit for bit. Returns the max abs score
    difference."""
    gs, gp = (t.cpu() for t in got)
    ws, wp = (t.cpu() for t in want)
    err = float((gs - ws).abs().max())
    if exact:
        same = bool(torch.equal(gs, ws) and torch.equal(gp, wp))
        report(f"fused {what}: scores and ids bit for bit the plain version's: {same}")
        check(same, f"fused_mips_topk differs from its plain version on integer data ({what})")
        return err
    if packed:  # scores in quanta: the key with its index bits shifted out
        bits = fm.packed_bits(FUSED_TILE, True)
        gv = (fm.quantize_keys(gs, bits).long() >> bits).double()
        wv = (fm.quantize_keys(ws, bits).long() >> bits).double()
        slack = 1.0
    else:
        gv, wv, slack = gs.double(), ws.double(), TOL
    off = float((gv - wv).abs().max())
    bad = 0
    for i in range(gp.shape[0]):
        diff = set(gp[i].tolist()) ^ set(wp[i].tolist())
        score = dict(zip(gp[i].tolist() + wp[i].tolist(), gv[i].tolist() + wv[i].tolist()))
        bad += any(abs(score[p] - float(wv[i, -1])) > slack for p in diff)
    report(f"fused {what}: max|kernel - plain| score {err:.3e}, "
           f"{'quanta' if packed else 'abs'} apart at most {off:g} (bound {slack:g}); rows "
           f"whose ids differ beyond a tie at the k-th score: {bad}")
    check(off <= slack, f"fused_mips_topk scores disagree with its plain version ({what})")
    check(bad == 0, f"fused_mips_topk ids disagree with its plain version ({what})")
    return err


def phase_kernel_fused(torch, fm, dev) -> dict:
    phase("kernel against its plain version: fused_mips_topk (bf16, tile 2048)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    x, valid = probe_corpus(torch, gen, KERNEL_N, dev)
    sq = (x.float() * x.float()).sum(1)
    max_err = 0.0
    for b, skip, packed, k, metric in FUSED_CASES:
        q = probe_queries(torch, gen, x, b, dev)
        got = fm.fused_mips_topk(q, x, valid, sq, k, tile_n=FUSED_TILE, metric=metric,
                                 skip_tiles=skip, packed=packed)
        torch.cuda.synchronize()
        want = fm.fused_mips_topk_plain(q, x, valid, sq, k, FUSED_TILE, metric, skip, packed)
        check(got[0].shape == (b, k) and got[1].shape == (b, k), "fused output shape")
        max_err = max(max_err, compare_topk(
            torch, fm, got, want, packed,
            f"{metric} B={b} N={KERNEL_N} k={k} skip_tiles={skip} packed={packed}"))
    del x, valid, sq

    # integer data: every dot exact in any order, so scores tie within and
    # across splits and the kernel equals its plain version bit for bit;
    # d = 100 on a view off a 16-byte boundary (the wrapper's copy), and a
    # corpus with fewer live rows than k
    for b, n, d, offset, live, metric in FUSED_EXACT:
        x = torch.randint(-2, 3, (n, d), generator=gen, device=dev).to(torch.bfloat16)
        q = torch.randint(-2, 3, (b, d), generator=gen, device=dev).to(torch.bfloat16)
        valid = torch.rand(n, generator=gen, device=dev) > 0.03
        if live is not None:
            valid[:] = False
            valid[torch.randperm(n, generator=gen, device=dev)[:live]] = True
        sq = (x.float() * x.float()).sum(1)
        xv, qv = x, q
        if offset:
            xv = torch.cat([x.new_zeros(offset), x.flatten()])[offset:].view(x.shape)
            qv = torch.cat([q.new_zeros(offset), q.flatten()])[offset:].view(q.shape)
        for skip, packed in ((False, False), (True, True)):
            got = fm.fused_mips_topk(qv, xv, valid, sq, 128 if live else K, tile_n=FUSED_TILE,
                                     metric=metric, skip_tiles=skip, packed=packed)
            torch.cuda.synchronize()
            want = fm.fused_mips_topk_plain(q, x, valid, sq, 128 if live else K, FUSED_TILE,
                                            metric, skip, packed)
            compare_topk(torch, fm, got, want, packed,
                         f"integer {metric} B={b} N={n} d={d} offset {offset} live "
                         f"{live if live else 'most'} skip_tiles={skip} packed={packed}",
                         exact=True)
            if live:
                check(bool((got[1][:, live:] == -1).all()), "fused empty slots are not -1")
    del x, q, valid, sq, xv, qv, got, want

    n = -(-PROBE_N // 4096) * 4096  # the probe pads its rows to 4096
    x, valid = probe_corpus(torch, gen, n, dev)
    valid[PROBE_N:] = False
    x[PROBE_N:] = 0
    sq = torch.ones(n, device=dev)
    q = probe_queries(torch, gen, x[:PROBE_N], BATCH, dev)
    kernel = lambda: fm.fused_mips_topk(q, x, valid, sq, K, tile_n=FUSED_TILE,  # noqa: E731
                                        skip_tiles=True, packed=True)
    plain = lambda: fm.fused_mips_topk_plain(q, x, valid, sq, K, FUSED_TILE,  # noqa: E731
                                             "cosine", True, True)
    max_err = max(max_err, compare_topk(torch, fm, kernel(), plain(), True,
                                        f"B={BATCH} N={n} skip_tiles packed"))
    flops = 2.0 * BATCH * n * DIM
    timed = in_turns(kernel, plain, f"fused bf16 B={BATCH} N={n} d={DIM} k={K} skip_tiles "
                     "packed", flops, "TFLOP/s", n * DIM * 2)
    unpacked = lambda: fm.fused_mips_topk(q, x, valid, sq, K, tile_n=FUSED_TILE)  # noqa: E731
    unpacked()
    unpacked_ms = cuda_ms(unpacked, 5)
    report(f"fused, packed off (skip_tiles off too; the kernel filters either way): "
           f"{unpacked_ms:.3f} ms (CUDA events)")
    # yardsticks, not library calls (neither computes the function): the
    # GEMM alone and the GEMM followed by torch.topk, in turns with the
    # kernel
    qb = torch.nn.functional.normalize(q, dim=1).to(torch.bfloat16)
    gemm = lambda: torch.matmul(qb, x.T)  # noqa: E731
    gemm_topk = lambda: torch.topk(torch.matmul(qb, x.T), K, dim=1)  # noqa: E731
    gemm(), gemm_topk()
    g1, t1, f1, f2, t2, g2 = (cuda_ms(f, 5) for f in
                              (gemm, gemm_topk, kernel, kernel, gemm_topk, gemm))
    report(f"fused against yardsticks, bf16 B={BATCH} N={n}, in turns: fused {f1:.3f} / "
           f"{f2:.3f} ms ({2 * flops / (f1 + f2) / 1e9:.1f} TFLOP/s), torch.matmul(q, x.T) "
           f"{g1:.3f} / {g2:.3f} ms, matmul + torch.topk(., {K}) {t1:.3f} / {t2:.3f} ms")
    nbytes = n * DIM * 2 + n + BATCH * DIM * 2 + 8 * BATCH * K
    del x, valid, sq, q, qb
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timed, **bound(flops, H100_BF16_PEAK, nbytes),
            "library_ms": None, "unpacked_ms": unpacked_ms, "gemm_ms": (g1 + g2) / 2,
            "gemm_topk_ms": (t1 + t2) / 2}


def phase_kernel_stream(torch, cst, dev) -> dict:
    phase("kernel against its plain version: corpus_stream (exact)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        if dtype == torch.int8:
            x = torch.randint(-127, 128, (KERNEL_N, DIM), generator=gen, device=dev,
                              dtype=torch.int8)
        else:
            x = torch.randn((KERNEL_N, DIM), generator=gen, device=dev).to(dtype)
        got = cst.corpus_stream(x)
        torch.cuda.synchronize()
        err = float((got - cst.corpus_stream_plain(x)).abs().max())
        report(f"corpus_stream {dtype} N={KERNEL_N} d={DIM}: max|kernel - plain| = {err:.3e} "
               f"(must be 0)")
        check(got.shape == (8, DIM) and err == 0.0, f"corpus_stream differs: {err}")
    n = TIMING_N
    x = torch.randn((n, DIM), generator=gen, device=dev).to(torch.bfloat16)
    kernel = lambda: cst.corpus_stream(x)  # noqa: E731
    plain = lambda: cst.corpus_stream_plain(x)  # noqa: E731
    lib = lambda: torch.amax(x.view(-1, 8, DIM), dim=0)  # noqa: E731
    err = float((kernel() - plain()).abs().max())
    check(err == 0.0 and torch.equal(kernel(), lib().float()),
          "corpus_stream differs from its plain version or the library call at N=2M")
    nbytes = n * DIM * 2 + 8 * DIM * 4
    timed = in_turns(kernel, plain, f"corpus_stream bf16 N={n} d={DIM}", n * DIM,
                     "T max/s", nbytes, "of corpus")
    lib_ms = library_ms(lib, f"torch.amax(corpus.view(-1, 8, {DIM}), dim=0) bf16 N={n}")
    del x
    torch.cuda.empty_cache()
    return {"max_abs_err": err, **timed, **bound(n * DIM, H100_F32_PEAK, nbytes),
            "library_ms": lib_ms}


def phase_probe(torch, smp, fm, cst, dev) -> dict:
    """The kernel probe, the path of the last three kernels: its default
    sweep plus every producer, both fused modes and both corpus types."""
    from rag_arc_tpu_torch.tools import kernel_probe as kp

    configs = kp.parse_configs("") + PROBE_CONFIGS
    phase(f"kernel probe: {PROBE_N} x {DIM} bf16 (+ int8), B={BATCH}, k={K}, "
          f"{len(configs)} configs, {PROBE_REPS} streams of {PROBE_STREAM} batches")
    t0 = time.perf_counter()
    data = kp.make_data(PROBE_N, DIM, BATCH, PROBE_STREAM, K, SEED, dev, int8=True)
    torch.cuda.synchronize()
    report(f"probe data made on the card in {time.perf_counter() - t0:.1f} s")
    counters = {"subtile_max_piped": Counter(smp), "fused_mips_topk": Counter(fm),
                "corpus_stream": Counter(cst)}
    for c in counters.values():
        c.reset()
    stream_top = {}
    for cfg in configs:
        try:
            line, top = kp.probe(cfg, data, K, PROBE_REPS, dev)
        except Exception as exc:  # noqa: BLE001 — reported, then the run fails
            raise SmokeFailure(f"probe config {cfg} failed: {exc}") from exc
        report("probe " + json.dumps(line))
        if line["recall"] is not None:
            check(line["recall"] >= 0.99, f"probe {cfg}: recall@10 {line['recall']} < 0.99")
        if cfg["kind"] == "stream":
            stream_top[cfg["producer"]] = top
    launches = {name: c.read() for name, c in counters.items()}
    # the three producers sum in three orders (wgmma, WMMA, the scan's f32
    # matmul), so their ids may differ from the stream kernel's only
    # between candidates tied with the k-th score within TOL
    (s_ref, ids_ref) = stream_top["stream"]

    def untied_rows(other):
        s_o, ids_o = other
        rows = np.flatnonzero((ids_o != ids_ref).any(axis=1))
        untied = 0
        for i in rows:
            score = dict(zip(ids_ref[i].tolist() + ids_o[i].tolist(),
                             s_ref[i].tolist() + s_o[i].tolist()))
            diff = set(ids_ref[i].tolist()) ^ set(ids_o[i].tolist())
            untied += any(abs(score[p] - float(s_ref[i, -1])) > TOL for p in diff)
        return rows, untied

    piped_rows, piped_untied = untied_rows(stream_top["stream_piped"])
    rows, untied = untied_rows(stream_top["scan"])
    # pass 1 itself, on the same batch: the scan's maxima against
    # subtile_max.cu's, so the relaxed id check rests on a direct one
    cfg = PROBE_CONFIGS[0]
    q0 = data["batches"][0].to(data["emb"].dtype)
    p1 = {p: kp.produce(p, q0, data["emb"], data["valid"], cfg["g"], cfg["tile_n"])
          for p in ("stream", "scan")}
    gaps = (p1["scan"] - p1["stream"]).abs()
    gap = float(gaps.max())
    gap_rows = float(gaps[torch.as_tensor(rows, device=dev)].max()) if len(rows) else 0.0
    del p1, gaps
    report(f"probe: stream_piped ids differ from stream's in {len(piped_rows)} of "
           f"{len(ids_ref)} rows, beyond a tie at the k-th score (atol {TOL:g}) in "
           f"{piped_untied}; scan ids differ in "
           f"{len(rows)} of {len(ids_ref)} rows, beyond a tie at the k-th score (atol "
           f"{TOL:g}) in {untied}; pass 1 on that batch, max|scan - subtile_max.cu| = "
           f"{gap:.3e} (atol {TOL:g}), {gap_rows:.3e} on the rows whose ids differ; "
           f"kernel launches {launches}")
    check(piped_untied == 0,
          "the stream_piped producer's ids differ beyond ties at the k-th score")
    check(untied == 0, "the scan producer's ids differ beyond ties at the k-th score")
    check(gap <= TOL, f"the scan's pass-1 maxima disagree with subtile_max.cu's: {gap}")
    for name, n in launches.items():
        check(n >= 1, f"the probe never launched {name}")
    del data
    torch.cuda.empty_cache()
    return launches


def make_index_data(torch, dev) -> dict:
    """The shared corpus (host f32, unit rows), query batches and the f32
    exact cosine oracle of the first ORACLE_QUERIES queries."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    corpus = rng.random((CORPUS_N, DIM), dtype=np.float32)
    corpus -= 0.5
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    q_idx = rng.integers(0, CORPUS_N, size=BATCH * N_BATCHES)
    queries = corpus[q_idx] + 0.1 * rng.standard_normal((BATCH * N_BATCHES, DIM), dtype=np.float32)
    queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    gen_s = time.perf_counter() - t0
    sub_q = torch.from_numpy(queries[:ORACLE_QUERIES]).to(dev)
    scores = torch.empty((ORACLE_QUERIES, CORPUS_N), device=dev)
    chunk = 1 << 18
    for start in range(0, CORPUS_N, chunk):  # f32, TF32 off: the exact oracle
        part = torch.from_numpy(corpus[start : start + chunk]).to(dev)
        scores[:, start : start + chunk] = sub_q @ part.T
    exact = torch.topk(scores, K, dim=1).indices.cpu().numpy()
    del scores
    torch.cuda.empty_cache()
    batches = [torch.from_numpy(queries[i * BATCH : (i + 1) * BATCH]).to(dev)
               for i in range(N_BATCHES)]
    return {"corpus": corpus, "queries": queries, "batches": batches, "exact": exact,
            "gen_s": gen_s}


def recall_at_k(got: np.ndarray, exact: np.ndarray) -> float:
    return float(np.mean([len(set(got[i]) & set(exact[i])) / K for i in range(len(exact))]))


def run_batches(index, batches, counters: dict, repeats: int = 1):
    """Search every batch (dispatch all, then fetch all) once as a warm-up,
    then ``repeats`` timed times, then time 10 single batches; returns
    (fetched, the sustained QPS of each timed repeat, p50 ms, the first
    timed repeat's kernel launches by name). The warm-up's QPS and what
    each pass grew the caching allocator's reserve by are reported: a
    pass that grows it pays for cudaMalloc calls on the host clock."""
    import torch

    from rag_arc_tpu_torch.index.flat import fetch_pair

    def dispatch_all():
        """One pass: (fetched, QPS, GiB the reserve grew, host ms spent
        dispatching, host ms of the slowest single dispatch)."""
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        outs, slowest = [], 0.0
        for b in batches:
            t1 = time.perf_counter()
            outs.append(index.search_device(b, K))
            slowest = max(slowest, time.perf_counter() - t1)
        dispatch = time.perf_counter() - t0
        fetched = [fetch_pair(s, p) for s, p in outs]
        qps = BATCH * len(batches) / (time.perf_counter() - t0)
        return (fetched, qps, (torch.cuda.memory_reserved() - reserved) / 2**30,
                dispatch * 1e3, slowest * 1e3)

    _, warm_qps, warm_grew, _, _ = dispatch_all()
    qps, grew, host, launches = [], [], [], {}
    for r in range(repeats):
        for c in counters.values():
            c.reset()
        fetched, q, g, disp, slow = dispatch_all()
        qps.append(q)
        grew.append(g)
        host.append(f"{disp:.1f} ({slow:.1f})")
        if r == 0:
            launches = {name: c.read() for name, c in counters.items()}
    times = []
    for b in batches[:10]:
        t1 = time.perf_counter()
        fetch_pair(*index.search_device(b, K))
        times.append(time.perf_counter() - t1)
    p50 = float(np.percentile(times, 50)) * 1e3
    spread = (max(qps) - min(qps)) / min(qps)
    report(f"sustained {', '.join(f'{v:.1f}' for v in qps)} QPS (host clock; each "
           f"{len(batches)} x {BATCH} queries, dispatch all then fetch all; spread "
           f"{100 * spread:.1f}% of the lowest; reserve grown "
           f"{', '.join(f'{v:.2f}' for v in grew)} GiB; host ms dispatching (slowest "
           f"call) {', '.join(host)}) after an untimed warm-up pass of "
           f"the same ({warm_qps:.1f} QPS, reserve grown {warm_grew:.2f} GiB); p50 batch "
           f"{p50:.3f} ms incl. readback; kernel launches in the first timed run {launches}")
    for name, n in launches.items():
        check(n >= len(batches), f"{name} launched {n} times for {len(batches)} searches")
    return fetched, qps, p50, launches


@contextlib.contextmanager
def plain_select():
    """The two-level ops with the select's plain version (the tournament)
    in place of its kernel: with a plain producer, the all-plain pipeline
    that the kernel path's ids are held to."""
    from rag_arc_tpu_torch.ops import two_level as tl
    from rag_arc_tpu_torch.ops.subtile_select import iterative_argmax_resid_plain

    kernel = tl.iterative_argmax_resid
    tl.iterative_argmax_resid = iterative_argmax_resid_plain
    try:
        yield
    finally:
        tl.iterative_argmax_resid = kernel


def search_split(torch, ss, label: str, stages: dict, sub, k_sel: int,
                 b: int = BATCH) -> None:
    """Device ms of one batch's search and its stages (CUDA events, mean of
    5 after one call outside the window). ``stages`` holds "search",
    "producer" and "select + rescore" (then any others); the select is
    timed alone at the search's ``k_sel`` sub-tiles, and the rescore is
    select + rescore less the select. Then the select alone at each of
    SELECT_KS."""
    stages = dict(stages)
    stages["select"] = lambda: ss.iterative_argmax_resid(sub, k_sel)
    for k in SELECT_KS:
        stages[f"select k={k}"] = lambda k=k: ss.iterative_argmax_resid(sub, k)
    t = {}
    for name, fn in stages.items():
        fn()
        torch.cuda.synchronize()
        t[name] = cuda_ms(fn, 5)
    rest = [n for n in stages if n not in ("search", "producer", "select", "select + rescore")
            and not n.startswith("select k=")]
    report(f"{label} layers, one batch B={b} (CUDA events): search {t['search']:.3f} ms; "
           f"producer {t['producer']:.3f} ms, select (k={k_sel}) {t['select']:.3f} ms, rescore "
           f"{t['select + rescore'] - t['select']:.3f} ms (select + rescore "
           f"{t['select + rescore']:.3f} less the select)"
           + "".join(f", {n} {t[n]:.3f} ms" for n in rest)
           + "; the select alone at " + ", ".join(f"kf={k} {t[f'select k={k}']:.3f} ms"
                                                  for k in SELECT_KS))


class Counter:
    """Reads and resets one wrapper's launch count."""

    def __init__(self, module, name: str = "launches"):
        self.module, self.name = module, name

    def reset(self) -> None:
        setattr(self.module, self.name, 0)

    def read(self) -> int:
        return getattr(self.module, self.name)


@contextlib.contextmanager
def uncounted(*modules):
    """Launches inside do not count: a serving phase's timing and reference
    calls, made while no request is being served. Each module's counts are
    put back as they were on the way out."""
    names = ("launches", "launches_l2", "launches_plan", "launches_gated")
    saved = [(m, n, getattr(m, n)) for m in modules for n in names if hasattr(m, n)]
    try:
        yield
    finally:
        for module, name, value in saved:
            setattr(module, name, value)


def phase_index(torch, sm, ss, dev, data):
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore

    phase(f"index: {CORPUS_N} x {DIM} bf16, {N_BATCHES} batches of {BATCH}, k={K}")
    corpus, batches = data["corpus"], data["batches"]
    t0 = time.perf_counter()
    index = DeviceFlatIndex(dim=DIM, metric="cosine", capacity=CORPUS_N,
                            dtype=torch.bfloat16, device=dev)
    step = 1 << 17
    for start in range(0, CORPUS_N, step):
        index.add(corpus[start : start + step])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    report(f"host data {data['gen_s']:.1f} s; index build {build_s:.1f} s; capacity "
           f"{index.capacity}, {index.stats()['hbm_bytes'] / 2**30:.2f} GiB on the card")
    check(4 * BATCH * index.capacity > index.SCORE_BYTES_BUDGET,
          "index search would not take the kernel path")
    fetched, _, _, _ = run_batches(
        index, batches, {"subtile_max": Counter(sm), "subtile_select": Counter(ss)}, repeats=3)

    before = ss.launches
    with plain_select():
        for i in range(2):
            qc = prepare_queries(batches[i], index.dtype, "cosine")
            sub = sm.subtile_max_plain(qc, index.emb, index.valid, G)
            _, p_plain = select_rescore(qc, index.emb, index.valid, sub, K, G)
            same = np.array_equal(p_plain.cpu().numpy(), fetched[i][1])
            report(f"batch {i}: ids equal to the all-plain pipeline's: {same}")
            check(same, f"batch {i}: kernel-path ids differ from the all-plain pipeline's")
    check(ss.launches == before, "the all-plain pipeline launched the select kernel")
    del sub, p_plain

    got = fetched[0][1][:ORACLE_QUERIES]  # batch 0's first rows are the oracle queries
    recall = recall_at_k(got, data["exact"])
    report(f"recall@10 vs f32 exact on {ORACLE_QUERIES} queries: {recall:.4f} (bar 0.99)")
    check(recall >= 0.99, f"recall@10 {recall} < 0.99")

    q = batches[0]
    qc = prepare_queries(q, index.dtype, "cosine")
    sub = sm.subtile_max(qc, index.emb, index.valid, G)
    search_split(torch, ss, "bf16", {
        "search": lambda: index.search_device(q, K),
        "producer": lambda: sm.subtile_max(qc, index.emb, index.valid, G),
        "select + rescore": lambda: select_rescore(qc, index.emb, index.valid, sub, K, G),
        "query prep": lambda: prepare_queries(q, index.dtype, "cosine"),
    }, sub, min(K, sub.shape[1]))
    del sub
    pooled_passes(torch, index, batches)
    if PARENT is not None:
        from rag_arc_tpu_torch.tools import kernel_ab as ab

        # the B=512 search and sustained QPS with the parent's select in
        # this one's place, in turns (parent, this, this, parent)
        row = ab.ab_dense(ab.OtherKernels(PARENT), index, batches, CARD)
        check(row["equal"], "the dense search's positions differ with the parent's select")
    torch.cuda.empty_cache()
    return index


def pooled_passes(torch, index, batches) -> None:
    """Sustained QPS of the dense passes read back one batch at a time
    (``fetch_pair``) and through one ``transfer_pool()`` flush a pass, in
    turns (plain, pooled, pooled, plain, plain, pooled)."""
    from rag_arc_tpu_torch.index.flat import fetch_pair, pair_readback
    from rag_arc_tpu_torch.utils.transfers import transfer_pool

    def one(pooled: bool) -> float:
        t0 = time.perf_counter()
        if pooled:
            with transfer_pool():
                fetches = [pair_readback(*index.search_device(b, K)) for b in batches]
            for f in fetches:
                f()
        else:
            outs = [index.search_device(b, K) for b in batches]
            for s, p in outs:
                fetch_pair(s, p)
        return BATCH * len(batches) / (time.perf_counter() - t0)

    qps = {False: [], True: []}
    for pooled in (False, True, True, False, False, True):
        qps[pooled].append(one(pooled))
    report(f"sustained QPS read back per batch {', '.join(f'{v:.1f}' for v in qps[False])}; "
           f"through one TransferPool flush a pass {', '.join(f'{v:.1f}' for v in qps[True])} "
           f"(host clock, {len(batches)} x {BATCH} queries a pass, in turns)")


def ties_only(s, p, ws, wp, tie: float) -> bool:
    """Whether (s, p) equal the reference (ws, wp) but among equal scores:
    ranked scores within 1e-5, the same empty slots, and a position that
    differs only at a rank whose reference score lies within ``tie`` of a
    neighbour's, or, as a set, of the k-th score. Host arrays, (B, k)."""
    if not np.allclose(s, ws, rtol=0, atol=1e-5) or not np.array_equal(p < 0, wp < 0):
        return False
    for r in range(len(wp)):
        sr = ws[r]
        for j in np.nonzero(p[r] != wp[r])[0]:
            near = np.abs(sr[max(j - 1, 0) : j + 2] - sr[j]) <= tie
            if near.sum() < 2:
                return False
    return ids_off_ties(s, p, ws, wp, tie) == 0


def phase_crossover(torch, sm, ss, dev, ns=CROSS_NS, bs=CROSS_BS) -> list[dict]:
    """The bf16 cosine search's direct path (``masked_topk``: the corpus
    widened to f32, a GEMV or GEMM, a sort of every score) against the
    two-level path (``two_level_topk``: the producer and select kernels,
    the rescore) at B in ``bs`` over each of ``ns`` rows, k =
    CROSS_K, in turns (direct, two-level, two-level, direct): CUDA-event
    ms as the host issues each call and device ms with the host ahead,
    beside the bytes bound; positions equal but among equal scores. Then
    the B = 1 two-level search split into producer, select and rescore on
    each corpus. Returns one row a (rows, B)."""
    from rag_arc_tpu_torch.index.flat import fetch_pair, normalize_raw
    from rag_arc_tpu_torch.ops.topk import masked_topk
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore, two_level_topk

    phase(f"crossover: bf16 cosine search, direct vs two-level in turns, B in {bs}, "
          f"rows in {ns}, d={DIM}, k={CROSS_K}, ~3% dead rows")
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    out = []
    for n in ns:
        x = unit_rows(gen, n, DIM, torch.bfloat16, dev)
        valid = torch.rand(n, generator=gen, device=dev) > 0.03
        x[~valid] = 0
        qs = unit_rows(gen, max(bs), DIM, torch.float32, dev)
        for b in bs:
            q = qs[:b]
            fns = {"direct": lambda q=q: masked_topk(q, x, valid, CROSS_K),
                   "two_level": lambda q=q: two_level_topk(q, x, valid, CROSS_K, g=G)}
            before = sm.launches
            got = normalize_raw(*fetch_pair(*fns["two_level"]()), b, CROSS_K, CROSS_K)
            check(sm.launches == before + 1, f"the two-level search at B={b} launched the "
                                             f"producer {sm.launches - before} times")
            # the direct path on the query as the two-level path prepares it
            # (normalized in f32, rounded once; cosine rows are unit, so ip):
            # the index's direct path normalizes in bf16, ~1e-4 off
            qc = prepare_queries(q, x.dtype, "cosine").float()
            want = normalize_raw(*fetch_pair(*masked_topk(qc, x, valid, CROSS_K, "ip")), b,
                                 CROSS_K, CROSS_K)
            same = ties_only(*got, *want, CROSS_TIE)
            moved = int((got[1] != want[1]).sum())
            t = ab_turns(fns)
            bd = bound(2.0 * b * n * DIM, H100_BF16_PEAK, 2.0 * n * DIM + 4.0 * b * DIM
                       + 8.0 * b * CROSS_K)
            row = {"rows": n, "b": b, **{k: [round(v, 4) for v in vs] for k, vs in t.items()},
                   **bd, "ids_equal_but_ties": same, "positions_moved": moved}
            dev_direct = float(np.mean(t["direct_queued_ms"]))
            dev_two = float(np.mean(t["two_level_queued_ms"]))
            issued = {name: float(np.mean(t[f"{name}_ms"])) for name in fns}
            row["faster_as_issued"] = min(issued, key=issued.get)
            row["faster_on_device"] = "two_level" if dev_two < dev_direct else "direct"
            out.append(row)
            report(f"rows {n}, B={b}: direct {' / '.join(f'{v:.3f}' for v in t['direct_ms'])} "
                   f"ms, two-level {' / '.join(f'{v:.3f}' for v in t['two_level_ms'])} ms "
                   f"(CUDA events as issued, in turns); device with the host ahead: direct "
                   f"{dev_direct:.3f} ms, two-level {dev_two:.3f} ms ({dev_direct / dev_two:.2f}x); "
                   f"bound {bd['bound_ms']:.3f} ms ({bd['bound_by']}; two-level share "
                   f"{bd['bound_ms'] / dev_two:.3f}); positions equal but among equal scores: "
                   f"{same} ({moved} of {b * CROSS_K} slots moved)")
            check(same, f"rows {n}, B={b}: two-level positions differ from the direct "
                        f"path's past ties")
        q = qs[:1]
        qc = prepare_queries(q, x.dtype, "cosine")
        sub = sm.subtile_max(qc, x, valid, G)
        search_split(torch, ss, f"rows {n}, two-level", {
            "search": lambda: two_level_topk(q, x, valid, CROSS_K, g=G),
            "producer": lambda: sm.subtile_max(qc, x, valid, G),
            "select + rescore": lambda: select_rescore(qc, x, valid, sub, CROSS_K, G),
            "query prep": lambda: prepare_queries(q, x.dtype, "cosine"),
            "direct": lambda: masked_topk(q, x, valid, CROSS_K),
        }, sub, min(CROSS_K, sub.shape[1]), b=1)
        del x, valid, qs, sub
        torch.cuda.empty_cache()
    return out


def phase_index_l2(torch, sm, ss, dev, data) -> int:
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore

    phase(f"index: {L2_N} x {DIM} bf16 l2, {L2_BATCHES} batches of {BATCH}, k={K}")
    corpus = data["corpus"][:L2_N]
    batches = data["batches"][:L2_BATCHES]
    index = DeviceFlatIndex(dim=DIM, metric="l2", capacity=L2_N, dtype=torch.bfloat16,
                            device=dev)
    for start in range(0, L2_N, 1 << 17):
        index.add(corpus[start : start + (1 << 17)])
    check(4 * BATCH * index.capacity > index.SCORE_BYTES_BUDGET,
          "l2 search would not take the kernel path")
    fetched, _, _, launches = run_batches(
        index, batches, {"subtile_max_l2": Counter(sm, "launches_l2"),
                         "subtile_select": Counter(ss)})

    qc = prepare_queries(batches[0], index.dtype, "l2")
    with plain_select():
        sub = sm.subtile_max_plain(qc, index.emb, index.valid, G, sqnorm=index.sqnorm)
        _, p_plain = select_rescore(qc, index.emb, index.valid, sub, K, G, "l2", index.sqnorm)
    same = np.array_equal(p_plain.cpu().numpy(), fetched[0][1])
    report(f"batch 0: ids equal to the all-plain pipeline's: {same}")
    check(same, "l2 kernel-path ids differ from the all-plain pipeline's")
    sub = sm.subtile_max(qc, index.emb, index.valid, G, sqnorm=index.sqnorm)
    search_split(torch, ss, "l2", {
        "search": lambda: index.search_device(batches[0], K),
        "producer": lambda: sm.subtile_max(qc, index.emb, index.valid, G, sqnorm=index.sqnorm),
        "select + rescore": lambda: select_rescore(qc, index.emb, index.valid, sub, K, G, "l2",
                                                   index.sqnorm),
    }, sub, min(K, sub.shape[1]))
    del sub, p_plain

    q = batches[0][:ORACLE_QUERIES]
    q_sq = (q * q).sum(1, keepdim=True)
    scores = torch.empty((ORACLE_QUERIES, L2_N), device=dev)
    for start in range(0, L2_N, 1 << 18):  # f32, TF32 off: the exact l2 oracle
        part = torch.from_numpy(corpus[start : start + (1 << 18)]).to(dev)
        scores[:, start : start + (1 << 18)] = -(q_sq - 2.0 * (q @ part.T)
                                                 + (part * part).sum(1)[None, :])
    exact = torch.topk(scores, K, dim=1).indices.cpu().numpy()
    recall = recall_at_k(fetched[0][1][:ORACLE_QUERIES], exact)
    report(f"l2 recall@10 vs f32 exact on {ORACLE_QUERIES} queries: {recall:.4f} (bar 0.99)")
    check(recall >= 0.99, f"l2 recall@10 {recall} < 0.99")
    del index, scores
    torch.cuda.empty_cache()
    return launches["subtile_max_l2"]


def resident_bytes(index) -> int:
    return sum(t.numel() * t.element_size() for t in index._arrays())


def phase_index_i8(torch, smi8, ss, dev, data) -> None:
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex, fetch_pair
    from rag_arc_tpu_torch.index.vector_store import get_tracer
    from rag_arc_tpu_torch.ops.two_level import quantize_queries, select_rescore_i8

    phase(f"index: {CORPUS_N} x {DIM} int8 + int4 refine, kf_mult 2, "
          f"{N_BATCHES} batches of {BATCH}, k={K}")
    corpus, batches = data["corpus"], data["batches"]
    get_tracer().reset()
    t0 = time.perf_counter()
    index = DeviceFlatIndex(dim=DIM, metric="cosine", capacity=CORPUS_N,
                            dtype=torch.int8, device=dev)
    for start in range(0, CORPUS_N, 1 << 17):
        index.add(corpus[start : start + (1 << 17)])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    quant_s = get_tracer().summary()["index.quantize"]["total_ms"] / 1e3
    resident = resident_bytes(index)
    report(f"index build {build_s:.1f} s, of it host quantization + residual "
           f"encoding {quant_s:.1f} s (host clock); refine {index.refine}, kf_mult "
           f"{index.kf_mult}, gap rows {index._gap_rows}; {resident / 2**30:.3f} GiB "
           f"resident on the card (stats hbm_bytes {index.stats()['hbm_bytes']})")
    fetched, qps, p50, _ = run_batches(
        index, batches, {"subtile_max_i8": Counter(smi8), "subtile_select": Counter(ss)})

    kf = index._kf(K)
    with plain_select():
        for i in range(2):
            q_i8, qscale = quantize_queries(batches[i])
            sub = smi8.subtile_max_i8_plain(q_i8, index.emb, index.sqnorm, index.valid, G)
            s, p = select_rescore_i8(q_i8, qscale, index.emb, index.sqnorm, index.valid,
                                     sub, kf, G)
            _, p_plain = fetch_pair(*index.rescore_candidates(batches[i], s, p, K))
            same = np.array_equal(p_plain, fetched[i][1])
            report(f"batch {i}: ids equal to the all-plain pipeline's: {same}")
            check(same, f"int8 batch {i}: kernel-path ids differ from the all-plain pipeline's")
    del sub, s, p

    recall = recall_at_k(fetched[0][1][:ORACLE_QUERIES], data["exact"])
    report(f"int8 recall@10 vs f32 exact on {ORACLE_QUERIES} queries: {recall:.4f} "
           f"(bar 0.99); {qps[0]:.1f} QPS, p50 {p50:.3f} ms")
    check(recall >= 0.99, f"int8 recall@10 {recall} < 0.99")

    q = batches[0]
    q_i8, qscale = quantize_queries(q)
    sub = smi8.subtile_max_i8(q_i8, index.emb, index.sqnorm, index.valid, G)
    s, p = select_rescore_i8(q_i8, qscale, index.emb, index.sqnorm, index.valid, sub, kf, G)
    search_split(torch, ss, f"int8 (kf={kf})", {
        "search": lambda: index.search_device(q, K),
        "producer": lambda: smi8.subtile_max_i8(q_i8, index.emb, index.sqnorm, index.valid, G),
        "select + rescore": lambda: select_rescore_i8(
            q_i8, qscale, index.emb, index.sqnorm, index.valid, sub, kf, G),
        "query quantization": lambda: quantize_queries(q),
        "refined rescore": lambda: index.rescore_candidates(q, s, p, K),
    }, sub, min(kf, sub.shape[1]))
    del sub, s, p

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = (smi8.launches, ss.launches)
    one = torch.from_numpy(data["queries"][:1]).to(dev)
    fetch_pair(*index.search_device(one, K))
    peak = torch.cuda.max_memory_allocated()
    took = (smi8.launches, ss.launches) == (before[0] + 1, before[1] + 1)
    report(f"B=1 search: peak {peak / 2**30:.3f} GiB allocated against "
           f"{resident / 2**30:.3f} GiB resident (+{(peak - base) / 2**20:.1f} MiB over "
           f"what was allocated before it); took the kernel path (one producer and one "
           f"select launch): {took}")
    check(took, "B=1 int8 search did not launch the producer and the select kernel once")
    check(peak <= resident + 2**30, "B=1 int8 search peaked above resident + 1 GiB")
    del index
    torch.cuda.empty_cache()


# -- sparse and hybrid retrieval ------------------------------------------------


def bm25_agreement(got, want) -> tuple[float, float]:
    """Mean top-K set agreement of ``got`` with ``want`` (both (scores,
    positions)), and the largest relative difference of their sorted
    scores."""
    (gs, gp), (ws, wp) = got, want
    agree = float(np.mean([len(set(gp[i].tolist()) & set(wp[i].tolist())) / K
                           for i in range(len(wp))]))
    a, b = np.sort(gs, axis=1), np.sort(ws, axis=1)
    err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-6)))
    return agree, err


def stream_ms(index, batches) -> list[float]:
    """Host ms per batch of each of BM25_PASSES passes: every batch
    dispatched (``search_dispatch``), then every result fetched; after one
    untimed search."""
    index.search(batches[0], K)
    times = []
    for _ in range(BM25_PASSES):
        t0 = time.perf_counter()
        pending = [index.search_dispatch(b, K) for b in batches]
        for p in pending:
            p.result()
        times.append((time.perf_counter() - t0) / len(batches) * 1e3)
    return times


def bm25_split(torch, ss, ob, index, queries) -> None:
    """Device ms of one coalesced head batch's hybrid program and of its
    parts (CUDA events, mean of 5 after one call outside the window), and
    the select_topk kernel path held against the plain tournament on the
    card on that batch's score array."""
    tail_only, packed, widths, slots = index._hybrid_operands(index._count_terms(queries))
    check(not tail_only, "a head batch took the tail-only program")
    b, h = len(queries), index._w_head.shape[0]
    packed_d = index._upload(packed)
    w_head, valid = index._w_head, index._hvalid
    docs, weights = index._tail_docs_dev, index._tail_w_dev
    q_head = packed_d[: b * h].reshape(b, h)
    scores = ob.head_scores(q_head, w_head)
    scores.masked_fill_(~valid[None, :], float("-inf"))
    buckets, o = [], b * h
    for width, s in zip(widths, slots):
        buckets.append((packed_d[o : o + s], packed_d[o + s : o + 2 * s],
                        packed_d[o + 2 * s : o + 3 * s], packed_d[o + 3 * s : o + 4 * s], width))
        o += 4 * s
    for st, ln, ct, qi, width in buckets:
        ob._slab_add(scores, docs, weights, st, ln, ct, qi, width)
    work = scores.clone()
    n_pad = scores.shape[1]
    g = 512
    sub = torch.amax(scores.view(b, n_pad // g, g), dim=2)

    def slabs():
        for st, ln, ct, qi, width in buckets:
            ob._slab_add(work, docs, weights, st, ln, ct, qi, width)

    parts = {
        "program": lambda: ob.bm25_hybrid_topk_flat(w_head, valid, docs, weights, packed_d, K,
                                                    b, h, widths, slots),
        "head matmul": lambda: ob.head_scores(q_head, w_head),
        "mask": lambda: work.masked_fill_(~valid[None, :], float("-inf")),
        "slab gather + scatter-add": slabs,
        "group max": lambda: torch.amax(scores.view(b, n_pad // g, g), dim=2),
        "select kernel": lambda: ss.iterative_argmax_resid(sub, K),
        "select_topk (group max + select + gather + final top-k)":
            lambda: ob.select_topk(scores, K),
    }
    t = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t[name] = cuda_ms(fn, 5)
    head_bytes = w_head.numel() * w_head.element_size()
    report(f"hybrid program, one coalesced head batch B={b} H={h} N_pad={n_pad} "
           f"(buckets {list(widths)}, slabs {list(slots)}; CUDA events): "
           + ", ".join(f"{n} {v:.3f} ms" for n, v in t.items())
           + f"; the head matmul reads {head_bytes / 2**30:.2f} GiB "
           f"({head_bytes / t['head matmul'] / 1e6:.1f} GB/s), the score array "
           f"{b * n_pad * 4 / 2**20:.0f} MiB")
    del work

    got = ob.select_topk(scores, K)
    torch.cuda.synchronize()
    want = ob._coarse_topk(scores, K, g)  # the plain tournament, on the card
    ws, wp = want
    wp = torch.where(torch.isneginf(ws), -1, wp)
    same = bool(torch.equal(got[0], ws) and torch.equal(got[1], wp))
    report(f"select_topk on this score array (B={b}, C={n_pad // g} groups of {g}, k={K}): "
           f"values and ids equal to the plain tournament's: {same}")
    check(same, "select_topk's kernel path differs from the plain tournament")
    in_turns(lambda: ob.select_topk(scores, K), lambda: ob._coarse_topk(scores, K, g),
             f"select_topk B={b} N={n_pad} k={K}", b * n_pad, "T entries/s", b * n_pad * 4,
             "of scores")
    del scores, sub
    torch.cuda.empty_cache()


def tail_split(torch, ss, ob, index, queries) -> None:
    """Device ms of one coalesced selective batch's tail-only program and
    of its sort and select alone on arrays of the same shape (CUDA events,
    mean of 5 after one call outside the window)."""
    tail_only, packed, widths, slots = index._hybrid_operands(index._count_terms(queries))
    check(tail_only, "a selective batch did not take the tail-only program")
    b = len(queries)
    packed_d = index._upload(packed)
    window = sum(w * t for w, t in zip(widths, slots))
    gen = torch.Generator(device=packed_d.device).manual_seed(SEED)
    ids = torch.randint(-1, index.n_docs, (b, window), generator=gen, device=packed_d.device)
    vals = torch.rand((b, window), generator=gen, device=packed_d.device)
    parts = {
        "program": lambda: ob.bm25_tail_only_topk(index._tail_docs_dev, index._tail_w_dev,
                                                  packed_d, K, widths, slots),
        "stable sort of the window": lambda: torch.sort(ids, dim=1, stable=True),
        "select kernel over the window": lambda: ss.iterative_argmax_resid(vals, K),
    }
    t = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t[name] = cuda_ms(fn, 5)
    report(f"tail-only program, one coalesced selective batch B={b} (window {window} slots, "
           f"buckets {list(widths)}, slabs a query {list(slots)}; CUDA events): "
           + ", ".join(f"{n} {v:.3f} ms" for n, v in t.items())
           + f"; the rest (gather, {max(1, (window - 1).bit_length())} scan steps, run "
           f"ends) {t['program'] - t['stable sort of the window'] - t['select kernel over the window']:.3f} ms")


def phase_bm25(torch, ss, dev):
    """The hybrid BM25 index at 2M documents against the host C++ scorer,
    per query profile; the doc-major backend at 262,144 documents."""
    from rag_arc_tpu_torch.index.bm25 import DeviceBM25Index
    from rag_arc_tpu_torch.ops import bm25 as ob
    from rag_arc_tpu_torch.tools.bm25_synth import (bm25_queries, csr_texts, mixed_queries,
                                                    synth_csr)

    phase(f"bm25 hybrid: {BM25_N} docs of zipf CSR (vocab {BM25_VOCAB}, mean length "
          f"{BM25_MEAN_LEN}), f32 head, B={BM25_B}, {BM25_BATCHES} batches streamed, "
          f"{BM25_PASSES} passes, k={K}")
    t0 = time.perf_counter()
    csr = synth_csr(np.random.default_rng(SEED), BM25_N, BM25_VOCAB, BM25_MEAN_LEN)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hybrid = DeviceBM25Index(backend="hybrid", device=dev)
    hybrid.build_from_csr(*csr)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = DeviceBM25Index(backend="host", device=dev)
    host.build_from_csr(*csr)
    host_s = time.perf_counter() - t0
    held = hybrid.device_bytes()
    n_pad = hybrid._w_head.shape[1]
    score_bytes = hybrid.DEV_COALESCE_MAX * n_pad * 4
    report(f"synthesis {synth_s:.1f} s ({len(csr[1])} postings); hybrid build {build_s:.1f} s "
           f"(host clock; C++ postings + head + tail to the card), host-only build "
           f"{host_s:.1f} s; head terms {hybrid.stats()['head_terms']}, tail widths "
           f"{list(hybrid._tail_widths)}; on the card: head "
           f"{held['w_head'] / 2**30:.3f} GiB + tail "
           f"{(held['tail_docs_dev'] + held['tail_w_dev']) / 2**30:.3f} GiB + the largest "
           f"score array (B={hybrid.DEV_COALESCE_MAX}) {score_bytes / 2**30:.3f} GiB")

    rng = np.random.default_rng(7)
    n_q = BM25_B * BM25_BATCHES
    head, sel = bm25_queries(rng, n_q, BM25_VOCAB)
    mixed = mixed_queries(head, sel)
    launches = 0
    lines = []
    for name, queries, budget in (("head", head, None), ("selective", sel, None),
                                  ("mixed", mixed, None), ("selective, host_budget=0", sel, 0)):
        hybrid.host_budget = budget
        cut = budget if budget is not None else max(1 << 15, hybrid.n_docs // 16)
        to_dev = sum(hybrid._estimated_entries([c]) > cut
                     for c in hybrid._count_terms(queries))
        batches = [queries[i * BM25_B : (i + 1) * BM25_B] for i in range(BM25_BATCHES)]
        ss.launches = 0
        times = stream_ms(hybrid, batches)
        n_launch = ss.launches
        launches += n_launch
        ms = float(np.median(times))
        got, want = hybrid.search(batches[0], K), host.search(batches[0], K)
        agree, err = bm25_agreement(got, want)
        tail_only = hybrid._hybrid_operands(hybrid._count_terms(batches[0]))[0]
        lines.append(f"{name} {ms:.2f} ms = {BM25_B / ms * 1e3:.1f} QPS")
        report(f"{name}: {to_dev}/{n_q} queries routed to the device; ms per batch "
               f"{', '.join(f'{v:.2f}' for v in times)} (host clock, median {ms:.2f}, "
               f"{BM25_B / ms * 1e3:.1f} QPS); select kernel launches {n_launch}; "
               f"device batches take the {'tail-only' if tail_only else 'flat'} program; "
               f"batch 0 vs the host scorer: top-{K} agreement {agree:.4f}, sorted scores "
               f"within {err:.2e} relative")
        check(agree == 1.0, f"bm25 {name}: top-{K} agreement {agree} with the host scorer")
        check(err <= 1e-4, f"bm25 {name}: scores differ from the host scorer by {err}")
        if to_dev:
            check(n_launch > 0, f"bm25 {name}: the select kernel never launched")
    hybrid.host_budget = None
    report("bm25 hybrid per profile: " + "; ".join(lines))
    check(launches > 0, "the select kernel never launched on the hybrid path")
    bm25_split(torch, ss, ob, hybrid, head[: hybrid.DEV_COALESCE_MAX])
    tail_split(torch, ss, ob, hybrid, sel[: hybrid.DEV_COALESCE_MAX])

    n = BM25_DEVICE_N
    e = int(csr[0][n])
    sub = (csr[0][: n + 1], csr[1][:e], csr[2][:e], csr[3][:n])
    t0 = time.perf_counter()
    texts = csr_texts(*sub[:3])
    doc_major = DeviceBM25Index(backend="device", device=dev)
    doc_major.build_from_texts_native(texts)
    small_host = DeviceBM25Index(backend="host", device=dev)
    small_host.build_from_csr(*sub)
    torch.cuda.synchronize()
    dm_s = time.perf_counter() - t0
    del texts
    for name, queries in (("head", head[:BM25_B]), ("selective", sel[:BM25_B])):
        t0 = time.perf_counter()
        got = doc_major.search(queries, K)
        ms = (time.perf_counter() - t0) * 1e3
        agree, err = bm25_agreement(got, small_host.search(queries, K))
        report(f"doc-major backend, {n} docs (Dmax {doc_major.stats()['dmax']}, built in "
               f"{dm_s:.1f} s), {name} B={BM25_B}: {ms:.1f} ms (host clock, first call); "
               f"agreement with the host scorer {agree:.4f}, scores within {err:.2e}")
        check(agree == 1.0 and err <= 1e-4, f"doc-major backend differs from the host ({name})")
    del doc_major, small_host, host, csr, sub
    torch.cuda.empty_cache()
    return hybrid, launches


def phase_multipath(torch, sm, ss, dev, index, bm25, data) -> None:
    """Dense (the 2M bf16 index) + BM25 (the 2M hybrid index) over one
    position space, fused by RRF, each pass one TransferPool stream."""
    from rag_arc_tpu_torch.ops.fusion_kernel import rrf_fuse_positions
    from rag_arc_tpu_torch.ops.topk import masked_topk
    from rag_arc_tpu_torch.tools.bm25_synth import bm25_queries
    from rag_arc_tpu_torch.utils.data_model import Document
    from rag_arc_tpu_torch.utils.fusion import RRFusion, results_from_ranked_docs
    from rag_arc_tpu_torch.utils.transfers import transfer_pool

    phase(f"multipath: dense {CORPUS_N} x {DIM} bf16 + bm25 hybrid {BM25_N}, k_path "
          f"{MULTI_K_PATH}, RRF k {RRF_K}, B={BM25_B}, {BM25_BATCHES} batches, selective "
          f"profile, {BM25_PASSES} passes")
    check(index.size == bm25.n_docs, "the two paths do not share one position space")
    _, sel = bm25_queries(np.random.default_rng(11), BM25_B * BM25_BATCHES, BM25_VOCAB)
    dense_q = [data["queries"][i * BM25_B : (i + 1) * BM25_B] for i in range(BM25_BATCHES)]
    toks = [sel[i * BM25_B : (i + 1) * BM25_B] for i in range(BM25_BATCHES)]
    index.search_dispatch(dense_q[0], MULTI_K_PATH)()
    bm25.search(toks[0], MULTI_K_PATH)

    def one_pass():
        with transfer_pool() as pool:
            dense = [index.search_dispatch(q, MULTI_K_PATH) for q in dense_q]
            sparse = [bm25.search_dispatch(t, MULTI_K_PATH) for t in toks]
            for p in sparse:
                p.prime()
        out = []
        for d, s in zip(dense, sparse):
            _, dp = d()
            _, bp = s.result()
            pos = torch.from_numpy(np.stack([dp, bp], axis=1).astype(np.int32))
            out.append((dp, bp, rrf_fuse_positions(pos, K, RRF_K)[1].numpy()))
        return out, pool.flushes

    sm.launches = ss.launches = 0
    times, flushes = [], []
    for _ in range(BM25_PASSES):
        t0 = time.perf_counter()
        out, n_flush = one_pass()
        times.append((time.perf_counter() - t0) / BM25_BATCHES * 1e3)
        flushes.append(n_flush)
    launches = {"subtile_max": sm.launches, "subtile_select": ss.launches}
    ms = float(np.median(times))
    report(f"ms per batch {', '.join(f'{v:.2f}' for v in times)} (host clock, median "
           f"{ms:.2f}, {BM25_B / ms * 1e3:.1f} QPS; dense dispatched first, then bm25, "
           f"primed, then fetched and fused); pool flushes per pass {flushes}; kernel "
           f"launches {launches} (the bf16 index of {index.capacity} rows on the card takes "
           f"its two-level path at every B: one producer and one select launch a batch)")
    check(all(f == 1 for f in flushes), f"pool flushes per stream {flushes}, not 1")
    check(launches["subtile_max"] == BM25_BATCHES * BM25_PASSES,
          f"the dense path launched the producer {launches['subtile_max']} times for "
          f"{BM25_BATCHES * BM25_PASSES} batches")

    dp, bp, fused = out[0]
    fusion = RRFusion(k=RRF_K)
    agree = 0
    for i in range(BM25_B):
        paths = [results_from_ranked_docs([Document(content=f"d{x}", id=str(x))
                                           for x in pos[i] if x >= 0], source=src)
                 for pos, src in ((dp, "dense"), (bp, "bm25"))]
        want = [int(d.id) for d in fusion.fuse(paths, K)]
        agree += want == [int(x) for x in fused[i] if x >= 0]
    report(f"fused ids equal to RRFusion.fuse over the two paths' results: "
           f"{agree}/{BM25_B} queries")
    check(agree == BM25_B, f"fused ids differ from RRFusion on {BM25_B - agree} queries")

    q = torch.from_numpy(dense_q[0]).to(dev)
    direct = cuda_ms(lambda: masked_topk(q, index.emb, index.valid, MULTI_K_PATH), 5)
    two_level = cuda_ms(lambda: index.search_device(q, MULTI_K_PATH), 5)
    report(f"one dense B={BM25_B} k={MULTI_K_PATH} search: the direct path's masked_topk "
           f"{direct:.3f} ms, the index's two-level kernel path {two_level:.3f} ms (CUDA "
           f"events, mean of 5)")


def phase_hybrid_retriever(torch, sm, ss, dev, store) -> int:
    """MultiPathRetriever(shared_id_space=True) over the e2e store's
    retriever and a BM25Retriever of the same documents, end to end."""
    from rag_arc_tpu_torch.index.vector_store import get_tracer
    from rag_arc_tpu_torch.retrieval.bm25 import BM25Retriever
    from rag_arc_tpu_torch.retrieval.multipath import MultiPathRetriever
    from rag_arc_tpu_torch.utils.data_model import Document
    from rag_arc_tpu_torch.utils.transfers import transfer_pool

    phase(f"hybrid retriever: MultiPathRetriever(shared_id_space=True) over the e2e store "
          f"({len(store)} docs) and a BM25Retriever (hybrid backend) of the same documents; "
          f"{HYBRID_QUERIES} document texts as queries, k={K}")
    docs = [store.docstore.get_by_position(i) for i in range(len(store))]
    t0 = time.perf_counter()
    sparse = BM25Retriever.from_documents(
        [Document(content=d.content, id=d.id) for d in docs], k=K, backend="hybrid",
        device=dev)
    bm25_s = time.perf_counter() - t0
    multi = MultiPathRetriever([store.as_retriever(search_kwargs={"k": K}), sparse],
                               top_k=K, top_k_per_retriever=MULTI_K_PATH, shared_id_space=True)
    picks = np.random.default_rng(SEED + 5).choice(len(docs), size=HYBRID_QUERIES,
                                                   replace=False)
    queries = [docs[i].content for i in picks]
    counts = sparse.index._count_terms([q.lower().split() for q in queries])
    cut = max(1 << 15, sparse.index.n_docs // 16)
    to_dev = sum(sparse.index._estimated_entries([c]) > cut for c in counts)
    multi.dispatch_batch(queries[:8])()  # warm: validates the shared id space
    check(multi._shared_ok is True, "the shared id space did not validate")

    get_tracer().reset()
    sm.launches = ss.launches = 0
    t0 = time.perf_counter()
    with transfer_pool() as pool:
        fetch = multi.dispatch_batch(queries)
        t_dispatch = time.perf_counter() - t0
        fetch.prime()
    out = fetch()
    total = time.perf_counter() - t0
    launches = {"subtile_max": sm.launches, "subtile_select": ss.launches}
    stages = get_tracer().summary()
    found = sum(docs[i].id in [d.id for d in row] for i, row in zip(picks, out))
    first = sum(bool(row) and row[0].id == docs[i].id for i, row in zip(picks, out))
    for row in out:
        check(len(row) == K and all(isinstance(d, Document) and "fusion_score" in d.metadata
                                    for d in row), "the hybrid retriever returned a bad row")
    t_sparse = time.perf_counter()
    sparse.index.search([q.lower().split() for q in queries], MULTI_K_PATH)
    t_sparse = time.perf_counter() - t_sparse
    report(f"dispatch_batch of {HYBRID_QUERIES}: {total * 1e3:.1f} ms = "
           f"{HYBRID_QUERIES / total:.1f} QPS (host clock; dispatch {t_dispatch * 1e3:.1f} ms "
           f"of it, the bm25 path alone {t_sparse * 1e3:.1f} ms, {to_dev} of its queries "
           f"routed to the device); store stages (host ms): "
           + ", ".join(f"{n} {v['total_ms']:.1f}" for n, v in sorted(stages.items()))
           + f"; pool flushes {pool.flushes}; kernel launches {launches}; bm25 build "
           f"{bm25_s:.1f} s")
    report(f"verbatim source in the fused top {K}: {found}/{HYBRID_QUERIES} = "
           f"{found / HYBRID_QUERIES:.4f}; first: {first / HYBRID_QUERIES:.4f}")
    check(found >= 0.99 * HYBRID_QUERIES,
          f"hybrid retriever: only {found}/{HYBRID_QUERIES} sources in the top {K}")
    check(pool.flushes == 1, f"the hybrid stream flushed {pool.flushes} times")
    check(launches["subtile_max"] >= 1 and launches["subtile_select"] >= 1,
          "the dense branch did not launch its kernels")

    emb = store.embedding
    ids, mask = emb.tokenizer.batch_encode(queries)
    length = emb._bucket_len(ids.shape[1])
    ids_d = torch.from_numpy(np.pad(ids, ((0, 0), (0, length - ids.shape[1])))).to(dev)
    mask_d = torch.from_numpy(np.pad(mask, ((0, 0), (0, length - mask.shape[1])))).to(dev)
    dense_ms = cuda_ms(lambda: store.index.search_device(emb.encode_device(ids_d, mask_d),
                                                         MULTI_K_PATH), 3)
    report(f"device: the dense branch (encode + search, B={HYBRID_QUERIES}, k_path "
           f"{MULTI_K_PATH}) {dense_ms:.3f} ms (CUDA events, mean of 3)")

    found = 0
    t0 = time.perf_counter()
    for i in picks[:N_SINGLE]:
        got = multi.invoke(docs[i].content)
        check(len(got) == K, "invoke did not return k Documents")
        found += docs[i].id in [d.id for d in got]
    single_ms = (time.perf_counter() - t0) / N_SINGLE * 1e3
    report(f"invoke: {N_SINGLE} single queries, {single_ms:.2f} ms each (host clock), "
           f"source in the top {K} for {found}/{N_SINGLE}")
    check(found == N_SINGLE, f"invoke found {found}/{N_SINGLE} sources")
    del sparse, multi
    return launches["subtile_select"]


def make_docs(rng) -> list[str]:
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    wl = rng.integers(3, 11, DOC_VOCAB)
    chars = letters[rng.integers(0, 26, int(wl.sum()))]
    ends = np.cumsum(wl)
    vocab = np.array(["".join(chars[e - n : e]) for n, e in zip(wl, ends)], dtype=object)
    lens = rng.integers(8, 49, N_DOCS)
    words = vocab[rng.integers(0, DOC_VOCAB, int(lens.sum()))]
    ends = np.cumsum(lens)
    return [" ".join(words[e - n : e]) for n, e in zip(lens, ends)]


def layer_times(torch, sm, ss, store, emb, batch_texts) -> None:
    """Device time of each layer of one B=512 query batch (CUDA events)."""
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore

    t0 = time.perf_counter()
    ids, mask = emb.tokenizer.batch_encode(batch_texts)
    length = emb._bucket_len(ids.shape[1])
    ids = np.pad(ids, ((0, 0), (0, length - ids.shape[1])))
    mask = np.pad(mask, ((0, 0), (0, length - mask.shape[1])))
    tok_ms = (time.perf_counter() - t0) * 1e3
    dev = store.device
    ids_d, mask_d = torch.from_numpy(ids).to(dev), torch.from_numpy(mask).to(dev)
    q = emb.encode_device(ids_d, mask_d)
    index = store.index
    qc = prepare_queries(q, index.dtype, "cosine")
    sub = sm.subtile_max(qc, index.emb, index.valid, G)
    enc = cuda_ms(lambda: emb.encode_device(ids_d, mask_d), 5)
    search = cuda_ms(lambda: index.search_device(q, K), 5)
    kern = cuda_ms(lambda: sm.subtile_max(qc, index.emb, index.valid, G), 5)
    sel = cuda_ms(lambda: ss.iterative_argmax_resid(sub, K), 5)
    sel_res = cuda_ms(lambda: select_rescore(qc, index.emb, index.valid, sub, K, G), 5)
    report(f"layers, one batch B={BATCH} L={length}: tokenize {tok_ms:.2f} ms (host), "
           f"encoder {enc:.3f} ms, search {search:.3f} ms = sub-tile-max kernel "
           f"{kern:.3f} ms + select {sel:.3f} ms + rescore {sel_res - sel:.3f} ms (select + "
           f"rescore {sel_res:.3f} less the select) + query prep (CUDA events)")


def phase_end_to_end(torch, sm, ss, dev):
    from rag_arc_tpu_torch.index.vector_store import Document, TorchVectorStore, get_tracer
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings

    cfg = TransformerConfig()
    phase(f"end to end: encoder {cfg.dim}x{cfg.depth} bf16 (seeded random "
          f"weights), {N_DOCS} documents, capacity {STORE_CAPACITY}")
    rng = np.random.default_rng(SEED)
    texts = make_docs(rng)
    ids = [f"d{i}" for i in range(N_DOCS)]
    emb = TorchEncoderEmbeddings(cfg, seed=SEED, device=dev)

    sm.launches = ss.launches = 0
    t0 = time.perf_counter()
    store = TorchVectorStore.from_texts(
        texts, emb, ids=ids, capacity=STORE_CAPACITY, dtype=torch.bfloat16, device=dev
    )
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    report(f"ingest {N_DOCS} docs in {ingest_s:.1f} s = {N_DOCS / ingest_s:.1f} docs/s "
           f"(tokenize + pack + encode + index add)")
    check(len(store) == N_DOCS, f"store holds {len(store)} documents")

    picks = rng.choice(N_DOCS, size=E2E_BATCHES * BATCH, replace=False)
    store.batch_similarity_search_with_score([texts[i] for i in picks[:BATCH]], k=K)  # warm
    get_tracer().reset()
    hits_top10 = hits_top1 = 0
    t0 = time.perf_counter()
    results = []
    for j in range(E2E_BATCHES):
        batch = picks[j * BATCH : (j + 1) * BATCH]
        results.append((batch, store.batch_similarity_search_with_score(
            [texts[i] for i in batch], k=K)))
    query_s = time.perf_counter() - t0
    for batch, res in results:
        for i, hits in zip(batch, res):
            check(len(hits) == K, f"query d{i}: {len(hits)} hits")
            for doc, score in hits:
                check(isinstance(doc, Document) and store.get_by_ids([doc.id])[0] is doc,
                      "a result is not a Document of the store")
                check(np.isfinite(score), "non-finite score")
            got = [d.id for d, _ in hits]
            hits_top10 += f"d{i}" in got
            hits_top1 += got[0] == f"d{i}"
    n_q = E2E_BATCHES * BATCH
    stages = get_tracer().summary()
    report(f"{n_q} verbatim queries in {query_s:.3f} s = {n_q / query_s:.1f} QPS "
           f"(text → tokenize → encode → search → Documents, B={BATCH})")
    report("store stages, mean ms per batch (host clock): " + ", ".join(
        f"{name} {v['mean_ms']:.3f}" for name, v in sorted(stages.items())))
    report(f"source document in top 10: {hits_top10}/{n_q} = {hits_top10 / n_q:.4f}; "
           f"top 1: {hits_top1 / n_q:.4f}")
    check(hits_top10 >= 0.99 * n_q, f"only {hits_top10}/{n_q} sources in the top 10")

    retriever = store.as_retriever(search_kwargs={"k": K})
    found = 0
    t0 = time.perf_counter()
    for i in picks[:N_SINGLE]:
        docs = retriever.invoke(texts[i])
        check(len(docs) == K and all(isinstance(d, Document) for d in docs),
              "retriever did not return k Documents")
        found += docs[0].id == f"d{i}"
    single_ms = (time.perf_counter() - t0) / N_SINGLE * 1e3
    report(f"retriever.invoke: {N_SINGLE} single queries, {single_ms:.2f} ms each, "
           f"source first in {found}/{N_SINGLE}")
    check(found >= N_SINGLE - 1, f"retriever found {found}/{N_SINGLE} sources first")
    launches = {"subtile_max": sm.launches, "subtile_select": ss.launches}  # before the
    # layer timing below launches more
    report(f"kernel launches in the end-to-end run: {launches}")
    for name, n in launches.items():
        check(n >= E2E_BATCHES, f"{name} launched {n} times end to end")
    layer_times(torch, sm, ss, store, emb, [texts[i] for i in picks[:BATCH]])
    return launches, emb, texts, store


def phase_end_to_end_i8(torch, smi8, ss, dev, emb, texts) -> int:
    from rag_arc_tpu_torch.index.persistence import load_store, save_store
    from rag_arc_tpu_torch.index.vector_store import Document, TorchVectorStore

    phase(f"end to end, int8: the same encoder, {I8_DOCS} documents, capacity "
          f"{STORE_CAPACITY}, then a snapshot round trip")
    docs, ids = texts[:I8_DOCS], [f"d{i}" for i in range(I8_DOCS)]
    smi8.launches = ss.launches = 0
    t0 = time.perf_counter()
    store = TorchVectorStore.from_texts(
        docs, emb, ids=ids, capacity=STORE_CAPACITY, dtype=torch.int8, device=dev
    )
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    report(f"ingest {I8_DOCS} docs in {ingest_s:.2f} s = {I8_DOCS / ingest_s:.1f} docs/s; "
           f"refine {store.index.refine}, gap rows {store.index._gap_rows}")
    check(len(store) == I8_DOCS, f"int8 store holds {len(store)} documents")

    picks = np.random.default_rng(SEED + 2).choice(I8_DOCS, size=BATCH, replace=False)
    batch = [docs[i] for i in picks]
    t0 = time.perf_counter()
    res = store.batch_similarity_search_with_score(batch, k=K)
    batch_ms = (time.perf_counter() - t0) * 1e3
    top10 = top1 = 0
    for i, hits in zip(picks, res):
        check(len(hits) == K and all(isinstance(d, Document) and np.isfinite(s)
                                     for d, s in hits), f"int8 query d{i}: bad hits")
        got = [d.id for d, _ in hits]
        top10 += f"d{i}" in got
        top1 += got[0] == f"d{i}"
    report(f"one batch of {BATCH} verbatim texts in {batch_ms:.1f} ms (host clock, "
           f"first int8 batch); source in top 10: {top10}/{BATCH} = {top10 / BATCH:.4f}; "
           f"top 1: {top1 / BATCH:.4f}")
    check(top10 >= 0.99 * BATCH, f"int8: only {top10}/{BATCH} sources in the top 10")
    batch_launches = smi8.launches
    check(batch_launches >= 1, "the int8 kernel did not launch on the batch path")

    retriever = store.as_retriever(search_kwargs={"k": K})
    found = 0
    for i in picks[:I8_SINGLE]:
        got = retriever.invoke(docs[i])
        check(len(got) == K and all(isinstance(d, Document) for d in got),
              "int8 retriever did not return k Documents")
        found += got[0].id == f"d{i}"
    launches = smi8.launches
    report(f"retriever.invoke: {I8_SINGLE} single queries, source first in "
           f"{found}/{I8_SINGLE}; int8 kernel launches: batch {batch_launches}, "
           f"batch + retriever {launches}; select kernel launches {ss.launches}")
    check(found >= I8_SINGLE - 1, f"int8 retriever found {found}/{I8_SINGLE} sources first")
    check(launches >= batch_launches + I8_SINGLE,
          "the int8 kernel did not launch on the retriever path")
    check(ss.launches >= 1 + I8_SINGLE, "the select kernel did not launch on every int8 search")

    snap_root = ROOT / "rag_arc_tpu_torch" / "_build"
    snap_root.mkdir(parents=True, exist_ok=True)
    snap = Path(tempfile.mkdtemp(prefix="snapshot-", dir=snap_root))
    try:
        t0 = time.perf_counter()
        save_store(store, snap)
        loaded = load_store(snap, emb, device=dev)
        round_s = time.perf_counter() - t0
        a, b = store.index, loaded.index
        n = a.size
        same = {name: bool(torch.equal(getattr(a, name)[:n], getattr(b, name)[:n]))
                for name in ("emb", "sqnorm", "res", "res_scale", "valid")}
        report(f"snapshot save + load in {round_s:.2f} s; bit-equal: {same}; size "
               f"{b.size}, gap rows {b._gap_rows}, refine {b.refine}")
        check(all(same.values()) and (b.size, b._gap_rows, b.refine, b.n_deleted) ==
              (a.size, a._gap_rows, a.refine, a.n_deleted), "snapshot arrays differ")
        again = loaded.batch_similarity_search_with_score(batch, k=K)
        identical = all([(d.id, s) for d, s in x] == [(d.id, s) for d, s in y]
                        for x, y in zip(res, again))
        report(f"loaded store, the same batch: ids and scores identical: {identical}")
        check(identical, "results of the loaded snapshot differ")
    finally:
        shutil.rmtree(snap, ignore_errors=True)
    del store, loaded
    torch.cuda.empty_cache()
    return launches


def rope_inputs(torch, gen, b, l, nh, nkv, d, dtype, dev):
    """q/k/v as the column slices of one fused qkv projection output (the
    model's layout), left-padded positions, the rope tables, norm scales."""
    from rag_arc_tpu_torch.ops.rope_prep import rope_cos_sin

    qkv = torch.randn(b, l, (nh + 2 * nkv) * d, generator=gen, device=dev).to(dtype)
    q, k, v = qkv[..., : nh * d], qkv[..., nh * d : (nh + nkv) * d], qkv[..., (nh + nkv) * d :]
    mask = left_pad_mask(torch, gen, b, l, dev)
    pos = torch.clamp(torch.cumsum(mask.long(), 1) - 1, min=0)
    cos, sin = rope_cos_sin(pos, 1e6, d)
    qs = torch.rand(d, generator=gen, device=dev) + 0.5
    ks = torch.rand(d, generator=gen, device=dev) + 0.5
    return q, k, v, cos, sin, qs, ks


def left_pad_mask(torch, gen, b, l, dev):
    """(B, L) bool, row 0 unpadded, the rest with random left-pad lengths."""
    live = torch.randint(1, l + 1, (b,), generator=gen, device=dev)
    live[0] = l
    return torch.arange(l, device=dev)[None, :] >= (l - live)[:, None]


def phase_rope(torch, rp, dev) -> dict:
    phase("kernel against its plain version: rope_prep (KV heads repeated, and written once)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    max_err = 0.0
    for b, l, nh, nkv, d, dt_name, repeat in ROPE_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        q, k, v, cos, sin, qs, ks = rope_inputs(torch, gen, b, l, nh, nkv, d, dtype, dev)
        got = rp.rope_prep(q, k, v, cos, sin, qs, ks, nh=nh, nkv=nkv, d=d, repeat_kv=repeat)
        torch.cuda.synchronize()
        want = rp.rope_prep_plain(q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d),
                                  v.reshape(b, l, nkv, d), cos, sin, qs, ks,
                                  repeat_kv=repeat)
        atol, rtol = ROPE_TOL[dt_name]
        err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
        ok = all(bool(((g.float() - w.float()).abs() <= atol + rtol * w.float().abs()).all())
                 for g, w in zip(got, want))
        v_exact = bool(torch.equal(got[2], want[2]))
        max_err = max(max_err, err)
        kv_heads = nh if repeat else nkv
        report(f"{dt_name} B={b} L={l} nh/nkv={nh}/{nkv} D={d} repeat_kv={repeat}, "
               f"left-padded positions, norm folded: max|kernel - plain| = {err:.3e} "
               f"(bound {atol:g} + {rtol:g}|plain|), V exact: {v_exact}")
        check(got[0].shape == (b, nh, l, d)
              and got[1].shape == got[2].shape == (b, kv_heads, l, d), "rope_prep output shape")
        check(ok and v_exact, f"rope_prep disagrees with its plain version: {err}")
    del q, k, v, got, want

    b, l, nh, nkv, d = RERANK_B, RERANK_L, 16, 8, 128
    q, k, v, cos, sin, qs, ks = rope_inputs(torch, gen, b, l, nh, nkv, d, torch.bfloat16, dev)
    # bytes: q, k, v and the f32 tables read once; the outputs written once
    read = 2 * b * l * (nh + 2 * nkv) * d + 2 * 4 * b * l * d
    out = {}
    for repeat in (True, False):  # the model's path last: its line in the kernels JSON
        kernel = lambda: rp.rope_prep(q, k, v, cos, sin, qs, ks, nh=nh, nkv=nkv,  # noqa: E731
                                      d=d, repeat_kv=repeat)
        plain = lambda: rp.rope_prep_plain(  # noqa: E731
            q.reshape(b, l, nh, d), k.reshape(b, l, nkv, d), v.reshape(b, l, nkv, d),
            cos, sin, qs, ks, repeat_kv=repeat)
        moved = read + 2 * b * l * d * (nh + 2 * (nh if repeat else nkv))
        timed = in_turns(kernel, plain, f"rope_prep bf16 B={b} L={l} nh/nkv={nh}/{nkv} D={d} "
                         f"repeat_kv={repeat}", moved, "TB/s moved (reads + writes)", read,
                         "read")
        out[repeat] = {**timed, **bound(0.0, H100_BF16_PEAK, moved)}
    del q, k, v, cos, sin
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **out[False], "library_ms": None,
            "repeat_kv_ms": out[True]["ms"], "repeat_kv_bound_ms": out[True]["bound_ms"]}


def attn_inputs(torch, gen, b, h, hkv, l, d, dtype, dev):
    q = torch.randn(b, h, l, d, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, hkv, l, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    seg = left_pad_mask(torch, gen, b, l, dev).to(torch.int32)
    return q, k, v, seg


def flash_check(torch, fa, got, q, k, v, seg, what: str) -> float:
    """Holds one flash output against the plain version, every row."""
    d = q.shape[-1]
    want = fa.attention_plain(q, k, v, seg, causal=True, sm_scale=d ** -0.5)
    atol, rtol = FLASH_TOL["bf16" if q.dtype == torch.bfloat16 else "f32"]
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    finite = bool(torch.isfinite(got).all())
    report(f"{what}, left-padded, every row: max|kernel - plain| = {err:.3e} (bound {atol:g} + "
           f"{rtol:g}|plain|), finite: {finite}, pad rows {int((seg == 0).sum())}")
    check(finite and ok, f"flash_attention disagrees with its plain version ({what}): {err}")
    return err


def phase_flash(torch, fa, dev) -> dict:
    phase("kernel against its plain version: flash_attention (causal, segment ids, GQA)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    max_err = 0.0
    for b, h, hkv, l, d, dt_name in FLASH_CASES:
        dtype = torch.bfloat16 if dt_name == "bf16" else torch.float32
        q, k, v, seg = attn_inputs(torch, gen, b, h, hkv, l, d, dtype, dev)
        got = fa.flash_attention(q, k, v, seg)
        torch.cuda.synchronize()
        max_err = max(max_err, flash_check(torch, fa, got, q, k, v, seg,
                                           f"{dt_name} B={b} H/HKV={h}/{hkv} L={l} D={d}"))
        del got

    # out=: a (B, L, H, D) buffer seen as (B, H, L, D), written in place
    b, h, hkv, l, d = 8, 16, 8, 200, 128
    q, k, v, seg = attn_inputs(torch, gen, b, h, hkv, l, d, torch.bfloat16, dev)
    buf = torch.full((b, l, h, d), float("nan"), dtype=torch.bfloat16, device=dev)
    got = fa.flash_attention(q, k, v, seg, out=buf.transpose(1, 2))
    torch.cuda.synchronize()
    check(got.data_ptr() == buf.data_ptr(), "flash_attention(out=) returned another tensor")
    max_err = max(max_err, flash_check(torch, fa, buf.transpose(1, 2), q, k, v, seg,
                                       f"bf16 B={b} H/HKV={h}/{hkv} L={l} D={d} out=(B,L,H,D)"))
    del q, k, v, seg, buf, got

    b, h, hkv, l, d = RERANK_B, 16, 8, RERANK_L, 128
    q, k, v, seg = attn_inputs(torch, gen, b, h, hkv, l, d, torch.bfloat16, dev)
    kernel = lambda: fa.flash_attention(q, k, v, seg)  # noqa: E731
    plain = lambda: fa.attention_plain(q, k, v, seg, causal=True, sm_scale=d ** -0.5)  # noqa: E731
    flops = 4.0 * b * h * l * l * d / 2  # the causal half
    nbytes = (2 * h + 2 * hkv) * b * l * d * 2 + 4 * b * l  # Q, out; K, V once per KV head
    timed = in_turns(kernel, plain, f"flash_attention bf16 B={b} H/HKV={h}/{hkv} L={l} D={d} "
                     "causal", flops, "TFLOP/s", nbytes, "of Q, K, V, out")
    # the library yardstick: SDPA with the boolean mask causal & same
    # segment, the KV heads shared (enable_gqa); under the segment rule no
    # row is fully masked
    causal = torch.ones(l, l, dtype=torch.bool, device=dev).tril()
    mask = causal[None, None] & (seg[:, None, :, None] == seg[:, None, None, :])
    lib = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
        q, k, v, attn_mask=mask, scale=d ** -0.5, enable_gqa=True)
    lib_err = float((lib().float() - kernel().float()).abs().max())
    lib_ms = library_ms(lib, f"scaled_dot_product_attention bf16 B={b} H/HKV={h}/{hkv} L={l} "
                        f"D={d}, causal & segment mask, enable_gqa (max|library - kernel| "
                        f"{lib_err:.3e})")
    del q, k, v, seg, mask
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, **timed, **bound(flops, H100_BF16_PEAK, nbytes),
            "library_ms": lib_ms}


def phase_rms_norm(torch, rn, dev) -> dict:
    """The residual add + RMSNorm kernel at each served reranker's shape:
    ``x_new`` bit-equal to torch's bf16 add, ``y`` bit-equal to the plain
    chain on at least 99.9% of elements and one bf16 step elsewhere; then
    its device time with the host ahead of the card, in turns with the plain
    chain, beside its byte bound (x and delta read, x_new and y written,
    4·T·H·2 bytes) and ``F.rms_norm`` after an add (a yardstick the port
    never calls). Returns each shape's numbers."""
    import torch.nn.functional as F

    phase("kernel against its plain version: add_rms_norm (residual add + RMSNorm, bf16)")
    gen = torch.Generator(device=dev).manual_seed(SEED + 18)
    eps = 1e-6
    out = {}
    for t, h, what in RMS_NORM_SHAPES:
        x = (3 * torch.randn(t, h, generator=gen, device=dev)).bfloat16()
        delta = torch.randn(t, h, generator=gen, device=dev).bfloat16()
        w = (1 + 0.1 * torch.randn(h, generator=gen, device=dev)).bfloat16()
        before = rn.launches
        got_x, got_y = rn.add_rms_norm(x, delta, w, eps)
        check(rn.launches == before + 1, "add_rms_norm did not launch its kernel once")
        want_x, want_y = rn.add_rms_norm_plain(x, delta, w, eps)
        g, wy = got_y.float(), want_y.float()
        equal = float((g == wy).float().mean())
        one_step = bool(((g - wy).abs() <= wy.abs() * 2.0 ** -7).all())
        report(f"add_rms_norm T={t} H={h} ({what}): x_new bit-equal to torch's add "
               f"{torch.equal(got_x, want_x)}; y bit-equal on {100 * equal:.4f}% (at least "
               f"99.9%), the rest within one bf16 step {one_step}")
        check(torch.equal(got_x, want_x), "add_rms_norm's x_new is not torch's bf16 add")
        check(equal >= 0.999 and one_step, "add_rms_norm's y strays from the plain chain")
        del got_x, got_y, want_x, want_y, g, wy

        kernel = lambda: rn.add_rms_norm(x, delta, w, eps)  # noqa: E731
        plain = lambda: rn.add_rms_norm_plain(x, delta, w, eps)  # noqa: E731
        library = lambda: F.rms_norm(x + delta, (h,), w, eps)  # noqa: E731
        p1, k1, k2, p2 = (queued_ms(fn) for fn in (plain, kernel, kernel, plain))
        lib = queued_ms(library)
        events = cuda_ms(kernel, 20)
        nbytes = 4 * t * h * 2
        row = {"ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2, "library_ms": lib,
               "events_ms": events, **bound(5.0 * t * h, H100_F32_PEAK, nbytes)}
        report(f"add_rms_norm T={t} H={h}: kernel {k1:.4f} / {k2:.4f} ms, plain chain "
               f"{p1:.4f} / {p2:.4f} ms (device ms, the host ahead; in turns plain, kernel, "
               f"kernel, plain); library add + F.rms_norm {lib:.4f} ms; kernel "
               f"{nbytes / row['ms'] / 1e6:.1f} GB/s; bound {row['bound_ms']:.4f} ms "
               f"({row['bound_by']}; share {row['bound_ms'] / row['ms']:.2f}); CUDA events with "
               f"the host's launch {events:.4f} ms")
        out[f"T{t}_H{h}"] = row
        del x, delta, w
    torch.cuda.empty_cache()
    return out


def rerank_flops_per_pair(cfg, length: int) -> float:
    """Matmul FLOPs of one pair's forward, as bench.py:421-429 counts them
    (qkvo + SwiGLU per layer, plus 4·L·NH·D attention per token)."""
    h, hd, nh, nkv, inter = (cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.intermediate_size)
    per_layer = 2 * h * hd * (2 * nh + 2 * nkv) + 6 * h * inter
    attn = 4 * length * nh * hd
    return float(length * cfg.num_hidden_layers * (per_layer + attn))


def p_yes(torch, logits, yes_id: int, no_id: int):
    pair = torch.stack([logits[:, no_id], logits[:, yes_id]], dim=-1).float()
    return torch.softmax(pair, dim=-1)[:, 1]


def qwen3_layer_times(torch, model, rp, fa, ids, mask) -> None:
    """Device time of each stage of layer 0 at the rerank shape."""
    import math

    from rag_arc_tpu_torch.models.decoder import cast_linear
    from rag_arc_tpu_torch.models.qwen3 import attention_context
    from rag_arc_tpu_torch.ops.rms_norm import add_rms_norm

    cfg = model.cfg
    layer, attn = model.layers[0], model.layers[0].self_attn
    hd, nh, nkv, dt = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads, cfg.dtype
    ctx = attention_context(cfg, mask)
    with torch.inference_mode():
        x = model.embed_tokens(ids).to(dt)
        h = layer.input_layernorm(x)
        qkv = cast_linear(attn.qkv_proj, h, dt)
        q, k, v = qkv[..., : nh * hd], qkv[..., nh * hd : (nh + nkv) * hd], qkv[..., (nh + nkv) * hd :]
        qn, ks = attn.q_norm.weight.float(), attn.k_norm.weight.float()
        qr, kr, vr = rp.rope_prep(q, k, v, ctx.cos, ctx.sin, qn, ks, nh=nh, nkv=nkv, d=hd,
                                  repeat_kv=False)
        buf = torch.empty((x.shape[0], x.shape[1], nh, hd), dtype=dt, device=x.device)
        fa.flash_attention(qr, kr, vr, ctx.seg, sm_scale=1.0 / math.sqrt(hd),
                           out=buf.transpose(1, 2))
        flat = buf.view(x.shape[0], x.shape[1], nh * hd)

        norm1, norm2 = layer.input_layernorm, layer.post_attention_layernorm

        def mlp():
            gu = cast_linear(layer.gateup_proj, add_rms_norm(x, x, norm2.weight, norm2.eps)[1], dt)
            gate, up = gu[..., : cfg.intermediate_size], gu[..., cfg.intermediate_size :]
            return cast_linear(layer.down_proj, torch.nn.functional.silu(gate) * up, dt)

        stages = {
            "input add + RMSNorm": lambda: add_rms_norm(x, x, norm1.weight, norm1.eps),
            "qkv projection": lambda: cast_linear(attn.qkv_proj, h, dt),
            "rope_prep": lambda: rp.rope_prep(q, k, v, ctx.cos, ctx.sin, qn, ks, nh=nh,
                                              nkv=nkv, d=hd, repeat_kv=False),
            "attention (into the (B,L,H,D) buffer)": lambda: fa.flash_attention(
                qr, kr, vr, ctx.seg, sm_scale=1.0 / math.sqrt(hd), out=buf.transpose(1, 2)),
            "o_proj": lambda: cast_linear(attn.o_proj, flat, dt),
            "MLP (add + norm, gate|up, SiLU*up, down)": mlp,
            "whole layer": lambda: layer(x, x, ctx),
        }
        times = {}
        for name, fn in stages.items():
            # a first call outside the window: first-use allocations stall
            # the host, and CUDA events would count the device's idle gap
            fn()
            torch.cuda.synchronize()
            times[name] = cuda_ms(fn, 10)
    report(f"layer 0 of {cfg.num_hidden_layers}, B={ids.shape[0]} L={ids.shape[1]} bf16 "
           f"(CUDA events, mean of 10): " + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))


def model_attention_calls(torch, model, ids, mask) -> dict:
    """One forward with the model's rope_prep and flash_attention calls
    watched: the K heads each returns or reads, and whether attention
    writes into a (B, L, H, D) buffer (no repeat, no copy)."""
    from rag_arc_tpu_torch.models import qwen3 as tq

    seen = {"rope": set(), "flash": set(), "out": set(), "n": 0}
    rope, flash = tq.rope_prep, tq.flash_attention

    def rope_watch(*a, **kw):
        q, k, v = rope(*a, **kw)
        seen["rope"].add((kw.get("repeat_kv", True), k.shape[1]))
        return q, k, v

    def flash_watch(q, k, v, seg, **kw):
        o = kw.get("out")
        seen["flash"].add(k.shape[1])
        seen["out"].add(o is not None and o.transpose(1, 2).is_contiguous())
        seen["n"] += 1
        return flash(q, k, v, seg, **kw)

    tq.rope_prep, tq.flash_attention = rope_watch, flash_watch
    try:
        model.last_logits(ids, mask)
    finally:
        tq.rope_prep, tq.flash_attention = rope, flash
    (repeat, heads), = seen["rope"]
    return {"rope_prep repeat_kv=False, K heads": heads if not repeat else -1,
            "flash_attention K heads": min(seen["flash"]) if len(seen["flash"]) == 1 else -1,
            "flash_attention out= a (B,L,H,D) buffer": seen["out"] == {True},
            "layers": seen["n"]}


def phase_rerank_model(torch, rp, fa, dev):
    """Qwen3-0.6B widths, seeded N(0, 0.02) bf16 weights, last_logits at
    B=64 x L=512 on the kernel path, timed and held against the einsum
    path; then an f32 check at full width and 2 layers. Returns the model,
    its einsum-path twin (the same weights) and the ``add_rms_norm``
    launches a forward that the timed forwards counted."""
    import dataclasses

    from rag_arc_tpu_torch.models.qwen3 import Qwen3Config, Qwen3LM, init_qwen3
    from rag_arc_tpu_torch.ops import rms_norm as rn
    from rag_arc_tpu_torch.rerank.cross_encoder import HashTokenizer

    cfg = Qwen3Config(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    phase(f"rerank model: Qwen3 {cfg.num_hidden_layers}x{cfg.hidden_size}, heads "
          f"{cfg.num_attention_heads}/{cfg.num_key_value_heads}x{cfg.head_dim}, vocab "
          f"{cfg.vocab_size}, bf16 (seeded N(0, 0.02) weights), last_logits at "
          f"B={RERANK_B} L={RERANK_L}")
    t0 = time.perf_counter()
    model = init_qwen3(cfg, SEED, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    report(f"{n_params / 1e6:.1f}M parameters made on the card in "
           f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ids = torch.randint(4, cfg.vocab_size, (RERANK_B, RERANK_L), generator=gen, device=dev)
    full = torch.ones_like(ids, dtype=torch.bool)

    with torch.inference_mode():
        calls = model_attention_calls(torch, model, ids, full)  # also the warm-up
        torch.cuda.synchronize()
        for module in (rp, fa, rn):
            Counter(module).reset()
        fwd_ms = cuda_ms(lambda: model.last_logits(ids, full), RERANK_REPS)
        launches = (rp.launches, fa.launches, rn.launches)
    per_fwd = tuple(n // RERANK_REPS for n in launches)
    pairs_s = RERANK_B / (fwd_ms / 1e3)
    flops = rerank_flops_per_pair(cfg, RERANK_L)
    mfu = pairs_s * flops / H100_BF16_PEAK
    report(f"last_logits forward {fwd_ms:.3f} ms (CUDA events, mean of {RERANK_REPS}): "
           f"{pairs_s:.1f} pairs/s, {1e3 * 50 / pairs_s:.2f} ms per 50-candidate query, "
           f"MFU {100 * mfu:.2f}% of 989 TFLOP/s dense bf16 ({flops * RERANK_B / 1e12:.2f} "
           f"TFLOP a batch, bench.py:421-429 count); launches per forward: rope_prep "
           f"{per_fwd[0]}, flash_attention {per_fwd[1]}, add_rms_norm {per_fwd[2]}")
    layers = cfg.num_hidden_layers
    check(per_fwd == (layers, layers, 2 * layers + 1),
          f"launches per forward {per_fwd}, want {layers}, {layers} and {2 * layers + 1}")
    report(f"the forward's attention calls: {calls}")
    check(calls == {"rope_prep repeat_kv=False, K heads": cfg.num_key_value_heads,
                    "flash_attention K heads": cfg.num_key_value_heads,
                    "flash_attention out= a (B,L,H,D) buffer": True,
                    "layers": cfg.num_hidden_layers},
          "the forward repeats K/V or copies the attention output")

    mask = left_pad_mask(torch, gen, RERANK_B, RERANK_L, dev)
    qwen3_layer_times(torch, model, rp, fa, ids, mask)

    ref = Qwen3LM(dataclasses.replace(cfg, attn_impl="einsum"), device=dev)
    ref.load_state_dict(model.state_dict())
    ref.eval()
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    yes, no = tok.token_id("yes"), tok.token_id("no")
    with torch.inference_mode():
        got = model.last_logits(ids, mask).float()
        ref_ms = cuda_ms(lambda: ref.last_logits(ids, mask), 1)
        want = ref.last_logits(ids, mask).float()
    d_logit = float((got - want).abs().max())
    d_p = float((p_yes(torch, got, yes, no) - p_yes(torch, want, yes, no)).abs().max())
    report(f"kernel path vs einsum path, same weights, left-padded batch "
           f"({int((~mask).sum())} pad slots): max|Δ last logit| = {d_logit:.3e} (bound "
           f"{LOGIT_BOUND}; |logit| up to {float(want.abs().max()):.3f}), max|ΔP(yes)| = "
           f"{d_p:.3e} (bound {P_BOUND}); einsum forward {ref_ms:.1f} ms")
    check(bool(torch.isfinite(got).all()), "non-finite logits on the kernel path")
    check(d_logit <= LOGIT_BOUND and d_p <= P_BOUND, "kernel path strays from the einsum path")
    del got, want

    cfg32 = Qwen3Config(num_hidden_layers=2)
    m32 = init_qwen3(cfg32, SEED + 1, dev)
    r32 = Qwen3LM(dataclasses.replace(cfg32, attn_impl="einsum"), device=dev)
    r32.load_state_dict(m32.state_dict())
    ids32, mask32 = ids[:F32_B, :F32_L], left_pad_mask(torch, gen, F32_B, F32_L, dev)
    with torch.inference_mode():
        d32 = float((m32.last_logits(ids32, mask32) - r32.last_logits(ids32, mask32))
                    .abs().max())
    report(f"f32, {cfg32.num_hidden_layers} layers at full width, B={F32_B} L={F32_L} "
           f"left-padded: max|Δ last logit| kernel vs einsum = {d32:.3e} (bound {F32_BOUND})")
    check(d32 <= F32_BOUND, f"f32 kernel path strays from the einsum path: {d32}")
    del m32, r32
    torch.cuda.empty_cache()
    return model, ref, per_fwd[2]


def rerank_order_inversions(got, ref) -> tuple[int, float]:
    """Pairs of candidates that the two rankings order differently, and
    the largest score gap (in the first ranking) among them."""
    score_a = {d.id: d.metadata["rerank_score"] for d in got}
    pos_b = {d.id: i for i, d in enumerate(ref)}
    n, gap = 0, 0.0
    for i, a in enumerate(got):
        for c in got[i + 1 :]:
            if pos_b[a.id] > pos_b[c.id]:
                n += 1
                gap = max(gap, score_a[a.id] - score_a[c.id])
    return n, gap


def phase_rerank_e2e(torch, rp, fa, dev, store, texts, model, ref) -> tuple[int, int]:
    """``model`` on the kernel path, ``ref`` its einsum-path twin."""
    from rag_arc_tpu_torch.index.vector_store import Document
    from rag_arc_tpu_torch.rerank.cross_encoder import (
        CrossEncoderReranker,
        HashTokenizer,
        pack_prompts,
    )

    phase(f"retrieve -> rerank: top {RERANK_CANDIDATES} of the e2e store for "
          f"{RERANK_QUERIES} query texts, reranked to {K} by the Qwen3 cross-encoder")
    picks = np.random.default_rng(SEED + 6).choice(len(texts), RERANK_QUERIES, replace=False)
    queries = [texts[i] for i in picks]
    hits = store.batch_similarity_search_with_score(queries, k=RERANK_CANDIDATES)
    cands = [[d for d, _ in h] for h in hits]
    check(all(len(c) == RERANK_CANDIDATES for c in cands), "retrieval came back short")
    tok = HashTokenizer(vocab_size=model.cfg.vocab_size)
    rr = CrossEncoderReranker.from_causal_lm(model, None, tok, device=dev)
    rr.rerank_batch(queries[:1], cands[:1], k=K)  # warm up
    torch.cuda.synchronize()

    Counter(rp).reset()
    Counter(fa).reset()
    t0 = time.perf_counter()
    out = rr.rerank_batch(queries, cands, k=K)
    e2e_s = time.perf_counter() - t0
    launches = (rp.launches, fa.launches)
    n_pairs = RERANK_QUERIES * RERANK_CANDIDATES
    ids, mask = rr._encode_bucketed(
        [rr._render(q, d.content) for q, c in zip(queries, cands) for d in c])
    n_rows = pack_prompts(ids, mask, rr.max_length)[0].shape[1]
    packing = (f"prompts packed into {n_rows} rows of {rr.max_length} tokens, "
               f"{100 * mask.sum() / (n_rows * rr.max_length):.1f}% real (rows left-padded "
               f"to the longest, {ids.shape[1]} tokens: {100 * mask.sum() / ids.size:.1f}%)")
    report(f"rerank_batch of {n_pairs} pairs in {e2e_s * 1e3:.1f} ms (host clock, ends in "
           f"the readback) = {n_pairs / e2e_s:.1f} pairs/s; kernel launches rope_prep "
           f"{launches[0]}, flash_attention {launches[1]}")
    check(min(launches) >= model.cfg.num_hidden_layers,
          f"the rerank path launched the kernels {launches} times")
    for q, c, res in zip(queries, cands, out):
        scores = [d.metadata["rerank_score"] for d in res]
        check(len(res) == K and all(isinstance(d, Document) for d in res),
              "rerank did not return k Documents")
        check({d.id for d in res} <= {d.id for d in c}, "a reranked result is not a candidate")
        check(scores == sorted(scores, reverse=True), "results not sorted by rerank_score")
        check(all(0.0 <= s <= 1.0 for s in scores), "a rerank score outside [0, 1]")

    rr_ref = CrossEncoderReranker.from_causal_lm(ref, None, tok, device=dev)
    full = rr.rerank_batch(queries, cands)
    full_ref = rr_ref.rerank_batch(queries, cands)
    n_inv, gap, d_p = 0, 0.0, 0.0
    for a, b in zip(full, full_ref):
        n, g = rerank_order_inversions(a, b)
        n_inv, gap = n_inv + n, max(gap, g)
        ref_score = {d.id: d.metadata["rerank_score"] for d in b}
        d_p = max([d_p] + [abs(x.metadata["rerank_score"] - ref_score[x.id]) for x in a])
    spread = max(a[0].metadata["rerank_score"] - a[-1].metadata["rerank_score"] for a in full)
    report(f"full order vs the einsum path: {n_inv} inverted pairs, widest score gap among "
           f"them {gap:.3e} (bound {2 * P_BOUND}), max|ΔP(yes)| {d_p:.3e} (bound {P_BOUND}); "
           f"widest score spread in a candidate set {spread:.3e}; {packing}")
    check(d_p <= P_BOUND and gap <= 2 * P_BOUND, "rerank order differs beyond the bound")
    del rr_ref, full, full_ref

    default = CrossEncoderReranker(device=dev)
    c = default.cfg
    t0 = time.perf_counter()
    out = default.rerank_batch(queries, cands, k=K)
    default_s = time.perf_counter() - t0
    ok = all(len(r) == K and all(0.0 <= d.metadata["rerank_score"] <= 1.0 for d in r) and
             [d.metadata["rerank_score"] for d in r] ==
             sorted((d.metadata["rerank_score"] for d in r), reverse=True) for r in out)
    report(f"default CrossEncoderReranker() ({c.dim}x{c.depth} causal, vocab {c.vocab_size}, "
           f"seeded weights): rerank_batch of {n_pairs} pairs in {default_s * 1e3:.1f} ms "
           f"(host clock, first call); sorted, scores in [0, 1]: {ok}")
    check(ok, "the default reranker's results are not sorted scores in [0, 1]")
    del default
    torch.cuda.empty_cache()
    return launches


class _Http:
    """One keep-alive connection to a served pipeline. Every response
    other than 200 (and every client error) fails the run."""

    def __init__(self, port: int):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)

    def raw(self, method: str, path: str, body: bytes | None = None) -> bytes:
        self.conn.request(method, path, body, {"Content-Type": "application/json"})
        resp = self.conn.getresponse()
        data = resp.read()
        check(resp.status == 200, f"{method} {path} answered {resp.status}: {data[:300]!r}")
        return data

    def post(self, path: str, payload: dict):
        return json.loads(self.raw("POST", path, json.dumps(payload).encode()))

    def get(self, path: str):
        return json.loads(self.raw("GET", path))

    def close(self) -> None:
        self.conn.close()


@contextlib.contextmanager
def served(pipeline):
    """The app's server (``make_server``, port 0) on a thread; stopped and
    closed on the way out."""
    import threading

    from rag_arc_tpu_torch.serving.app import make_server

    server = make_server(pipeline, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        yield server.server_port
    finally:
        server.shutdown()
        server.server_close()
        thread.join(60)


def batch_ids(body: dict) -> list[list[str]]:
    return [[d["id"] for d in r] for r in body["results"]]


def serve_snapshot_checks(torch, snap: Path, dev, rows: list[dict]):
    """Serve one ingest snapshot through the app's --store path and check
    every endpoint; returns the /batch results (full) of the chunk texts.
    A chunk is found by its (source, text): the two snapshots' ids differ."""
    from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
    from rag_arc_tpu_torch.ops import ivf_scan as isc
    from rag_arc_tpu_torch.ops import subtile_select as ss
    from rag_arc_tpu_torch.serving.app import _pipeline_from_store

    t0 = time.perf_counter()
    pipe = _pipeline_from_store(str(snap), None, K, device=dev)
    pipe.warmup()
    setup_s = time.perf_counter() - t0
    texts = [r["content"] for r in rows]
    index = getattr(getattr(pipe.retriever, "vectorstore", None), "index", None)
    ivf = isinstance(index, DeviceIVFIndex)
    before = (isc.launches, ss.launches)
    with Calls(index, "search_sub") if ivf else contextlib.nullcontext() as dispatches, \
            served(pipe) as port:
        http = _Http(port)
        health = http.get("/health")
        check(health["status"] == "ok", f"/health: {health}")
        one = http.post("/query", {"query": texts[0], "k": K})["documents"]
        check(len(one) == K and texts[0] in [d["content"] for d in one],
              "/query lost its source")
        t0 = time.perf_counter()
        full = http.post("/batch", {"queries": texts, "k": K})
        batch_s = time.perf_counter() - t0
        slim = http.post("/batch", {"queries": texts, "k": K, "response": "ids"})
        got = batch_ids(full)
        check(batch_ids(slim) == got, "response=ids carries other ids than full")
        check(all(set(d) == {"id", "score"} for r in slim["results"] for d in r),
              "response=ids carries more than id and score")
        # the batcher cuts the request into batch_max slices: hold each
        # slice to query_batch over the same slice (a batch of another size
        # rounds the encoder's bf16 differently)
        cap = pipe.batcher.max_batch
        direct = [[d.id for d in r] for i in range(0, len(texts), cap)
                  for r in pipe.query_batch(texts[i : i + cap])]
        check(direct == got, "/batch ids differ from pipeline.query_batch's")
        found = sum((r["metadata"]["source"], r["content"]) in
                    {(d["metadata"]["source"], d["content"]) for d in hits}
                    for r, hits in zip(rows, full["results"]))
        probe = "serve ingest probe " + " ".join(f"zq{i}x" for i in range(12))
        added = http.post("/add", {"texts": [probe], "metadatas": [{"source": "probe"}]})["ids"]
        hit = http.post("/query", {"query": probe, "k": K})["documents"]
        check(hit[0]["id"] == added[0], "an added document is not its own first answer")
        check(http.post("/delete", {"ids": added}) == {"deleted": True}, "/delete failed")
        gone = http.post("/query", {"query": probe, "k": K})["documents"]
        check(added[0] not in [d["id"] for d in gone], "a deleted document still answers")
        stats = http.get("/stats")
        http.close()
    if ivf:  # the dispatches counted here against the kernels' own counts
        got_launches = (isc.launches - before[0], ss.launches - before[1])
        report(f"{snap.name}: {dispatches.n} IVF dispatches served, ivf_scan and "
               f"subtile_select launched {got_launches} times")
        check(got_launches == (dispatches.n, dispatches.n) and dispatches.n > 0,
              f"{snap.name}: {got_launches} scan / select launches for {dispatches.n} "
              "dispatches")
    report(f"{snap.name} snapshot served (--store, {type(pipe.retriever).__name__}, "
           f"set-up {setup_s:.2f} s incl. warm-up): /health /stats /query /batch /add "
           f"/delete all 200; {len(texts)} chunk texts in one /batch {batch_s * 1e3:.1f} ms "
           f"(host clock), own chunk in top {K} {found}/{len(texts)} = "
           f"{found / len(texts):.4f}; /batch ids = query_batch ids; ids = full; add then "
           f"delete seen; batcher {stats['batcher']}")
    check(found >= 0.99 * len(texts), f"only {found}/{len(texts)} chunks found themselves")
    return full["results"]


def run_ingest(torch, ingest, tmp: Path, name: str, extra: list[str]) -> int:
    """tools/ingest.py's main() on tmp/docs into tmp/<name> with the full
    encoder on the card; reports the split and returns the chunk count."""
    import ast
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = ingest.main([str(tmp / "docs"), "-o", str(tmp / name), "--embedder", "torch",
                          "--dim", str(DIM), *extra])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(rc == 0, f"ingest main() returned {rc}")
    stats = dict(line.split(": ", 1) for line in buf.getvalue().splitlines() if ": " in line)
    files, chunks = int(stats["files"]), int(stats["chunks"])
    split = ast.literal_eval(stats["stages_s"])
    report(f"ingest ({name}: {' '.join(extra)}): {files} files -> {chunks} chunks in "
           f"{wall:.2f} s = {files / wall:.1f} files/s, {chunks / wall:.1f} chunks/s (host "
           "clock); split s: " + ", ".join(f"{k} {v}" for k, v in split.items()))
    check(files == len(list((tmp / "docs").iterdir())),
          f"parse_tree parsed {files} files of {tmp / 'docs'}")
    return chunks


def phase_serve_ingest(torch, dev, tmp: Path) -> None:
    """tools/ingest.py's main() (the full 768 x 12 encoder on the card, the
    BM25 twin, bf16), once with the JSON docstore and once with the blob
    docstore, then each snapshot through the app's --store path; then
    dense-only IVF (bf16, nlist ~ sqrt(chunks), trained on every chunk) and
    HNSW (SQ8) ingests of the same files, each served the same way."""
    import importlib.util

    from rag_arc_tpu_torch.tools import ingest
    from rag_arc_tpu_torch.tools.doc_synth import FORMATS, write_corpus

    has_bs4 = importlib.util.find_spec("bs4") is not None
    formats = FORMATS if has_bs4 else tuple(f for f in FORMATS if f != "html")
    phase(f"serve_ingest: {INGEST_FILES} files ({', '.join(formats)}) -> tools/ingest.py "
          f"main() --embedder torch --dim {DIM} --bm25 --dtype bfloat16 (JSON, then blob "
          f"docstore) -> app --store")
    t0 = time.perf_counter()
    written = write_corpus(tmp / "docs", INGEST_FILES, seed=SEED, formats=formats)
    report(f"wrote {len(written)} files in {time.perf_counter() - t0:.2f} s; html "
           + ("written" if has_bs4 else "not written: this machine has no bs4, which "
              "HtmlParser imports when it parses (the CPU tests hold html parsing)"))
    outs = {name: run_ingest(torch, ingest, tmp, name,
                             ["--bm25", "--dtype", "bfloat16", *extra])
            for name, extra in (("json", []), ("blob", ["--blob-docstore"]))}
    check(outs["json"] == outs["blob"], f"the two ingests chunked differently: {outs}")
    rows = json.loads((tmp / "json" / "dense" / "docstore.json").read_text(encoding="utf-8"))
    seen = {Path(r["metadata"]["source"]).suffix.lstrip(".") for r in rows}
    check(seen == set(formats), f"chunks come from formats {sorted(seen)}, not {formats}")
    check(len({r["content"] for r in rows}) == len(rows), "two chunks have the same text")
    pick = np.random.default_rng(SEED + 7).choice(len(rows), INGEST_QUERIES, replace=False)
    rows = [rows[i] for i in pick]
    res_json = serve_snapshot_checks(torch, tmp / "json", dev, rows)
    res_blob = serve_snapshot_checks(torch, tmp / "blob", dev, rows)

    def keyed(results):
        return [[(d["metadata"]["source"], d["content"]) for d in r] for r in results]

    same = keyed(res_blob) == keyed(res_json)
    report(f"the blob snapshot serves the JSON snapshot's documents in the same order: {same}")
    check(same, "the blob snapshot serves other answers than the JSON one")
    chunks = outs["json"]
    nlist = int(round(chunks ** 0.5))
    for name, extra in (("ivf", ["--index-type", "ivf", "--nlist", str(nlist), "--batch",
                                 str(chunks), "--dtype", "bfloat16"]),
                        ("hnsw", ["--index-type", "hnsw", "--dtype", "int8"])):
        check(run_ingest(torch, ingest, tmp, name, extra) == chunks,
              f"the {name} ingest chunked differently")
        manifest = json.loads((tmp / name / "dense" / "manifest.json").read_text())
        check(manifest["index_kind"] == name, f"the {name} snapshot holds {manifest}")
        serve_snapshot_checks(torch, tmp / name, dev, rows)


def load_pass(port: int, bodies: list[list[bytes]]) -> dict:
    """SERVE_CLIENTS threads, each on its own keep-alive connection, send
    their pre-serialized /batch bodies in turn; every 8th answer parsed."""
    import http.client
    import threading

    errors, latencies = [], []

    def client(mine: list[bytes]) -> None:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        try:
            for r, body in enumerate(mine):
                t1 = time.perf_counter()
                conn.request("POST", "/batch", body, {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    errors.append(f"status {resp.status}: {data[:200]!r}")
                    return
                if r % 8 == 0 and len(json.loads(data)["results"]) != SERVE_QPR:
                    errors.append("short /batch answer")
                    return
                latencies.append(time.perf_counter() - t1)
        except Exception as exc:  # noqa: BLE001 — the run fails on any client error
            errors.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=client, args=(b,)) for b in bodies]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    check(not errors, f"{len(errors)} client errors, first: {errors[:1]}")
    lat = np.asarray(latencies) * 1e3
    n_q = sum(len(b) for b in bodies) * SERVE_QPR
    return {"qps": n_q / wall, "wall_s": wall, "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)), "requests": len(latencies)}


def coalesced_split(torch, sm, ss, store, texts: list[str]) -> None:
    """Device time of one coalesced B=512 batch, layer by layer (CUDA
    events), beside the host's tokenize, resolve and JSON times."""
    from rag_arc_tpu_torch.index.flat import fetch_pair
    from rag_arc_tpu_torch.ops.topk import masked_topk
    from rag_arc_tpu_torch.ops.two_level import prepare_queries, select_rescore
    from rag_arc_tpu_torch.serving.app import _doc_ids_json, _doc_json

    emb, index = store.embedding, store.index
    t0 = time.perf_counter()
    ids, mask = emb.tokenizer.batch_encode([t.replace("\n", " ") for t in texts])
    length = emb._bucket_len(ids.shape[1])
    ids = np.pad(ids, ((0, 0), (0, length - ids.shape[1])))
    mask = np.pad(mask, ((0, 0), (0, length - mask.shape[1])))
    tok_ms = (time.perf_counter() - t0) * 1e3
    ids_d, mask_d = torch.from_numpy(ids).to(store.device), torch.from_numpy(mask).to(store.device)
    q = emb.encode_device(ids_d, mask_d)
    qc = prepare_queries(q, index.dtype, "cosine")
    sub = sm.subtile_max(qc, index.emb, index.valid, G)
    enc = cuda_ms(lambda: emb.encode_device(ids_d, mask_d), 5)
    search = cuda_ms(lambda: index.search_device(q, K), 5)
    prod = cuda_ms(lambda: sm.subtile_max(qc, index.emb, index.valid, G), 5)
    sel = cuda_ms(lambda: ss.iterative_argmax_resid(sub, K), 5)
    sel_res = cuda_ms(lambda: select_rescore(qc, index.emb, index.valid, sub, K, G), 5)
    # the largest batch whose score matrix fits SCORE_BYTES_BUDGET: the
    # direct path's (masked_topk) time there, which the card no longer takes
    b_direct = 1 << (index.SCORE_BYTES_BUDGET // (4 * index.capacity)).bit_length() - 1
    direct = cuda_ms(lambda: masked_topk(q[:b_direct], index.emb, index.valid, K), 5)
    two_level = cuda_ms(lambda: index.search_device(q[:b_direct], K), 5)
    scores, positions = fetch_pair(*index.search_device(q, K))
    t0 = time.perf_counter()
    hits = [store._resolve(s, p) for s, p in zip(scores, positions)]
    resolve_ms = (time.perf_counter() - t0) * 1e3
    docs = [[d for d, _ in h] for h in hits]
    t0 = time.perf_counter()
    json.dumps({"results": [[_doc_ids_json(d) for d in r] for r in docs]})
    ids_json_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    json.dumps({"results": [[_doc_json(d) for d in r] for r in docs]}, ensure_ascii=False)
    full_json_ms = (time.perf_counter() - t0) * 1e3
    report(f"one coalesced batch B={len(texts)} L={length}, device (CUDA events, mean of 5): "
           f"encode {enc:.3f} ms, search {search:.3f} ms = producer {prod:.3f} + select "
           f"{sel:.3f} + rescore {sel_res - sel:.3f} (select + rescore {sel_res:.3f} less the "
           f"select) + query prep; at B={b_direct} the two-level search {two_level:.3f} ms, "
           f"the direct path's masked_topk {direct:.3f} ms; host: "
           f"tokenize {tok_ms:.2f} ms, resolve {resolve_ms:.2f} ms, JSON ids {ids_json_ms:.2f} "
           f"ms / full {full_json_ms:.2f} ms")


def phase_serve_2m(torch, sm, ss, dev, data, emb, tmp: Path):
    """tools/serving_bench.py's configuration through the app. Returns the
    store (its documents in a BlobDocstore)."""
    from rag_arc_tpu_torch.index.vector_store import Document, TorchVectorStore
    from rag_arc_tpu_torch.ops.mmr import mmr_select
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    phase(f"serve_2m: {CORPUS_N} x {DIM} bf16 (documents in a BlobDocstore), the "
          f"{emb.cfg.dim}x{emb.cfg.depth} encoder on the card chained into the search, "
          f"RagPipeline(batch_max={SERVE_BATCH_MAX}, batch_wait_ms={SERVE_WAIT_MS}) behind "
          f"make_server; {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests x {SERVE_QPR} "
          f"queries, k={K}")
    t0 = time.perf_counter()
    store = TorchVectorStore(emb, dim=DIM, metric="cosine", capacity=CORPUS_N,
                             dtype=torch.bfloat16, docstore_path=str(tmp / "serve_2m_docs"),
                             device=dev)
    corpus, step = data["corpus"], 1 << 17
    for start in range(0, CORPUS_N, step):  # injected as tools/serving_bench.py does
        positions = store.index.add(corpus[start : start + step])
        store.docstore.add([Document(content=f"doc {int(p)}", id=f"d{int(p)}")
                            for p in positions], positions.tolist())
    torch.cuda.synchronize()
    report(f"corpus injected in {time.perf_counter() - t0:.1f} s (the index phase's rows; "
           f"{len(store)} documents in the blob docstore)")
    check(len(store) == CORPUS_N, f"the store holds {len(store)} documents")
    pipe = RagPipeline(store.as_retriever(search_kwargs={"k": K}), top_k=K,
                       batch_max=SERVE_BATCH_MAX, batch_wait_ms=SERVE_WAIT_MS)
    t0 = time.perf_counter()
    pipe.warmup(batch_sizes=[1 << i for i in range(SERVE_BATCH_MAX.bit_length())])
    report(f"warm-up (every pow2 batch up to {SERVE_BATCH_MAX}) {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED + 8)

    def request(cid: int, r: int) -> list[str]:
        return [f"client {cid} request {r} query {j} term {rng.integers(1_000_000)}"
                for j in range(SERVE_QPR)]

    queries = [[request(c, r) for r in range(SERVE_REQUESTS)] for c in range(SERVE_CLIENTS)]
    sizes: list[int] = []  # the size of every batch the batcher hands the pipeline
    answer = pipe.batcher.batch_fn

    def recorded(batch, **kwargs):
        sizes.append(len(batch))
        return answer(batch, **kwargs)

    pipe.batcher.batch_fn = recorded
    bodies = {mode: [[json.dumps({"queries": q, "k": K, "response": mode}).encode()
                      for q in per] for per in queries] for mode in ("ids", "full")}
    with served(pipe) as port:
        http = _Http(port)
        solo = []
        for i in range(SERVE_SOLO):
            t1 = time.perf_counter()
            out = http.post("/batch", {"queries": [f"solo latency probe {i}"], "k": K})
            solo.append(time.perf_counter() - t1)
            check(len(out["results"]) == 1 and len(out["results"][0]) == K, "short solo answer")
        sl = np.asarray(solo[SERVE_SOLO_DROP:]) * 1e3
        report(f"single-query latency over HTTP ({SERVE_SOLO} solo requests, the first "
               f"{SERVE_SOLO_DROP} dropped): p50 {np.percentile(sl, 50):.2f} ms, p95 "
               f"{np.percentile(sl, 95):.2f} ms, min {sl.min():.2f} ms (host clock)")
        sample = [q for per in queries[:8] for q in per[0]]
        served_ids = batch_ids(http.post("/batch", {"queries": sample, "k": K}))
        with uncounted(sm, ss):
            direct = [[d.id for d, _ in h]
                      for h in store.batch_similarity_search_with_score(sample, k=K)]
        report(f"one /batch of {len(sample)} texts: ids equal to "
               f"batch_similarity_search_with_score's: {served_ids == direct}")
        check(served_ids == direct, "served ids differ from the direct search's")
        before_load = (sm.launches, ss.launches)
        qps, n_batches = {}, 0
        for mode in ["ids"] * SERVE_IDS_PASSES + ["full"]:
            before = dict(pipe.batcher.stats)
            pipe.batcher.stats["max_batch_seen"] = 0
            sizes.clear()
            out = load_pass(port, bodies[mode])
            after = pipe.batcher.stats
            qps.setdefault(mode, []).append(out["qps"])
            n_batches += len(sizes)
            report(f"response={mode}: {out['qps']:.1f} QPS ({out['requests']} requests of "
                   f"{SERVE_QPR} in {out['wall_s']:.2f} s, host clock), request p50 "
                   f"{out['p50_ms']:.1f} ms, p95 {out['p95_ms']:.1f} ms; batcher "
                   f"{after['batches'] - before['batches']} batches, max_batch_seen "
                   f"{after['max_batch_seen']}, sizes p50 {np.percentile(sizes, 50):.0f} / "
                   f"mean {np.mean(sizes):.1f}")
        pipe.batcher.batch_fn = answer
        launches = (sm.launches - before_load[0], ss.launches - before_load[1])
        spread = (max(qps["ids"]) - min(qps["ids"])) / min(qps["ids"])
        report(f"the {SERVE_IDS_PASSES} ids passes within {100 * spread:.1f}% of the lowest "
               f"({'within' if spread <= 0.10 else 'NOT within'} 10%); kernel launches over "
               f"the load: subtile_max {launches[0]}, subtile_select {launches[1]}, against "
               f"{n_batches} batches (each on the two-level path; reported, not held)")
        check(min(launches) > 0, "the served traffic never reached the kernels")
        stats = http.get("/stats")
        http.close()
    report(f"pipeline stats: {stats['queries']} queries, {stats['mean_ms_per_query']:.3f} ms "
           f"mean per query (host); stage timings " + ", ".join(
               f"{k} {v['mean_ms']:.2f} ms" for k, v in sorted(stats["stage_timings"].items())
               if k.startswith(("pipeline", "store"))))
    with uncounted(sm, ss):
        coalesced_split(torch, sm, ss, store, [q for per in queries[:8] for q in per[1]])

    mmr = store.as_retriever(search_type="mmr", search_kwargs={"k": 4, "fetch_k": 20})
    texts = [q for q in queries[0][2][:SERVE_MMR_QUERIES]]
    same = 0
    for text in texts:
        got = [d.id for d in mmr.invoke(text)]
        q = emb.encode([text])
        _, pos = store.index.search(q, 20)
        cand = pos[0][pos[0] >= 0]
        want = [store.docstore.get_by_position(int(cand[i])).id
                for i in mmr_select(q[0], store.index.take(cand), k=4)]
        same += got == want
    report(f"MMR (k 4, fetch_k 20) on {len(texts)} texts: ids equal to mmr_select over the "
           f"store's own top 20 and its take: {same}/{len(texts)}")
    check(same == len(texts), "MMR ids differ from mmr_select's")
    return store


def phase_serve_rerank(torch, rp, fa, dev, store, model) -> int:
    """Requests through ``RagPipeline`` and the app with the Qwen3
    cross-encoder; returns the ``add_rms_norm`` launches a forward, as
    counted on every request."""
    from rag_arc_tpu_torch.ops import rms_norm as rn
    from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker, HashTokenizer
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    phase(f"serve_rerank: RagPipeline(serve_2m's retriever, the Qwen3 "
          f"{model.cfg.num_hidden_layers}x{model.cfg.hidden_size} cross-encoder, recall_k "
          f"{RERANK_CANDIDATES}, top_k {K}) behind make_server; {SERVE_RERANK_REQUESTS} "
          f"/batch requests of {SERVE_RERANK_QPR} queries")
    layers = model.cfg.num_hidden_layers
    rr = CrossEncoderReranker.from_causal_lm(
        model, None, HashTokenizer(vocab_size=model.cfg.vocab_size), device=dev)
    retriever = store.as_retriever(search_kwargs={"k": K})
    pipe = RagPipeline(retriever, reranker=rr, recall_k=RERANK_CANDIDATES, top_k=K,
                       batch_max=SERVE_BATCH_MAX, batch_wait_ms=SERVE_WAIT_MS)
    pipe.warmup(batch_sizes=(SERVE_RERANK_QPR,))
    rng = np.random.default_rng(SEED + 9)
    times, forwards = [], []
    # the decoder stack, once a packed forward
    with served(pipe) as port, Calls(model, "_trunk") as calls:
        http = _Http(port)
        for r in range(SERVE_RERANK_REQUESTS):
            queries = [f"rerank request {r} query {j} doc {rng.integers(CORPUS_N)}"
                       for j in range(SERVE_RERANK_QPR)]
            before = (rp.launches, fa.launches, rn.launches, calls.n)
            t0 = time.perf_counter()
            out = http.post("/batch", {"queries": queries, "k": K})["results"]
            times.append((time.perf_counter() - t0) * 1e3)
            # the forwards the model ran for this request, counted here
            n_fwd = calls.n - before[3]
            launches = (rp.launches - before[0], fa.launches - before[1],
                        rn.launches - before[2])
            check(n_fwd > 0 and launches == (layers * n_fwd, layers * n_fwd,
                                             (2 * layers + 1) * n_fwd),
                  f"request {r}: rope_prep / flash_attention / add_rms_norm launched "
                  f"{launches} times for {n_fwd} forwards, not {layers}, {layers} and "
                  f"{2 * layers + 1} a forward")
            forwards.append(n_fwd)
            norm_per_fwd = launches[2] // n_fwd
            with uncounted(rp, fa, rn):
                cands = retriever.invoke_batch(queries, k=RERANK_CANDIDATES)
                want = rr.rerank_batch(queries, cands, k=K)
            for got, c, w in zip(out, cands, want):
                scores = [d["metadata"]["rerank_score"] for d in got]
                check(len(got) == K, "a short reranked answer")
                check({d["id"] for d in got} <= {d.id for d in c},
                      "a reranked answer is not among the retrieved 50")
                check(scores == sorted(scores, reverse=True), "answers not sorted by rerank_score")
                check([d["id"] for d in got] == [d.id for d in w],
                      "the served order differs from rerank_batch's on the same candidates")
        http.close()
    report(f"{SERVE_RERANK_REQUESTS} requests of {SERVE_RERANK_QPR} queries x "
           f"{RERANK_CANDIDATES} candidates: " + ", ".join(f"{t:.1f}" for t in times)
           + f" ms each (host clock; {np.mean(times[1:]):.1f} ms mean past the first); "
           f"forwards per request {forwards}, rope_prep and flash_attention {layers} launches "
           f"each a forward, add_rms_norm {norm_per_fwd}; every answer a sorted subset of "
           f"the retrieved {RERANK_CANDIDATES} in rerank_batch's order")
    return norm_per_fwd


def lfm2_segments(rng, rows: int, row_len: int):
    """(rows, row_len) int32 segment ids of pairs packed as the reranker
    packs NQ prompts: 60-230 tokens each, laid end to end, the last one cut
    to the row's room, a tail too short for a pair −1."""
    seg = np.full((rows, row_len), -1, dtype=np.int32)
    for r in range(rows):
        col = s = 0
        while True:
            n = int(rng.integers(LFM2_PAIR_TOKENS[0], LFM2_PAIR_TOKENS[1] + 1))
            if col + n > row_len:  # the row's last pair takes what is left
                n = row_len - col
                if n < LFM2_PAIR_TOKENS[0]:
                    break
            seg[r, col:col + n] = s
            col, s = col + n, s + 1
    return seg


def lfm2_kernels(torch, sc, moe, dev) -> dict:
    """The short conv, the SwiGLU pass and the whole expert FFN against
    their plain versions at LFM2-8B-A1B's widths on one served chunk of
    packed rows, then timed in turns beside their bounds."""
    rng = np.random.default_rng(SEED + 16)
    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    h, inter, n_exp, top_k = 2048, 1792, 32, 4
    seg = torch.from_numpy(lfm2_segments(rng, LFM2_ROWS, LFM2_ROW_LEN)).to(dev)
    live = int((seg >= 0).sum())
    out = {}

    bcx = torch.randn(LFM2_ROWS, LFM2_ROW_LEN, 3 * h, generator=gen, device=dev).bfloat16()
    w = (torch.randn(h, 3, generator=gen, device=dev) / 3 ** 0.5).bfloat16()
    got, want = sc.short_conv(bcx, w, seg), sc.short_conv_plain(bcx, w, seg)
    d = float((got.float() - want.float()).abs().max())
    report(f"short_conv, {LFM2_ROWS} rows x {LFM2_ROW_LEN} ({live} live tokens), H={h}: "
           f"max|kernel - plain| {d:.3e} (one bf16 step of |y| <= "
           f"{float(want.float().abs().max()):.2f} allowed)")
    check(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
          "short_conv strays from its plain version")
    check(bool((got[seg < 0] == 0).all()), "short_conv wrote non-zero padding")
    nbytes = live * 4 * h * 2
    t = in_turns(lambda: sc.short_conv(bcx, w, seg), lambda: sc.short_conv_plain(bcx, w, seg),
                 "short_conv", live * 4 * h, "TFLOP/s", nbytes, "of B, C, x read and y written")
    out["short_conv"] = {**t, **bound(live * 4 * h, H100_BF16_PEAK, nbytes)}
    del bcx, got, want

    x = torch.randn(LFM2_ROWS * LFM2_ROW_LEN, h, generator=gen, device=dev).bfloat16()
    gate = (0.02 * torch.randn(n_exp, h, generator=gen, device=dev)).bfloat16()
    bias = 0.05 * torch.randn(n_exp, generator=gen, device=dev)
    gateup = (0.02 * torch.randn(n_exp, 2 * inter, h, generator=gen, device=dev)).bfloat16()
    down = (0.02 * torch.randn(n_exp, h, inter, generator=gen, device=dev)).bfloat16()
    r = moe.moe_route(x, gate, bias, top_k, live=(seg >= 0).reshape(-1))
    rows = live * top_k
    check(int(r.offsets[-1]) == rows, "moe_route routed padding or lost live tokens")

    gu = 3 * torch.randn(r.token.numel(), 2 * inter, generator=gen, device=dev).bfloat16()
    n_live = r.offsets[-1:]
    got, want = moe.swiglu(gu, r.weight, n_live)[:rows], moe.swiglu_plain(gu, r.weight, n_live)[:rows]
    d = float((got.float() - want.float()).abs().max())
    report(f"moe swiglu, {rows} rows x I={inter}: max|kernel - plain| {d:.3e} (one bf16 step)")
    check(torch.allclose(got.float(), want.float(), rtol=8e-3, atol=1e-6),
          "the SwiGLU pass strays from its plain version")
    nbytes = rows * (3 * inter * 2 + 4)
    t = in_turns(lambda: moe.swiglu(gu, r.weight, n_live),
                 lambda: moe.swiglu_plain(gu, r.weight, n_live), "moe swiglu",
                 rows * inter * 6, "TFLOP/s", nbytes, "of g, u, w read and h written")
    out["moe_swiglu"] = {**t, **bound(rows * inter * 6, H100_BF16_PEAK, nbytes)}
    del gu, got, want

    got = moe.moe_experts(x, r, gateup, down)
    want = moe.moe_experts_plain(x, r, gateup, down)
    scale = float(want.float().abs().max())
    d = float((got.float() - want.float()).abs().max())
    report(f"moe_experts (gather, torch._grouped_mm, swiglu, torch._grouped_mm, combine), "
           f"{live} tokens x top {top_k} of {n_exp}, H={h} I={inter}: max|card - plain loop| "
           f"{d:.3e} against |y| <= {scale:.3f} (bound 2e-2 of it: a few bf16 steps)")
    check(d <= 2e-2 * scale, "moe_experts strays from the plain expert loop")
    check(bool((got[seg.reshape(-1) < 0] == 0).all()), "moe_experts wrote non-zero padding")
    ops = 6.0 * h * inter * rows
    nbytes = 3 * n_exp * h * inter * 2 + 2 * live * h * 2
    t = in_turns(lambda: moe.moe_experts(x, r, gateup, down),
                 lambda: moe.moe_experts_plain(x, r, gateup, down), "moe_experts", ops,
                 "TFLOP/s", nbytes, "of expert weights, x and y")
    out["moe_experts"] = {**t, **bound(ops, H100_BF16_PEAK, nbytes)}
    for name, row in out.items():
        report(f"{name}: {row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
               f"({row['bound_by']}; share {row['bound_ms'] / row['ms']:.2f})")
    del x, gateup, down, got, want
    torch.cuda.empty_cache()
    return out


def phase_lfm2(torch, sc, moe, rp, fa, dev) -> dict:
    """LFM2-8B-A1B at its published widths (seeded bf16 weights) as the
    served cross-encoder: the new kernels held against their plain versions
    at the served shapes, then requests through ``RagPipeline`` and the app
    on the packed path with every new kernel's launches counted a forward.
    Returns the kernel rows' numbers."""
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.lfm2_moe import Lfm2MoeConfig, init_lfm2_moe
    from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings
    from rag_arc_tpu_torch.ops import rms_norm as rn
    from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    cfg = Lfm2MoeConfig(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    n_conv = cfg.layer_types.count("conv")
    n_attn = cfg.num_hidden_layers - n_conv
    phase(f"lfm2: LFM2-8B-A1B ({cfg.num_hidden_layers} layers: {n_conv} short conv, {n_attn} "
          f"attention {cfg.num_attention_heads}/{cfg.num_key_value_heads}x{cfg.head_dim}; "
          f"{cfg.moe_layers} MoE of {cfg.num_experts} experts, top {cfg.num_experts_per_tok}), "
          f"bf16; kernels at {LFM2_ROWS} packed rows of {LFM2_ROW_LEN}, then served over "
          f"{LFM2_DOCS} passages, recall {LFM2_RECALL}")
    out = lfm2_kernels(torch, sc, moe, dev)

    rng = np.random.default_rng(SEED + 17)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, n)) for n in rng.integers(3, 11, DOC_VOCAB)]
    lens = np.minimum(rng.lognormal(np.log(LFM2_PASSAGE_WORDS), 0.5, LFM2_DOCS).astype(int) + 8,
                      200)
    texts = [" ".join(rng.choice(words, n)) for n in lens]
    emb = TorchEncoderEmbeddings(TransformerConfig(), seed=SEED, device=dev)
    store = TorchVectorStore.from_texts(texts, emb, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    model = init_lfm2_moe(cfg, SEED, dev)
    torch.cuda.synchronize()
    report(f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B parameters made on the "
           f"card in {time.perf_counter() - t0:.1f} s")
    rr = CrossEncoderReranker.from_causal_lm(
        model, None, HashTokenizer(vocab_size=cfg.vocab_size, max_len=LFM2_ROW_LEN), device=dev)
    retriever = store.as_retriever(search_kwargs={"k": K})
    pipe = RagPipeline(retriever, reranker=rr, recall_k=LFM2_RECALL, top_k=K,
                       batch_max=SERVE_BATCH_MAX, batch_wait_ms=SERVE_WAIT_MS)
    pipe.warmup(batch_sizes=(1,))
    counters = [Counter(m) for m in (sc, moe, rp, fa, rn)]
    want_each = (n_conv, cfg.moe_layers, n_attn, n_attn, 2 * cfg.num_hidden_layers + 1)
    times = []
    with served(pipe) as port, Calls(model, "_trunk") as calls, \
            Calls(model, "last_logits_packed") as packed:
        http = _Http(port)
        for i in range(LFM2_REQUESTS):
            query = " ".join(rng.choice(words, 9))
            for c in counters:
                c.reset()
            before = calls.n
            t0 = time.perf_counter()
            got = http.post("/batch", {"queries": [query], "k": K})["results"][0]
            times.append((time.perf_counter() - t0) * 1e3)
            n_fwd = calls.n - before
            launches = tuple(c.read() for c in counters)
            check(n_fwd > 0 and launches == tuple(n * n_fwd for n in want_each),
                  f"request {i}: short_conv / moe / rope_prep / flash_attention / add_rms_norm "
                  f"launched {launches} times for {n_fwd} forwards, not {want_each} each a "
                  f"forward")
            per_fwd = tuple(n // n_fwd for n in launches)
            with uncounted(sc, moe, rp, fa, rn):
                cands = retriever.invoke_batch([query], k=LFM2_RECALL)[0]
            scores = [d["metadata"]["rerank_score"] for d in got]
            check(len(got) == K and scores == sorted(scores, reverse=True)
                  and all(0.0 <= s <= 1.0 for s in scores), "a short or unsorted answer")
            check({d["id"] for d in got} <= {d.id for d in cands},
                  f"an answer is not among the retrieved {LFM2_RECALL}")
        http.close()
    check(packed.n == calls.n, f"{calls.n - packed.n} forwards left the packed path")
    report(f"{LFM2_REQUESTS} single-query requests x {LFM2_RECALL} candidates: "
           + ", ".join(f"{t:.1f}" for t in times) + f" ms each (host clock; "
           f"{np.mean(times[1:]):.1f} ms mean past the first), every forward packed; "
           f"launches a forward: short_conv {per_fwd[0]}, moe swiglu {per_fwd[1]}, rope_prep "
           f"{per_fwd[2]}, flash_attention {per_fwd[3]}, add_rms_norm {per_fwd[4]}")
    out["short_conv"]["launches"] = per_fwd[0]
    out["moe_swiglu"]["launches"] = out["moe_experts"]["launches"] = per_fwd[1]
    out["add_rms_norm_launches"] = per_fwd[4]
    del pipe, rr, model, store, emb
    torch.cuda.empty_cache()
    return out


def ssd_state_errors(torch, scan, ref_granite, args, kw) -> dict:
    """The scan's state readout (D = 0) against the f32 token recurrence
    (``bench_torch/reference/granite_hybrid.py::ssd_packed``), the worst
    head's relative L2 error over the live tokens, beside the same
    recurrence with its state held in bf16 (a control that must fail)."""
    xbc, step, a_log, dt_bias, _, seg = args
    heads, p_, n_ = kw["heads"], kw["head_dim"], kw["d_state"]
    d0 = torch.zeros(heads, device=xbc.device)
    live = seg >= 0

    def worst(got, want):
        e = (got.float() - want)[live].reshape(-1, heads, p_)
        w = want[live].reshape(e.shape)
        return float((e.norm(dim=(0, 2)) / w.norm(dim=(0, 2))).max())

    got = scan.ssd_scan(xbc, step, a_log, dt_bias, d0, seg, **kw)
    want = ref_granite.ssd_packed(xbc, step, a_log, dt_bias, d0, seg, heads, p_, n_)
    held16 = ref_granite.ssd_packed(xbc, step, a_log, dt_bias, d0, seg, heads, p_, n_,
                                    torch.bfloat16)
    err, control = worst(got, want), worst(held16.to(torch.bfloat16), want)
    report(f"ssd_scan's state readout (D = 0) against the f32 token recurrence, the worst "
           f"head's relative L2 error: kernel {err:.5f}, a bf16 state {control:.5f} (limit "
           f"{SSD_STATE_TOL})")
    check(err < SSD_STATE_TOL, "ssd_scan strays from the f32 recurrence")
    check(control > SSD_STATE_TOL, "a bf16 state passes the scan's limit: it cannot tell")
    return {"state_err": err, "bf16_state_err": control}


def granite_kernels(torch, sc, scan, rn, moe, dev) -> dict:
    """The Mamba conv, the scan, the gated norm and the held experts' FFN
    against their plain versions at granite-4.0-h-small's widths on one
    served chunk of packed rows (the conv, scan and norm reading their
    columns of one (rows, 512, 16,768) projection, as the model passes
    them), then timed in turns beside their bounds."""
    from bench_torch.reference import granite_hybrid as ref_granite
    from rag_arc_tpu_torch.models.granite_hybrid import GraniteHybridConfig

    cfg = GraniteHybridConfig()
    rng = np.random.default_rng(SEED + 21)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    h, inner, conv, heads = cfg.hidden_size, cfg.mamba_inner, cfg.conv_dim, cfg.mamba_n_heads
    p_, n_ = cfg.mamba_d_head, cfg.mamba_d_state
    seg = torch.from_numpy(lfm2_segments(rng, LFM2_ROWS, LFM2_ROW_LEN)).to(dev)
    live = int((seg >= 0).sum())
    out = {}

    proj = torch.randn(LFM2_ROWS, LFM2_ROW_LEN, cfg.in_proj_dim, generator=gen,
                       device=dev).bfloat16()
    z, v, step = proj[..., :inner], proj[..., inner:inner + conv], proj[..., inner + conv:]
    w = (torch.randn(conv, cfg.mamba_d_conv, generator=gen, device=dev) / 2).bfloat16()
    b = (0.02 * torch.randn(conv, generator=gen, device=dev)).bfloat16()
    got, want = sc.mamba_conv(v, w, b, seg), sc.mamba_conv_plain(v, w, b, seg)
    d = float((got.float() - want.float()).abs().max())
    report(f"mamba_conv, {LFM2_ROWS} rows x {LFM2_ROW_LEN} ({live} live tokens), C={conv}: "
           f"max|kernel - plain| {d:.3e} (one bf16 step of |y| <= "
           f"{float(want.float().abs().max()):.2f} allowed)")
    check(torch.allclose(got.float(), want.float(), rtol=1e-2, atol=1e-2),
          "mamba_conv strays from its plain version")
    check(bool((got[seg < 0] == 0).all()), "mamba_conv wrote non-zero padding")
    nbytes = live * 2 * conv * 2
    t = in_turns(lambda: sc.mamba_conv(v, w, b, seg), lambda: sc.mamba_conv_plain(v, w, b, seg),
                 "mamba_conv", live * 2 * 4 * conv, "TFLOP/s", nbytes,
                 "of xBC read and written")
    out["mamba_conv"] = {**t, **bound(live * 2 * 4 * conv, H100_BF16_PEAK, nbytes)}

    xbc = got
    a_log = torch.log(1 + 15 * torch.rand(heads, generator=gen, device=dev))
    u = torch.rand(heads, generator=gen, device=dev)
    dt0 = torch.exp(np.log(0.001) + (np.log(0.1) - np.log(0.001)) * u)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    d_skip = torch.ones(heads, device=dev)
    args = (xbc, step, a_log, dt_bias, d_skip, seg)
    kw = dict(heads=heads, head_dim=p_, d_state=n_)
    got, want = scan.ssd_scan(*args, **kw), scan.ssd_scan_plain(*args, **kw)
    scale = float(want.float().abs().max())
    d = float((got.float() - want.float()).abs().max())
    report(f"ssd_scan, {heads} heads x {p_}, state {n_}, chunks of {scan.CHUNK}: "
           f"max|kernel - plain| {d:.3e} against |y| <= {scale:.3f} (bound 1e-2 of it: bf16 "
           f"product operands, one bf16 rounding)")
    check(d <= 1e-2 * scale, "ssd_scan strays from its plain version")
    check(bool((got[seg < 0] == 0).all()), "ssd_scan wrote non-zero padding")
    state_err = ssd_state_errors(torch, scan, ref_granite, args, kw)
    ops = live * 5.0 * heads * p_ * n_
    nbytes = live * (2 * inner + 2 * n_ + heads) * 2
    t = in_turns(lambda: scan.ssd_scan(*args, **kw), lambda: scan.ssd_scan_plain(*args, **kw),
                 "ssd_scan", ops, "TFLOP/s", nbytes, "of x, B, C, dt read and y written")
    out["ssd_scan"] = {**t, **bound(ops, H100_BF16_PEAK, nbytes), **state_err}

    y = got
    nw = (1 + 0.02 * torch.randn(inner, generator=gen, device=dev)).bfloat16()
    got, want = rn.gated_rms_norm(y, z, nw, 1e-5), rn.gated_rms_norm_plain(y, z, nw, 1e-5)
    d = float((got.float() - want.float()).abs().max())
    report(f"gated_rms_norm, {LFM2_ROWS * LFM2_ROW_LEN} rows x {inner}: max|kernel - plain| "
           f"{d:.3e} (one bf16 step)")
    check(torch.allclose(got.float(), want.float(), rtol=8e-3, atol=1e-6),
          "gated_rms_norm strays from its plain version")
    rows_all = LFM2_ROWS * LFM2_ROW_LEN
    nbytes = rows_all * 3 * inner * 2
    t = in_turns(lambda: rn.gated_rms_norm(y, z, nw, 1e-5),
                 lambda: rn.gated_rms_norm_plain(y, z, nw, 1e-5), "gated_rms_norm",
                 rows_all * 8 * inner, "TFLOP/s", nbytes, "of y, z read and written")
    out["gated_rms_norm"] = {**t, **bound(rows_all * 8 * inner, H100_BF16_PEAK, nbytes)}
    del proj, z, v, step, xbc, y, got, want

    lo, hi = GRANITE_HELD
    n_exp, inter, top_k = cfg.num_local_experts, cfg.intermediate_size, cfg.num_experts_per_tok
    x = torch.randn(rows_all, h, generator=gen, device=dev).bfloat16()
    router = (0.02 * torch.randn(n_exp, h, generator=gen, device=dev)).bfloat16()
    gateup = (0.02 * torch.randn(hi - lo, 2 * inter, h, generator=gen, device=dev)).bfloat16()
    down = (0.02 * torch.randn(hi - lo, h, inter, generator=gen, device=dev)).bfloat16()
    r = moe.moe_route(x, router, None, top_k, scoring="softmax", held=GRANITE_HELD,
                      live=(seg >= 0).reshape(-1))
    held_rows = int(r.offsets[-1])
    check(0 < held_rows < live * top_k, "moe_route held every assignment or none")
    got = moe.moe_experts(x, r, gateup, down)
    want = moe.moe_experts_plain(x, r, gateup, down)
    scale = float(want.float().abs().max())
    d = float((got.float() - want.float()).abs().max())
    report(f"held experts (gather, torch._grouped_mm, swiglu, torch._grouped_mm, combine), "
           f"{live} tokens x top {top_k} of {n_exp}, experts {lo}-{hi - 1} held ({held_rows} "
           f"assignments), H={h} I={inter}: max|card - plain loop| {d:.3e} against |y| <= "
           f"{scale:.3f} (bound 2e-2 of it: a few bf16 steps)")
    check(d <= 2e-2 * scale, "the held experts' FFN strays from the plain expert loop")
    check(bool((got[seg.reshape(-1) < 0] == 0).all()), "moe_experts wrote non-zero padding")
    ops = 6.0 * h * inter * held_rows
    nbytes = 3 * (hi - lo) * h * inter * 2 + 2 * live * h * 2
    t = in_turns(lambda: moe.moe_experts(x, r, gateup, down),
                 lambda: moe.moe_experts_plain(x, r, gateup, down), "held experts", ops,
                 "TFLOP/s", nbytes, "of held expert weights, x and y")
    out["moe_experts_held"] = {**t, **bound(ops, H100_BF16_PEAK, nbytes)}
    for name, row in out.items():
        report(f"{name}: {row['ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
               f"({row['bound_by']}; share {row['bound_ms'] / row['ms']:.2f})")
    del x, router, gateup, down, got, want
    torch.cuda.empty_cache()
    return out


def phase_granite(torch, sc, scan, rn, moe, fa, dev) -> dict:
    """granite-4.0-h-small at its published widths with experts 0-35 held
    (seeded bf16 weights) as the served cross-encoder: the new kernels held
    against their plain versions at the served shapes, then requests
    through ``RagPipeline`` and the app on the packed path with every new
    kernel's launches counted a forward. Returns the kernel rows' numbers."""
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.granite_hybrid import GraniteHybridConfig, init_granite_hybrid
    from rag_arc_tpu_torch.models.tokenizer import HashTokenizer
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings
    from rag_arc_tpu_torch.rerank.cross_encoder import CrossEncoderReranker
    from rag_arc_tpu_torch.serving.pipeline import RagPipeline

    cfg = GraniteHybridConfig(held_experts=GRANITE_HELD, dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16)
    n_mamba = cfg.layer_types.count("mamba")
    n_attn = cfg.num_hidden_layers - n_mamba
    phase(f"granite: granite-4.0-h-small ({cfg.num_hidden_layers} layers: {n_mamba} Mamba-2, "
          f"{n_attn} NoPE attention {cfg.num_attention_heads}/{cfg.num_key_value_heads}x"
          f"{cfg.head_dim}; {cfg.num_local_experts} experts top {cfg.num_experts_per_tok}, "
          f"{GRANITE_HELD[0]}-{GRANITE_HELD[1] - 1} held, a shared expert), bf16; kernels at "
          f"{LFM2_ROWS} packed rows of {LFM2_ROW_LEN}, then served over {LFM2_DOCS} passages, "
          f"recall {LFM2_RECALL}")
    out = granite_kernels(torch, sc, scan, rn, moe, dev)

    rng = np.random.default_rng(SEED + 22)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    words = ["".join(rng.choice(letters, n)) for n in rng.integers(3, 11, DOC_VOCAB)]
    lens = np.minimum(rng.lognormal(np.log(LFM2_PASSAGE_WORDS), 0.5, LFM2_DOCS).astype(int) + 8,
                      200)
    texts = [" ".join(rng.choice(words, n)) for n in lens]
    emb = TorchEncoderEmbeddings(TransformerConfig(), seed=SEED, device=dev)
    store = TorchVectorStore.from_texts(texts, emb, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    model = init_granite_hybrid(cfg, SEED, dev)
    torch.cuda.synchronize()
    report(f"{sum(p.numel() for p in model.parameters()) / 1e9:.2f}B parameters made on the "
           f"card in {time.perf_counter() - t0:.1f} s")
    rr = CrossEncoderReranker.from_causal_lm(
        model, None, HashTokenizer(vocab_size=cfg.vocab_size, max_len=LFM2_ROW_LEN), device=dev)
    retriever = store.as_retriever(search_kwargs={"k": K})
    pipe = RagPipeline(retriever, reranker=rr, recall_k=LFM2_RECALL, top_k=K,
                       batch_max=SERVE_BATCH_MAX, batch_wait_ms=SERVE_WAIT_MS)
    pipe.warmup(batch_sizes=(1,))
    counters = [Counter(m) for m in (sc, scan, rn, moe, fa)] + [Counter(rn, "launches_gated")]
    # mamba_conv, ssd_scan, add_rms_norm (2·L + 1), the SwiGLU pass (one a
    # layer), flash_attention, gated_rms_norm
    want_each = (n_mamba, n_mamba, 2 * cfg.num_hidden_layers + 1, cfg.num_hidden_layers,
                 n_attn, n_mamba)
    times = []
    with served(pipe) as port, Calls(model, "_trunk") as calls, \
            Calls(model, "last_logits_packed") as packed:
        http = _Http(port)
        for i in range(LFM2_REQUESTS):
            query = " ".join(rng.choice(words, 9))
            for c in counters:
                c.reset()
            before = calls.n
            t0 = time.perf_counter()
            got = http.post("/batch", {"queries": [query], "k": K})["results"][0]
            times.append((time.perf_counter() - t0) * 1e3)
            n_fwd = calls.n - before
            launches = tuple(c.read() for c in counters)
            check(n_fwd > 0 and launches == tuple(n * n_fwd for n in want_each),
                  f"request {i}: mamba_conv / ssd_scan / add_rms_norm / moe swiglu / "
                  f"flash_attention / gated_rms_norm launched {launches} times for {n_fwd} forwards, not {want_each} each a "
                  f"forward")
            per_fwd = tuple(n // n_fwd for n in launches)
            with uncounted(sc, scan, rn, moe, fa):
                cands = retriever.invoke_batch([query], k=LFM2_RECALL)[0]
            scores = [d["metadata"]["rerank_score"] for d in got]
            check(len(got) == K and scores == sorted(scores, reverse=True)
                  and all(0.0 <= s <= 1.0 for s in scores), "a short or unsorted answer")
            check({d["id"] for d in got} <= {d.id for d in cands},
                  f"an answer is not among the retrieved {LFM2_RECALL}")
        http.close()
    check(packed.n == calls.n, f"{calls.n - packed.n} forwards left the packed path")
    report(f"{LFM2_REQUESTS} single-query requests x {LFM2_RECALL} candidates: "
           + ", ".join(f"{t:.1f}" for t in times) + f" ms each (host clock; "
           f"{np.mean(times[1:]):.1f} ms mean past the first), every forward packed; "
           f"launches a forward: mamba_conv {per_fwd[0]}, ssd_scan {per_fwd[1]}, add_rms_norm "
           f"{per_fwd[2]}, moe swiglu {per_fwd[3]}, flash_attention {per_fwd[4]}, "
           f"gated_rms_norm {per_fwd[5]}")
    out["mamba_conv"]["launches"] = per_fwd[0]
    out["ssd_scan"]["launches"] = per_fwd[1]
    out["gated_rms_norm"]["launches"] = per_fwd[5]
    out["moe_experts_held"]["launches"] = per_fwd[3]
    del pipe, rr, model, store, emb
    torch.cuda.empty_cache()
    return out


def phase_serve_config(torch, dev, tmp: Path, texts: list[str]) -> None:
    """A PipelineConfig document shaped like examples/serve_pipeline.json
    (TORCH_EMBEDDINGS at full width, a REWRITE with FAKE_LLM) through the
    registry, served over HTTP."""
    from rag_arc_tpu_torch.framework.registry import Register
    from rag_arc_tpu_torch.index.vector_store import Document
    from rag_arc_tpu_torch.ops import ivf_scan as isc
    from rag_arc_tpu_torch.ops import subtile_select as ss
    from rag_arc_tpu_torch.serving.configs import PipelineConfig

    doc = {
        "type": "PIPELINE",
        "retriever": {
            "type": "MULTIPATH",
            "retrievers": [
                {"type": "DENSE", "embeddings": {"type": "TORCH_EMBEDDINGS"},
                 "dtype": "bfloat16", "index_type": "flat", "k": 20},
                {"type": "BM25", "k": 20},
            ],
            "top_k": K,
            "top_k_per_retriever": 50,
        },
        "rewrite": {"type": "REWRITE", "llm": {"type": "FAKE_LLM"}},
        "top_k": K,
        "batch_max": 128,
        "batch_wait_ms": SERVE_WAIT_MS,
        "device": str(dev),
    }
    phase(f"serve_config: a PipelineConfig (MULTIPATH of DENSE over TORCH_EMBEDDINGS "
          f"768x12 and BM25, REWRITE with FAKE_LLM) through Register; {SERVE_CONFIG_DOCS} "
          f"documents, {SERVE_CONFIG_QUERIES} queries over HTTP")
    path = tmp / "pipeline.json"
    path.write_text(json.dumps(doc), encoding="utf-8")
    t0 = time.perf_counter()
    pipe = Register().register(path, "pipeline", PipelineConfig)
    check(pipe is not None, "the registry did not build the pipeline")
    docs = [Document(content=t, id=f"d{i}") for i, t in enumerate(texts[:SERVE_CONFIG_DOCS])]
    pipe.retriever.add_documents(docs)
    pipe.warmup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dense = pipe.retriever.retrievers[0].vectorstore
    check(dense.device.type == dev.type and dense.embedding.device.type == dev.type,
          f"the config's pipeline is not on {dev}")
    queries = [d.content for d in docs[:SERVE_CONFIG_QUERIES]]
    with served(pipe) as port:
        http = _Http(port)
        t0 = time.perf_counter()
        got = batch_ids(http.post("/batch", {"queries": queries}))
        ms = (time.perf_counter() - t0) * 1e3
        http.close()
    found = sum(f"d{i}" in ids for i, ids in enumerate(got))
    report(f"built, filled and warmed in {build_s:.2f} s; {len(queries)} queries in one "
           f"/batch {ms:.1f} ms (host clock); source in the fused top {K}: {found}/"
           f"{len(queries)}; rewriter {type(pipe.rewriter.llm).__name__}")
    check(found >= 0.99 * len(queries), f"only {found}/{len(queries)} sources found")
    Register().clear()
    # a DENSE retriever with index_type ivf: the store stages the documents
    # in a flat index and trains the lists when they arrive
    doc = {"type": "PIPELINE", "top_k": K, "batch_max": 128, "batch_wait_ms": SERVE_WAIT_MS,
           "device": str(dev),
           "retriever": {"type": "DENSE", "embeddings": {"type": "TORCH_EMBEDDINGS"},
                         "dtype": "bfloat16", "index_type": "ivf",
                         "nlist": SERVE_CONFIG_NLIST, "nprobe": 8, "k": K}}
    path.write_text(json.dumps(doc), encoding="utf-8")
    t0 = time.perf_counter()
    pipe = Register().register(path, "pipeline", PipelineConfig)
    check(pipe is not None, "the registry did not build the IVF pipeline")
    pipe.retriever.add_documents(docs)
    pipe.warmup()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st = pipe.retriever.vectorstore.index.stats()
    check(st["kind"] == "ivf" and st["device"] == str(dev), f"the IVF config built {st}")
    before = (isc.launches, ss.launches)
    with Calls(pipe.retriever.vectorstore.index, "search_sub") as dispatches, \
            served(pipe) as port:
        http = _Http(port)
        t0 = time.perf_counter()
        got = batch_ids(http.post("/batch", {"queries": queries}))
        ms = (time.perf_counter() - t0) * 1e3
        http.close()
    scans = (isc.launches - before[0], ss.launches - before[1])
    check(scans == (dispatches.n, dispatches.n) and dispatches.n > 0,
          f"IVF config: {scans} scan / select launches for {dispatches.n} dispatches")
    found = sum(f"d{i}" in ids for i, ids in enumerate(got))
    report(f"IVF config (DENSE, index_type ivf, nlist {SERVE_CONFIG_NLIST}, bf16): built, "
           f"filled (trained at {st['size']} rows, lmax {st['lmax']}) and warmed in "
           f"{build_s:.2f} s; {len(queries)} queries in one /batch {ms:.1f} ms (host clock); "
           f"source in the top {K}: {found}/{len(queries)}; {dispatches.n} dispatches, "
           f"ivf_scan and subtile_select {scans} launches")
    check(found >= 0.99 * len(queries), f"IVF config: only {found}/{len(queries)} found")
    Register().clear()


def ids_off_ties(s, p, ws, wp, tol: float) -> int:
    """Rows whose ids differ from the reference's (ws, wp) other than by
    entries whose scores lie within ``tol`` of the reference's k-th score
    (0 = equal up to ties at the k-th score). Host arrays, (B, k)."""
    bad = 0
    for r in range(len(wp)):
        a, b = set(p[r][p[r] >= 0].tolist()), set(wp[r][wp[r] >= 0].tolist())
        if a == b:
            continue
        fin = ws[r][np.isfinite(ws[r])]
        kth = fin.min() if fin.size else -np.inf
        odd = [s[r][list(p[r]).index(x)] for x in a - b] + \
              [ws[r][list(wp[r]).index(x)] for x in b - a]
        bad += any(abs(v - kth) > tol for v in odd)
    return bad


def plain_search(torch, index, q_dev, nprobe: int):
    """The all-plain pipeline (``ivf_scan_plain`` + the select's
    tournament) over ``q_dev`` in IVF_PLAIN_B dispatches, host arrays."""
    parts = [index.search_sub(q_dev[i : i + IVF_PLAIN_B], K, nprobe, plain=True)
             for i in range(0, q_dev.shape[0], IVF_PLAIN_B)]
    s = torch.cat([a for a, _ in parts]).cpu().numpy()
    p = torch.cat([b for _, b in parts]).cpu().numpy()
    return s, np.where(np.isneginf(s), -1, p)


def scan_operands(torch, index, q, metric: str, nprobe: int):
    """(q as searched, probe (B, nprobe), cross) of ``q`` (B, d) on
    ``index``, as ``DeviceIVFIndex.search_sub`` makes them."""
    from rag_arc_tpu_torch.ops.bm25 import full_f32_matmul
    from rag_arc_tpu_torch.ops.scoring import l2_normalize
    from rag_arc_tpu_torch.ops.topk import stable_topk

    if metric == "cosine":
        q = l2_normalize(q)
    with full_f32_matmul():
        cross = q @ index.centroids.T
    c = 2.0 * cross - (index.centroids ** 2).sum(1) if metric == "l2" else cross
    return q, stable_topk(c, nprobe)[1], cross


def scan_check(torch, isc, index, q_dev, metric: str, b: int, nprobe: int, what: str,
               d: int | None = None, offset: int = 0) -> float:
    """ivf_scan against ivf_scan_plain on ``index``'s lists: masks equal,
    scores within IVF_TOL. ``d``/``offset``: a view of each row's
    [offset, offset + d) columns (and of the queries')."""
    q, probe, cross = scan_operands(torch, index, q_dev[:b], metric, nprobe)
    lists = index.lists
    if d is not None:
        lists, q = lists[:, :, offset : offset + d], q[:, offset : offset + d].contiguous()
    args = (q, probe, lists, index.sqnorm, index.valid, metric,
            cross if index.quantized else None)
    got = isc.ivf_scan(*args)
    want = isc.ivf_scan_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(torch.isneginf(got), torch.isneginf(want)),
          f"ivf_scan {what}: the dead-slot mask differs from its plain version's")
    live = torch.isfinite(want)
    err = float((got[live] - want[live]).abs().max()) if bool(live.any()) else 0.0
    check(err <= IVF_TOL, f"ivf_scan {what}: max |kernel - plain| {err:.3g} > {IVF_TOL}")
    return err


def scan_grid(torch, isc, index, q_dev) -> dict:
    """ivf_scan alone on ``index`` at B in IVF_SCAN_B x nprobe in
    IVF_SCAN_NPROBES: mean ms (CUDA events; the wrapper's host work and its
    plan and gather launches included), device ms (the host ahead:
    ``kernel_ab.queued_ms``) beside its bound, and the path the schedule
    took."""
    from rag_arc_tpu_torch.tools import kernel_ab as ab

    grid, parts = {}, []
    for b in IVF_SCAN_B:
        for nprobe in IVF_SCAN_NPROBES:
            q, probe = ab.scan_operands(index, q_dev[:b], nprobe)
            out = torch.empty((b, nprobe * index.lmax), device=q_dev.device)
            args = (q, probe, index.lists, index.sqnorm, index.valid, "cosine")
            fn = lambda: isc.ivf_scan(*args, out=out)  # noqa: E731
            fn()
            torch.cuda.synchronize()
            ms = cuda_ms(fn, IVF_REPS * 2)
            dev_ms = ab.queued_ms(fn)
            ops, nbytes, distinct = ab.scan_bound(index, probe, b)
            bd = bound(ops, H100_BF16_PEAK, nbytes)
            path = "wgmma" if isc.scan_schedule(b, nprobe, DIM, index.nlist, True)["tc"] \
                else "cuda cores"
            grid[f"{b}x{nprobe}"] = {"ms": ms, "device_ms": dev_ms, **bd, "path": path}
            parts.append(f"B={b} nprobe {nprobe} {ms:.3f} ms, device {dev_ms:.3f} ({path}), "
                         f"bound {bd['bound_ms']:.4f} ({distinct} lists), share "
                         f"{bd['bound_ms'] / dev_ms:.2f}")
    report("ivf_scan alone, bf16 (CUDA events, mean of 10 with the wrapper's host work; "
           "device: mean of 20 queued behind a sleep, host work hidden): " + "; ".join(parts))
    return grid


def search_processes() -> dict:
    """The kernels one search_sub launches (torch.profiler) and its
    CUDA-event ms at B 1 / 8 / 32, nprobe 8 / 32, on the same 1M x 768
    bf16 IVF built in a process of its own (``tools/kernel_ab.py
    --search``: a profiler session late in this long process loses device
    events). With --parent, that tree's package too, in turns (parent,
    this, this, parent). Returns this tree's counts."""
    import os

    trees = [("this", ROOT)]
    if PARENT is not None:
        trees = [("parent", PARENT), ("this", ROOT), ("this", ROOT), ("parent", PARENT)]
    mine = {}
    for name, tree in trees:
        env = {**os.environ, "PYTHONPATH": str(tree)}
        out = subprocess.run([sys.executable, str(ROOT / "rag_arc_tpu_torch" / "tools" /
                                                  "kernel_ab.py"), "--search"],
                             env=env, capture_output=True, text=True, timeout=900)
        rows = [json.loads(ln.split("  [")[0]) for ln in out.stdout.splitlines()
                if ln.startswith("{")]
        kernels = {f"{r['search_sub_kernels']['b']}x{r['search_sub_kernels']['nprobe']}":
                   r["search_sub_kernels"]["kernels"] for r in rows if "search_sub_kernels" in r}
        times = [f"B={r['b']} nprobe {r['nprobe']} {r['ms']:.3f} (device busy "
                 f"{r['busy_ms']:.3f} of a {r['span_ms']:.3f} span)" for r in rows
                 if r.get("kind") == "search_sub_ms"]
        check(out.returncode == 0 and kernels, f"the {name} tree's search run failed: "
              f"{out.stderr[-400:]}")
        report(f"{name} tree's search_sub (a process of its own, the same corpus and build): "
               f"kernels {kernels} (B x nprobe; torch.profiler, memcpy and memset apart); ms (CUDA events, mean of 20; busy and span from torch.profiler over "
               f"5 calls): " + ", ".join(times))
        if name == "this" and not mine:
            mine = kernels
    return mine


def resident(index) -> int:
    return sum(t.numel() * t.element_size() for t in
               (index.lists, index.sqnorm, index.valid, index.pos, index.centroids))


def phase_ivf(torch, isc, ss, dev, tmp: Path) -> tuple[dict, dict]:
    """The IVF path at 1M x 768 on the oracle's clustered corpus: four
    builds, each searched at every nprobe of the recall curve and held to
    the all-plain pipeline, the kernel against its plain version, timed
    searches beside the bf16 flat index, the exhaustive probe against the
    flat index and a store snapshot round trip."""
    from rag_arc_tpu_torch.index.flat import DeviceFlatIndex
    from rag_arc_tpu_torch.index.ivf import DeviceIVFIndex
    from rag_arc_tpu_torch.index.persistence import load_store, save_store
    from rag_arc_tpu_torch.index.vector_store import TorchVectorStore
    from rag_arc_tpu_torch.models.embeddings import HashEmbeddings
    from rag_arc_tpu_torch.tools import ivf_oracle as orc

    phase(f"ivf: {IVF_N} x {DIM} clustered (tools/ivf_oracle.py, 256 centres, noise 0.3), "
          f"nlist {IVF_NLIST}, k={K}, {IVF_QUERIES} queries; builds "
          + ", ".join(f"{d} spill {s}" for d, s in IVF_BUILDS))
    t0 = time.perf_counter()
    corpus, q, rng = orc.clustered_corpus(IVF_N, DIM, IVF_QUERIES)
    gen_s = time.perf_counter() - t0
    corpus_dev = torch.from_numpy(corpus).to(dev)
    q_dev = torch.from_numpy(q).to(dev)
    t0 = time.perf_counter()
    exact = orc.masked_topk(corpus_dev, q_dev, K)
    exact_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    oracle = orc.Oracle(corpus, corpus_dev, IVF_NLIST, rng)
    curve = {}
    for nprobe in IVF_NPROBES:
        ids, frac = oracle.search(q, K, nprobe)
        curve[nprobe] = (orc.recall(ids, exact), frac)
    report(f"corpus {gen_s:.2f} s (host numpy), exact f32 top-{K} on the card {exact_s:.2f} s; "
           f"FAISS-defaults oracle (numpy k-means 25 iters on {256 * IVF_NLIST} rows, its "
           f"lists {oracle.sizes.min()}/{oracle.sizes.mean():.0f}/{oracle.sizes.max()} "
           f"min/mean/max) {time.perf_counter() - t0:.2f} s; oracle recall@{K} (scan "
           "fraction): " + ", ".join(f"nprobe {n} {r:.4f} ({f:.4f})"
                                     for n, (r, f) in curve.items()))
    launches = {"ivf_scan": 0, "subtile_select": 0, "ivf_scan_plan": 0}
    kept, errs = {}, []
    for name, spill in IVF_BUILDS:
        dtype = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}[name]
        t0 = time.perf_counter()
        index = DeviceIVFIndex.from_vectors(corpus, nlist=IVF_NLIST, nprobe=8, dtype=dtype,
                                            spill=spill, device=dev)
        build_s = time.perf_counter() - t0
        st = index.stats()
        report(f"{name} spill {spill}: built in {build_s:.2f} s (host clock; split s: "
               + ", ".join(f"{k} {v:.2f}" for k, v in index.build_seconds.items())
               + f"), lmax {index.lmax}, list fill mean/max {st['list_fill_mean']:.0f}/"
               f"{st['list_fill_max']}, resident {resident(index) / 1e9:.3f} GB")
        rec, worst = {}, 0
        for nprobe in IVF_NPROBES:
            c0, s0, p0 = isc.launches, ss.launches, isc.launches_plan
            s, p = index.search(q, K, nprobe=nprobe)
            subs = -(-IVF_QUERIES // index._sub_batch(nprobe))
            dc, ds = isc.launches - c0, ss.launches - s0
            check(dc == subs and ds == subs, f"{name} spill {spill} nprobe {nprobe}: "
                  f"{dc} scans and {ds} selects for {subs} dispatches")
            launches["ivf_scan"] += dc
            launches["subtile_select"] += ds
            launches["ivf_scan_plan"] += isc.launches_plan - p0
            rec[nprobe] = orc.recall(p, exact)
            if spill > 1:
                check(all(len(set(r.tolist())) == K and (r >= 0).all() for r in p),
                      f"spill {spill} nprobe {nprobe}: a row lacks {K} distinct positions")
            with uncounted(isc, ss):
                ws, wp = plain_search(torch, index, q_dev, nprobe)
            fin = np.isfinite(ws)
            err = float(np.abs(s[fin] - ws[fin]).max())
            off = ids_off_ties(s, p, ws, wp, IVF_TOL)
            check(err <= IVF_TOL and off == 0, f"{name} spill {spill} nprobe {nprobe}: "
                  f"scores {err:.3g} from the all-plain pipeline's, {off} rows off ties")
            worst = max(worst, err)
        report(f"{name} spill {spill} recall@{K} (oracle's beside it; scan fraction upper "
               "bound nprobe*lmax/N): " + ", ".join(
                   f"nprobe {n} {r:.4f} / {curve[n][0]:.4f} ({n * index.lmax / IVF_N:.4f})"
                   for n, r in rec.items())
               + f"; every search's ids = the all-plain pipeline's (max |d score| {worst:.3g})"
               + (f"; {K} distinct positions a row" if spill > 1 else ""))
        if (name, spill) == ("f32", 1):
            for n in (16, 32):
                check(rec[n] >= IVF_RECALL_MIN, f"f32 spill 1 recall@{K} {rec[n]:.4f} < "
                      f"{IVF_RECALL_MIN} at nprobe {n}")
        times = []
        with uncounted(isc, ss):
            for b in IVF_TIMED_B:
                for nprobe in IVF_TIMED_NPROBES:
                    index.search_sub(q_dev[:b], K, nprobe)
                    torch.cuda.synchronize()
                    ms = cuda_ms(lambda: index.search_sub(q_dev[:b], K, nprobe), IVF_REPS)
                    t0 = time.perf_counter()
                    for _ in range(IVF_REPS):
                        index.search(q[:b], K, nprobe=nprobe)
                    host_ms = (time.perf_counter() - t0) * 1e3 / IVF_REPS
                    times.append(f"B={b} nprobe {nprobe} {ms:.3f} ms = {b / ms * 1e3:.0f} QPS "
                                 f"(host {host_ms:.3f} ms = {b / host_ms * 1e3:.0f} QPS)")
        report(f"{name} spill {spill} search (CUDA events over search_sub, mean of "
               f"{IVF_REPS}; host clock over search, numpy in and out): " + "; ".join(times))
        if spill == 1:
            kept[name] = index
        del index
        torch.cuda.empty_cache()

    bf16 = kept["bf16"]
    # the exhaustive probe is exact under the storage metric: the bf16
    # flat index on the same rows, ids up to ties. Ties are judged on one
    # scoring (the IVF's query rounded to bf16 against the bf16 rows): the
    # flat index rounds its normalized query in bf16 itself
    flat = DeviceFlatIndex(dim=DIM, capacity=IVF_N, dtype=torch.bfloat16, device=dev)
    t0 = time.perf_counter()
    flat.add(corpus)
    torch.cuda.synchronize()
    flat_s = time.perf_counter() - t0
    fs, fp = flat.search(q, K)
    s, p = bf16.search(q, K, nprobe=IVF_NLIST)
    qh = scan_operands(torch, bf16, q_dev, "cosine", 1)[0].to(torch.bfloat16).float()

    def ref(ids):
        rows = flat.emb[torch.from_numpy(ids).to(dev)].float()
        return torch.einsum("bkd,bd->bk", rows, qh).cpu().numpy()

    off = ids_off_ties(ref(p), p, ref(fp), fp, IVF_FLAT_TIE)
    moved = int(sum(set(a.tolist()) != set(b.tolist()) for a, b in zip(p, fp)))
    report(f"exhaustive probe (nprobe {IVF_NLIST}) vs the bf16 flat index (added in "
           f"{flat_s:.2f} s): {moved} of {IVF_QUERIES} rows differ, all within "
           f"{IVF_FLAT_TIE} of the k-th score (one scoring)" if off == 0 else
           f"exhaustive probe vs flat: {off} rows differ past ties")
    check(off == 0, f"exhaustive probe: {off} rows differ from the flat index past ties")
    times = []
    for b in IVF_TIMED_B:
        flat.search_device(q_dev[:b], K)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: flat.search_device(q_dev[:b], K), IVF_REPS)
        t0 = time.perf_counter()
        for _ in range(IVF_REPS):
            flat.search(q[:b], K)
        host_ms = (time.perf_counter() - t0) * 1e3 / IVF_REPS
        times.append(f"B={b} {ms:.3f} ms = {b / ms * 1e3:.0f} QPS (host {host_ms:.3f} ms)")
    report(f"bf16 flat index, same {IVF_N} rows, for comparison (the two-level path at these "
           "B; CUDA events over search_device, host over search): "
           + "; ".join(times))
    del flat
    torch.cuda.empty_cache()

    # the kernel against its plain version: every dtype and metric, B and
    # nprobe; dead slots (the lists' padding and deleted rows); d = 100
    # on offset views (a 16-byte-aligned f32 one, an 8-byte-off bf16 one)
    l2 = DeviceIVFIndex.from_vectors(corpus[:IVF_L2_N], nlist=IVF_NLIST, nprobe=8,
                                     metric="l2", device=dev)
    dead = np.arange(0, IVF_N, 97)
    with uncounted(isc, ss):
        c0 = isc.launches
        for name, index in (("f32", kept["f32"]), ("bf16", bf16), ("int8", kept["int8"]),
                            ("l2 f32", l2)):
            index.mark_deleted(dead[dead < index.size])
            metrics = ("l2",) if name == "l2 f32" else (
                ("cosine",) if name == "int8" else ("cosine", "ip"))
            for metric in metrics:
                for b in (1, 7, 33):
                    for nprobe in (1, 8, IVF_NLIST):
                        errs.append(scan_check(torch, isc, index, q_dev, metric, b, nprobe,
                                               f"{name} {metric} B={b} nprobe {nprobe}"))
        for name, off in (("f32", 4), ("bf16", 4)):
            errs.append(scan_check(torch, isc, kept[name], q_dev, "ip", 7, 8,
                                   f"{name} d=100 offset {off}", d=100, offset=off))
        n_checks = isc.launches - c0
        report(f"ivf_scan = ivf_scan_plain on the card: {n_checks} cases (f32 / bf16 cosine "
               f"and ip, int8 cosine, l2 on {IVF_L2_N} f32 rows; B 1 / 7 / 33, nprobe 1 / 8 "
               f"/ {IVF_NLIST}; dead slots; d = 100 offset views), masks equal, max |d| "
               f"{max(errs):.3g} <= {IVF_TOL}")
        # timed in turns at B=32, nprobe 8 (the bf16 build)
        qb, probe, _ = scan_operands(torch, bf16, q_dev[:32], "cosine", 8)
        width = 8 * bf16.lmax
        out = torch.empty((32, width), device=dev)
        args = (qb, probe, bf16.lists, bf16.sqnorm, bf16.valid, "cosine")
        ops = 2.0 * 32 * width * DIM
        lists = torch.unique(probe)
        live = int(bf16.valid[lists].sum())
        nbytes = (live * (DIM * 2 + 4) + lists.numel() * bf16.lmax + 32 * width * 4
                  + 32 * DIM * 4)
        timed = in_turns(lambda: isc.ivf_scan(*args, out=out),
                         lambda: isc.ivf_scan_plain(*args),
                         f"ivf_scan bf16 B=32 nprobe 8 (lmax {bf16.lmax}, {lists.numel()} "
                         f"distinct lists)", ops, "TFLOP/s", nbytes, "of distinct lists")
        grid = scan_grid(torch, isc, bf16, q_dev)
        if PARENT is not None:
            from rag_arc_tpu_torch.tools import kernel_ab as ab

            rows = ab.ab_scan(ab.OtherKernels(PARENT), bf16, q_dev, CARD)
            check(all(r["masks_equal"] and r["within_tol"] for r in rows),
                  f"the parent's ivf_scan and this one's disagree beyond {ab.SCAN_TOL}")
    row = {**timed, **bound(ops, H100_BF16_PEAK, nbytes), "library_ms": None,
           "max_abs_err": max(errs), "grid": grid}
    report(f"ivf_scan bound {row['bound_ms']:.4f} ms ({row['bound_by']}: {live} live rows of "
           f"{lists.numel()} distinct lists read once + scores written) = "
           f"{row['bound_ms'] / row['ms']:.3f} of the kernel's time; yardstick: the plain "
           "version's gather + bmm (no single library call)")
    row["search_sub_kernels"] = search_processes()
    del l2, kept
    torch.cuda.empty_cache()

    # a store snapshot saved and reloaded on the card answers equal ids
    store = TorchVectorStore(HashEmbeddings(dim=DIM), dim=DIM, index_type="ivf",
                             nlist=IVF_NLIST, dtype=torch.bfloat16, device=dev)
    store.index = DeviceIVFIndex.from_vectors(corpus[:IVF_SNAP_N], nlist=IVF_NLIST, nprobe=8,
                                              dtype=torch.bfloat16, device=dev)
    store.index.mark_deleted(np.arange(0, IVF_SNAP_N, 101))
    t0 = time.perf_counter()
    save_store(store, tmp / "ivf_snap")
    back = load_store(tmp / "ivf_snap", HashEmbeddings(dim=DIM), device=dev)
    snap_s = time.perf_counter() - t0
    with uncounted(isc, ss):
        a, b = store.index.search(q, K), back.index.search(q, K)
    same = np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])
    report(f"IVF store snapshot ({IVF_SNAP_N} rows bf16, {store.index.n_deleted} deleted) "
           f"saved and loaded in {snap_s:.2f} s: ids and scores equal {same}, dtype "
           f"{back.index.dtype}")
    check(same and back.index.dtype == torch.bfloat16, "the IVF snapshot answers otherwise")
    del store, back, corpus_dev, q_dev
    torch.cuda.empty_cache()
    report(f"ivf main-path launches (the recall searches): ivf_scan {launches['ivf_scan']}, "
           f"subtile_select {launches['subtile_select']}")
    return row, launches


def hnsw_corpus(n: int, d: int, queries: int):
    """``tools/hnsw_bench.py``'s corpus: 256 gaussian centres, rows =
    centre + 0.3·N(0, 1), queries = rows + 0.05·N(0, 1), all unit."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((256, d)).astype(np.float32)
    data = centers[rng.integers(0, 256, n)] + 0.3 * rng.standard_normal((n, d)).astype(
        np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    q = data[rng.integers(0, n, queries)] + 0.05 * rng.standard_normal((queries, d)).astype(
        np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return data, q


def phase_hnsw(torch, dev, tmp: Path) -> None:
    """The host C++ HNSW engine (no device code) in f32, SQ8 and PQ with
    refine: build, batch and single-query search, recall against the exact
    top-k (computed on the card) and a snapshot round trip each."""
    from rag_arc_tpu_torch.index.hnsw import HNSWIndex
    from rag_arc_tpu_torch.tools.ivf_oracle import masked_topk, recall

    phase(f"hnsw: {HNSW_N} x {DIM} (tools/hnsw_bench.py's corpus, cut from 100,000: the "
          f"engine's add is single-threaded), M 32, ef_construction 200, ef {HNSW_EF}, "
          f"{HNSW_QUERIES} queries; f32, sq8, pq (m {DIM // 8}) + refine")
    data, q = hnsw_corpus(HNSW_N, DIM, HNSW_QUERIES)
    exact = masked_topk(torch.from_numpy(data).to(dev), torch.from_numpy(q).to(dev), K)
    modes = [("f32", {}), ("sq8", {"quantize": True}),
             ("pq+refine", {"pq_m": DIM // 8, "pq_train_threshold": min(HNSW_N, 4096),
                            "pq_refine": True})]

    def build(mode):
        index = HNSWIndex(dim=DIM, metric="cosine", M=32, **mode[1])
        t0 = time.perf_counter()
        index.add(data)
        return index, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(modes)) as pool:  # the C++ add holds no GIL
        built = list(pool.map(build, modes))
    report(f"three builds, one thread each, concurrently: {time.perf_counter() - t0:.1f} s")
    for (name, _), (index, build_s) in zip(modes, built):
        t0 = time.perf_counter()
        s, ids = index.search(q, K, ef=HNSW_EF)
        batch_s = time.perf_counter() - t0
        single = []
        for i in range(HNSW_SINGLE):
            t0 = time.perf_counter()
            index.search(q[i : i + 1], K, ef=HNSW_EF)
            single.append(time.perf_counter() - t0)
        single_ms = float(np.median(single)) * 1e3
        path = tmp / f"{name}.hnsw"
        index.save(path)
        back = HNSWIndex.load(path)
        s2, ids2 = back.search(q, K, ef=HNSW_EF)
        same = np.array_equal(ids, ids2)
        st = index.stats()
        report(f"hnsw {name}: build {build_s:.1f} s ({HNSW_N / build_s:.0f} rows/s), batch "
               f"{HNSW_QUERIES / batch_s:.0f} QPS, single query p50 {single_ms:.3f} ms "
               f"({1e3 / single_ms:.0f} QPS; host clock), recall@{K} "
               f"{recall(ids, exact):.4f}, {st['vector_bytes'] / HNSW_N:.1f} vector bytes a "
               f"row; snapshot round trip ids equal {same}")
        check(same, f"hnsw {name}: the snapshot answers other ids")


@contextlib.contextmanager
def plain_producer():
    """The two-level ops with the producer's plain version in place of its
    kernel (with :func:`plain_select`, the all-plain pipeline)."""
    from rag_arc_tpu_torch.ops import two_level as tl

    kernel = tl.subtile_max
    tl.subtile_max = tl.subtile_max_plain
    try:
        yield
    finally:
        tl.subtile_max = kernel


def pairs_off_ties(got, want, threshold: float, kth) -> int:
    """Pairs in one set and not the other must be ties: a score within
    GRAPH_TIE of the threshold, or of either key's k-th score in either
    pipeline. Returns the number of such pairs; a pair that is no tie
    fails the run."""
    got_d = {(a, b): s for a, b, s in got}
    want_d = {(a, b): s for a, b, s in want}
    diff = set(got_d) ^ set(want_d)
    for pair in diff:
        score = got_d.get(pair, want_d.get(pair))
        bounds = (threshold, *kth[pair[0]], *kth[pair[1]])
        check(any(abs(score - v) <= GRAPH_TIE for v in bounds),
              f"graph: pair {pair} at {score} differs from the all-plain pipeline's")
    both = set(got_d) & set(want_d)
    err = max((abs(got_d[p] - want_d[p]) for p in both), default=0.0)
    check(err <= GRAPH_TIE, f"graph: pair scores differ from the plain pipeline's by {err}")
    return len(diff)


def graph_pass(torch, sm, ss, store, kind: str, threshold: float, run):
    """``run()`` (the merge or the event KNN) as a user calls it, timed,
    its self-search and pairs recorded; first, uncounted, the all-plain
    pipeline's pairs over the same index, which the run's are held to
    outside ties. Returns (run's result, wall s, pairs, pairs apart at
    ties, the run's kernel launches, its host spans in ms)."""
    from rag_arc_tpu_torch.utils.tracing import get_tracer

    with uncounted(sm, ss), plain_producer(), plain_select():
        keys, s_p, h_p = store._self_search(kind, GRAPH_TOP_K)
    want = store._pairs_from_hits(kind, keys, s_p, h_p, threshold)
    before = sm.launches, ss.launches
    tracer = get_tracer()
    tracer.reset()
    with Calls(store, "_self_search", keep=True) as searches, \
            Calls(store, "_similar_pairs", keep=True) as found:
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
    spans = {n: tracer.summary().get(f"graph.{n}", {}).get("total_ms", 0.0)
             for n in ("search", "pairs", "merge")}
    launches = {"subtile_max": sm.launches - before[0], "subtile_select": ss.launches - before[1]}
    (_, s_k, _), = searches.results
    (got,) = found.results
    kth = {key: (float(a), float(b)) for key, a, b in zip(keys, s_k[:, -1], s_p[:, -1])}
    return out, wall, got, pairs_off_ties(got, want, threshold, kth), launches, spans


def graph_script(chunk: str, history: str, fmt):
    """The scripted extraction LLM of the GraphRAG flow: a chunk's events,
    entities and relations from its own text (some machines under an alias,
    a double space, that embeds as the name itself), nothing new in round
    two, every candidate kept by the review."""
    from rag_arc_tpu_torch.graph.schema import EntityReview, KnowledgeStructure

    if fmt is EntityReview:
        return EntityReview(keep=re.findall(r'"entity_name": "([^"]+)"', chunk))
    if '"events": []' not in history:
        return KnowledgeStructure()
    i, m1, p, d, m2, team = re.search(
        r"Shift report (\d+): the (\w+ \d+) failed at plant (\d+) on day (\d+); the "
        r"(\w+ \d+) was repaired by (team \w)", chunk).groups()
    e1 = f"the {m1} failed at plant {p} on day {d}"
    e2 = f"the {m2} was repaired by {team} on day {d}"
    name1 = m1.replace(" ", "  ") if int(i) % 7 == 0 else m1
    return KnowledgeStructure.model_validate({
        "events": [{"id": "E1", "content": e1, "participants": [name1]},
                   {"id": "E2", "content": e2, "participants": [m2, team]}],
        "entities": [{"entity_name": name1, "entity_type": "object",
                      "description": f"the {m1} of plant {p}" if int(i) % 3 == 0 else None},
                     {"entity_name": m2, "entity_type": "object"},
                     {"entity_name": team, "entity_type": "organization"}],
        "event_relations": [{"head_event": "E1", "tail_event": "E2", "relation_type": "CAUSES"}],
        "entity_relations": [{"head_entity": m2, "tail_entity": team,
                              "relation_type": "REPAIRED_BY"}],
    })


def graph_chunks(n: int) -> list[str]:
    rng = np.random.default_rng(SEED)
    machines = [f"{kind} {j}" for kind in ("pump", "valve", "boiler", "compressor", "turbine")
                for j in range(12)]
    out = []
    for i in range(n):
        m1, m2 = rng.choice(len(machines), 2, replace=False)
        out.append(f"Shift report {i}: the {machines[m1]} failed at plant {rng.integers(1, 6)} "
                   f"on day {rng.integers(1, 31)}; the {machines[m2]} was repaired by team "
                   f"{'abcdefgh'[rng.integers(0, 8)]}.")
    return out


def phase_graph(torch, sm, ss, dev, tmp: Path) -> dict:
    """GraphRAG on the card: the merge bench's hard corpus at 100,000 x 768
    (its self-search chunks past the score budget run ``subtile_max``'s f32
    mode and the select), held to the all-plain pipeline; the default
    corpus's planted recall and its event KNN; the f32 producer and the
    select at the chunk's shape in turns; then a HyperRAG extract -> store
    -> merge -> event KNN -> entity-linked retrieval -> snapshot flow with
    the 768 x 12 encoder."""
    from rag_arc_tpu_torch.graph.schema import GraphNode
    from rag_arc_tpu_torch.graph.store import SEARCH_CHUNK
    from rag_arc_tpu_torch.ops.two_level import prepare_queries
    from rag_arc_tpu_torch.tools import graph_merge_bench as gmb

    phase(f"graph: tools/graph_merge_bench.py --hard at {GRAPH_N} x {DIM} (f32 cosine, "
          f"threshold {GRAPH_THRESHOLD}, top {GRAPH_TOP_K} + 1, {SEARCH_CHUNK}-query chunks)")
    t0 = time.perf_counter()
    corpus = gmb.hard_corpus(GRAPH_N, DIM, SEED)
    corpus_s = time.perf_counter() - t0
    store, n_edges, upsert_s = gmb.planted_store(corpus.names, corpus.vecs, device=dev,
                                                 edges=corpus.edges)
    t0 = time.perf_counter()
    store.generate_embeddings()
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    index = store._indexes["entity"]
    full = GRAPH_N // SEARCH_CHUNK
    report(f"hard corpus {corpus_s:.2f} s ({len(corpus.clusters)} chains of 2-8, "
           f"{len(corpus.neg_pairs)} boundary negatives); upserts + {n_edges} edges "
           f"{upsert_s:.2f} s (host); embed + index {embed_s:.2f} s; capacity "
           f"{index.capacity}, {full} full chunks + one of {GRAPH_N % SEARCH_CHUNK}")
    check(4 * SEARCH_CHUNK * index.capacity > index.SCORE_BYTES_BUDGET
          and 4 * (GRAPH_N % SEARCH_CHUNK) * index.capacity <= index.SCORE_BYTES_BUDGET,
          "graph: the full chunks would not take the kernel path, or the last one would")

    merged, merge_s, pairs, ties, launches_merge, spans = graph_pass(
        torch, sm, ss, store, "entity", GRAPH_THRESHOLD, store.merge_duplicate_entities)
    stats = gmb.hard_report(store, corpus)
    q = prepare_queries(torch.from_numpy(index.take(np.arange(SEARCH_CHUNK))).to(dev),
                        torch.float32, "cosine")
    with uncounted(sm, ss):
        search_ms = cuda_ms(lambda: index.search_device(q, GRAPH_TOP_K + 1), 5)
    report(f"merge {merge_s:.2f} s wall ({GRAPH_N / merge_s:.0f} entities/s): self-search "
           f"{spans['search']:.0f} ms (one {SEARCH_CHUNK}-query chunk on the card "
           f"{search_ms:.3f} ms, CUDA events, mean of 5, after the merge's tombstones), host "
           f"pair loop {spans['pairs']:.0f} ms, union-find + edge rebuild {spans['merge']:.0f} "
           f"ms (host spans); {merged} merged; {json.dumps(stats)}; launches "
           f"{launches_merge}; {len(pairs)} pairs, equal to the all-plain pipeline's "
           f"(plain producer + plain_select()) but {ties} at ties within {GRAPH_TIE:g}")
    check(stats["dangling_edges"] == 0 and stats["entity_self_loops"] == 0,
          "graph: the merge left dangling edges or entity self-loops")
    check(stats["boundary_negatives_preserved"] == stats["boundary_negatives"],
          "graph: a boundary negative pair was merged")
    for name, n in launches_merge.items():
        check(n >= full, f"graph: {name} launched {n} times for {full} full chunks")
    del store, q
    torch.cuda.empty_cache()

    phase(f"graph: tools/graph_merge_bench.py's default corpus at {GRAPH_N} x {DIM}")
    names, vecs, n_dup = gmb.default_corpus(GRAPH_N, DIM, seed=SEED)
    store, _, upsert_s = gmb.planted_store(names, vecs, device=dev)
    t0 = time.perf_counter()
    store.generate_embeddings()
    torch.cuda.synchronize()
    embed_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    merged = store.merge_duplicate_entities()
    merge_s = time.perf_counter() - t0
    recall = merged / n_dup
    report(f"upserts {upsert_s:.2f} s, embed + index {embed_s:.2f} s, merge {merge_s:.2f} s "
           f"({GRAPH_N / merge_s:.0f} entities/s); {merged} merged of {n_dup} planted pairs: "
           f"planted_recall {recall}")
    check(recall == 1.0, f"graph: planted recall {recall} != 1.0")
    # the event KNN at the same scale: the corpus's rows as events
    for name in names:
        store.upsert_node(GraphNode(key=name, kind="event", content=name))
    store.generate_embeddings()
    added, knn_s, pairs, ties, launches_knn, spans = graph_pass(
        torch, sm, ss, store, "event", store.knn_cutoff, store.disambiguate_events)
    report(f"event KNN (disambiguate_events, cutoff {store.knn_cutoff}) over {GRAPH_N} events: "
           f"{knn_s:.2f} s wall, self-search {spans['search']:.0f} ms, pair loop "
           f"{spans['pairs']:.0f} ms (host spans); {added} SIMILAR_TO edges for {n_dup} "
           f"planted pairs; launches {launches_knn}; pairs equal to the all-plain pipeline's "
           f"but {ties} at ties within {GRAPH_TIE:g}")
    check(added == len(pairs) >= n_dup, f"graph: the event KNN added {added} edges")
    for name, n in launches_knn.items():
        check(n >= full, f"graph: {name} launched {n} times for {full} full event chunks")

    # the f32 producer and the select at the merge chunk's shape
    index = store._indexes["entity"]
    qc = prepare_queries(torch.from_numpy(index.take(np.arange(SEARCH_CHUNK))).to(dev),
                         torch.float32, "cosine")
    n, b, c = index.capacity, SEARCH_CHUNK, index.capacity // G
    kq = GRAPH_TOP_K + 1
    with uncounted(sm, ss):
        kernel = lambda: sm.subtile_max(qc, index.emb, index.valid, G)  # noqa: E731
        plain = lambda: sm.subtile_max_plain(qc, index.emb, index.valid, G)  # noqa: E731
        sub, want_sub = kernel(), plain()
        err = float((sub - want_sub).abs().max())
        report(f"subtile_max f32 B={b} N={n} d={DIM} g={G}: max|kernel - plain| = {err:.3e} "
               f"(atol {TOL:g})")
        check(err <= TOL, f"graph: the f32 producer disagrees with its plain version: {err}")
        del want_sub
        flops = 2.0 * b * n * DIM
        prod = in_turns(kernel, plain, f"subtile_max f32 B={b} N={n} d={DIM} g={G}", flops,
                        "TFLOP/s", n * DIM * 4)
        gemm = lambda: torch.matmul(qc, index.emb.T)  # noqa: E731
        gemm()
        torch.cuda.synchronize()
        gemm_ms = cuda_ms(gemm, 5)
        report(f"GEMM alone, writes the scores: torch.matmul(q, x.T) f32 (TF32 off) B={b} "
               f"N={n} {gemm_ms:.3f} ms (CUDA events, mean of 5), "
               f"{flops / gemm_ms / 1e9:.1f} TFLOP/s; the kernel {prod['ms']:.3f} ms")
        prod.update(max_abs_err=err, gemm_alone_ms=gemm_ms, library_ms=None,
                    **bound(flops, H100_F32_PEAK, n * DIM * 4 + n + b * DIM * 4 + 4 * b * c))
        got = ss.iterative_argmax_resid(sub, kq)
        want = ss.iterative_argmax_resid_plain(sub, kq)
        torch.cuda.synchronize()
        same = select_equal(torch, got, want, c)
        sel_err = float((got[2] - want[2]).abs().max())
        report(f"select B={b} C={c} k={kq}: live picks, flags and residuals equal to the plain "
               f"tournament's: {same}; max|residual - plain| = {sel_err:.3e}")
        check(same, "graph: the select disagrees with its plain tournament")
        sel = in_turns(lambda: ss.iterative_argmax_resid(sub, kq),
                       lambda: ss.iterative_argmax_resid_plain(sub, kq),
                       f"select B={b} C={c} k={kq}", b * c, "T entries/s", b * c * 4,
                       "of sub-tile maxima")
        sel.update(library_ms=library_ms(lambda: torch.topk(sub, kq, dim=1),
                                         f"torch.topk(x, {kq}, dim=1) f32 B={b} C={c} (its "
                                         f"own tie order)"), max_abs_err=sel_err,
                   **bound(b * c, H100_F32_PEAK, b * c * 4 + b * kq * 9 + b * 4))
    report(f"f32 producer at the chunk's shape: {prod['ms']:.3f} ms against its bound "
           f"{prod['bound_ms']:.3f} ms ({prod['bound_by']}; share "
           f"{prod['bound_ms'] / prod['ms']:.2f}); select {sel['ms']:.3f} ms against "
           f"{sel['bound_ms']:.3f} ms")
    del store, index, qc, sub
    torch.cuda.empty_cache()

    phase_graph_flow(torch, dev, tmp)
    return {"subtile_max_f32": prod, "subtile_select": sel}


def phase_graph_flow(torch, dev, tmp: Path) -> None:
    """examples/graphrag_pipeline.py's flow: HyperRAG extraction over a
    scripted FakeLLM, ``store_hyperrag_graph`` with the 768 x 12 encoder on
    the card (embed, merge, event KNN), entity-linked retrieval, and a
    snapshot round trip."""
    from rag_arc_tpu_torch.graph.hyperrag import HyperRAGGraphExtractor
    from rag_arc_tpu_torch.graph.store import ArrayGraphStore
    from rag_arc_tpu_torch.llm.fake import FakeLLM
    from rag_arc_tpu_torch.models.encoder import TransformerConfig
    from rag_arc_tpu_torch.models.torch_embeddings import TorchEncoderEmbeddings
    from rag_arc_tpu_torch.utils.data_model import Document

    phase(f"graph flow: HyperRAGGraphExtractor over a scripted FakeLLM on {GRAPH_CHUNKS} "
          f"chunks -> ArrayGraphStore with TorchEncoderEmbeddings 768 x 12 on the card")
    chunks = graph_chunks(GRAPH_CHUNKS)

    def script(messages, fmt):
        text = messages[-1]["content"]
        return graph_script(text, text.split("Extraction history (JSON):")[-1], fmt)

    t0 = time.perf_counter()
    extractor = HyperRAGGraphExtractor(FakeLLM(responder=script), max_rounds=2)
    results = extractor([Document(content=c, id=f"chunk{i}") for i, c in enumerate(chunks)])
    extract_s = time.perf_counter() - t0
    emb = TorchEncoderEmbeddings(TransformerConfig(), seed=SEED, device=dev)
    store = ArrayGraphStore(emb, device=dev)
    t0 = time.perf_counter()
    stats = store.store_hyperrag_graph(results)
    torch.cuda.synchronize()
    store_s = time.perf_counter() - t0
    report(f"extraction {extract_s:.2f} s (host; {sum(r.rounds for r in results)} rounds); "
           f"store_hyperrag_graph {store_s:.2f} s (embed + merge + event KNN): {stats}")
    live = store.nodes["entity"]
    keys = set().union(*store.nodes.values())
    dangling = sum(1 for e in store.edges if e.src not in keys or e.dst not in keys)
    check(stats["chunks"] == GRAPH_CHUNKS and stats["entities_merged"] > 0
          and stats["similar_event_pairs"] > 0, "graph flow: no merge or no SIMILAR_TO edge")
    check(all(" ".join(k.split()) not in live for k in live if "  " in k),
          "graph flow: an alias survived beside its name")
    check(dangling == 0, f"graph flow: {dangling} edges lost an endpoint")
    queries = sorted({" ".join(k.split()) for k in live if not k.startswith("team")})[
        :GRAPH_QUERIES]
    t0 = time.perf_counter()
    for q in queries:
        (node, _), = store.search_nodes("entity", q, 1)
        docs = store.entity_linked_chunks(q, k=5, entity_k=1)
        word = re.compile(rf"\b{re.escape(q)}\b")
        check(" ".join(node.content.split()).lower() == q and docs
              and all(word.search(d.content.lower()) for d in docs),
              f"graph flow: {q!r} linked to {node.content!r} and {[d.id for d in docs]}")
    query_ms = (time.perf_counter() - t0) / len(queries) * 1e3
    path = tmp / "graph.json"
    t0 = time.perf_counter()
    store.save(path)
    back = ArrayGraphStore(emb, device=dev)
    back.load(path)
    snap_s = time.perf_counter() - t0
    same = back.get_graph_statistics() == store.get_graph_statistics() and all(
        [(n.key, round(s, 5)) for n, s in back.search_nodes(kind, q, 5)]
        == [(n.key, round(s, 5)) for n, s in store.search_nodes(kind, q, 5)]
        for kind in ("entity", "event", "chunk") for q in queries)
    report(f"{len(queries)} entity-linked queries, {query_ms:.1f} ms each (host clock), each "
           f"chunk mentions its entity; snapshot save + load {snap_s:.2f} s, statistics and "
           f"search_nodes equal after the reload: {same}")
    check(same, "graph flow: the reloaded snapshot answers differently")


def phase_encoders(torch, dev) -> None:
    """BERT at bert-base widths on the card against the CPU (f32), and
    TextEncoderFast against TextEncoder on the same 768 x 12 weights."""
    import dataclasses

    from rag_arc_tpu_torch.models.bert import BertConfig, BertModel, init_bert
    from rag_arc_tpu_torch.models.encoder import (TextEncoderFast, TransformerConfig,
                                                  init_encoder)

    phase(f"encoders: BertModel bert-base widths (768 x 12, 12 heads, 3072, vocab 30,522; "
          f"seeded N(0, 0.02)) f32 B={BERT_B} L={BERT_L}; TextEncoderFast vs TextEncoder")
    cfg = BertConfig()
    host = init_bert(cfg, SEED, "cpu")
    card = BertModel(cfg, device=dev).eval()
    card.load_state_dict(host.state_dict())
    rng = np.random.default_rng(SEED)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (BERT_B, BERT_L)))
    lens = rng.integers(BERT_L // 4, BERT_L + 1, BERT_B)
    lens[0] = BERT_L
    mask = torch.from_numpy(np.arange(BERT_L)[None, :] < lens[:, None])
    types_ = torch.from_numpy((np.arange(BERT_L)[None, :] >= lens[:, None] // 2).astype(
        np.int64))
    t0 = time.perf_counter()
    with torch.inference_mode():
        h_cpu, p_cpu = host(ids, mask, types_)
    cpu_s = time.perf_counter() - t0
    ids_d, mask_d, types_d = ids.to(dev), mask.to(dev), types_.to(dev)
    with torch.inference_mode():
        h_gpu, p_gpu = card(ids_d, mask_d, types_d)
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: card(ids_d, mask_d, types_d), 5)
    live = mask.numpy()
    err_h = float(np.abs(h_gpu.cpu().numpy()[live] - h_cpu.numpy()[live]).max())
    err_p = float(np.abs(p_gpu.cpu().numpy() - p_cpu.numpy()).max())
    flops = 2.0 * BERT_B * BERT_L * 12 * (4 * 768 * 768 + 2 * 768 * 3072) + \
        4.0 * BERT_B * 12 * BERT_L * BERT_L * 768
    report(f"bert f32 (TF32 off) B={BERT_B} L={BERT_L}: card {ms:.3f} ms a forward (CUDA "
           f"events, mean of 5; {flops / ms / 1e9:.1f} TFLOP/s), CPU {cpu_s:.2f} s; "
           f"max|card - CPU| hidden (live rows) {err_h:.3e}, pooler {err_p:.3e} (atol "
           f"{BERT_TOL:g})")
    check(err_h <= BERT_TOL and err_p <= BERT_TOL,
          f"encoders: BERT on the card differs from the CPU by {max(err_h, err_p)}")
    del host, card, h_gpu, p_gpu
    torch.cuda.empty_cache()

    ids = torch.from_numpy(rng.integers(4, 32768, (FAST_B, FAST_L))).to(dev)
    lens = rng.integers(FAST_L // 4, FAST_L + 1, FAST_B)
    mask = torch.from_numpy(np.arange(FAST_L)[None, :] < lens[:, None]).to(dev)
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        tcfg = dataclasses.replace(TransformerConfig(), dtype=dtype)
        enc = init_encoder(tcfg, SEED, dev)
        fast = TextEncoderFast(tcfg, device=dev).eval()
        fast.load_state_dict(enc.state_dict())
        with torch.inference_mode():
            want, got = enc(ids, mask), fast(ids, mask)
            torch.cuda.synchronize()
            ms_ref = cuda_ms(lambda: enc(ids, mask), 5)
            ms_fast = cuda_ms(lambda: fast(ids, mask), 5)
        if name == "f32":
            err = float((got - want).abs().max())
            what = f"max|fast - ref| {err:.3e}"
        else:
            err = float(((got - want).norm(dim=-1) / want.norm(dim=-1)).max())
            what = f"max row |fast - ref| / |ref| {err:.3e}"
        report(f"TextEncoderFast vs TextEncoder {name} 768 x 12 B={FAST_B} L={FAST_L}: {what} "
               f"(bar {FAST_TOL[name]:g}); fast {ms_fast:.3f} ms, reference {ms_ref:.3f} ms "
               f"a forward (CUDA events, mean of 5)")
        check(err <= FAST_TOL[name], f"encoders: TextEncoderFast {name} off by {err}")
        del enc, fast
    torch.cuda.empty_cache()


class Calls:
    """Counts the calls of one object's method while inside (from any
    thread): a phase's own count of its dispatches or forwards; with
    ``keep``, also their results in call order of return."""

    def __init__(self, obj, name: str, keep: bool = False):
        import threading

        self.obj, self.name, self.n, self.results = obj, name, 0, []
        self.keep = keep
        self._lock = threading.Lock()

    def __enter__(self):
        method = getattr(self.obj, self.name)

        def counted(*args, **kwargs):
            with self._lock:
                self.n += 1
            out = method(*args, **kwargs)
            if self.keep:
                with self._lock:
                    self.results.append(out)
            return out

        setattr(self.obj, self.name, counted)
        return self

    def __exit__(self, *exc):
        delattr(self.obj, self.name)  # the class's method shows again


def main() -> int:
    import argparse

    import torch

    global PARENT
    ap = argparse.ArgumentParser(description="Drive the port's main paths on one CUDA card.")
    ap.add_argument("--parent", type=Path, default=None,
                    help="root of another tree of this repository (an earlier commit): its "
                         "ivf_scan and subtile_select are timed in turns beside these")
    PARENT = ap.parse_args().parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    from rag_arc_tpu_torch.ops import subtile_max as sm
    from rag_arc_tpu_torch.ops import flash_attention as fa
    from rag_arc_tpu_torch.ops import rope_prep as rp
    from rag_arc_tpu_torch.ops import subtile_max_i8 as smi8
    from rag_arc_tpu_torch.ops import subtile_max_piped as smp
    from rag_arc_tpu_torch.ops import subtile_select as ss
    from rag_arc_tpu_torch.ops import fused_mips as fm
    from rag_arc_tpu_torch.ops import corpus_stream as cst
    from rag_arc_tpu_torch.ops import ivf_scan as isc
    from rag_arc_tpu_torch.ops import moe
    from rag_arc_tpu_torch.ops import rms_norm as rn
    from rag_arc_tpu_torch.ops import short_conv as sc
    from rag_arc_tpu_torch.ops import ssd_scan as scan

    dev = torch.device("cuda", 0)
    counters = {"subtile_max": Counter(sm), "subtile_max_l2": Counter(sm, "launches_l2"),
                "subtile_max_i8": Counter(smi8), "subtile_select": Counter(ss),
                "rope_prep": Counter(rp), "flash_attention": Counter(fa),
                "subtile_max_piped": Counter(smp), "fused_mips_topk": Counter(fm),
                "corpus_stream": Counter(cst), "ivf_scan": Counter(isc),
                "ivf_scan_plan": Counter(isc, "launches_plan")}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    t_all = time.perf_counter()
    try:
        phase_environment(torch)
        phase_build([sm, smi8, ss, rp, fa, smp, fm, cst, isc, scan])
        kernel, kernel_l2 = phase_kernel(torch, sm, dev)
        kernel_i8 = phase_kernel_i8(torch, smi8, dev)
        kernel_select = phase_select(torch, sm, ss, dev)
        kernel_rope = phase_rope(torch, rp, dev)
        kernel_flash = phase_flash(torch, fa, dev)
        kernel_rms_norm = phase_rms_norm(torch, rn, dev)
        kernel_piped = phase_kernel_piped(torch, sm, smi8, smp, dev)
        kernel_fused = phase_kernel_fused(torch, fm, dev)
        kernel_stream = phase_kernel_stream(torch, cst, dev)
        probe_launches = phase_probe(torch, smp, fm, cst, dev)
        data = make_index_data(torch, dev)
        index = phase_index(torch, sm, ss, dev, data)
        bm25, bm25_launches = phase_bm25(torch, ss, dev)
        phase_multipath(torch, sm, ss, dev, index, bm25, data)
        del index, bm25
        torch.cuda.empty_cache()
        crossover = phase_crossover(torch, sm, ss, dev)
        l2_launches = phase_index_l2(torch, sm, ss, dev, data)
        phase_index_i8(torch, smi8, ss, dev, data)
        kernel_ivf, ivf_launches = phase_ivf(torch, isc, ss, dev, tmp)
        phase_hnsw(torch, dev, tmp)
        # the graph and encoder phases: every count set to 0 just before each
        # and read just after
        for counter in counters.values():
            counter.reset()
        t0 = time.perf_counter()
        graph = phase_graph(torch, sm, ss, dev, tmp)
        graph_launches = {name: counter.read() for name, counter in counters.items()}
        report(f"graph phase {time.perf_counter() - t0:.1f} s; kernel launches on it (two "
               f"merges, the event KNN, the flow): {graph_launches}")
        for counter in counters.values():
            counter.reset()
        t0 = time.perf_counter()
        phase_encoders(torch, dev)
        report(f"encoders phase {time.perf_counter() - t0:.1f} s; kernel launches on it: "
               f"{ {name: counter.read() for name, counter in counters.items()} }")
        e2e_launches, emb, texts, store = phase_end_to_end(torch, sm, ss, dev)
        i8_launches = phase_end_to_end_i8(torch, smi8, ss, dev, emb, texts)
        hybrid_launches = phase_hybrid_retriever(torch, sm, ss, dev, store)
        qwen3, qwen3_ref, qwen3_norm_launches = phase_rerank_model(torch, rp, fa, dev)
        rope_launches, flash_launches = phase_rerank_e2e(
            torch, rp, fa, dev, store, texts, qwen3, qwen3_ref)
        del store, qwen3_ref
        torch.cuda.empty_cache()
        # the serving path: every count set to 0 just before its four
        # phases and read just after
        for counter in counters.values():
            counter.reset()
        phase_serve_ingest(torch, dev, tmp)
        serve_store = phase_serve_2m(torch, sm, ss, dev, data, emb, tmp)
        del data
        qwen3_norm_served = phase_serve_rerank(torch, rp, fa, dev, serve_store, qwen3)
        phase_serve_config(torch, dev, tmp, texts)
        serving = {name: counter.read() for name, counter in counters.items()}
        report(f"kernel launches on the serving phases: {serving}")
        for name in ("subtile_max", "subtile_select", "rope_prep", "flash_attention",
                     "ivf_scan"):
            check(serving[name] > 0, f"{name} never launched on the serving path")
        del serve_store, qwen3, emb
        torch.cuda.empty_cache()
        lfm2 = phase_lfm2(torch, sc, moe, rp, fa, dev)
        granite = phase_granite(torch, sc, scan, rn, moe, fa, dev)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        return 1
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"== done in {time.perf_counter() - t_all:.1f} s", flush=True)
    src = "rag_arc_tpu_torch/csrc/"
    rows = [
        {"name": "subtile_max", "route": "cuda", "source": src + "subtile_max.cu",
         "replaces": "rag_arc_tpu/ops/two_level_stream.py:140",
         "also_replaces": "rag_arc_tpu/ops/two_level.py:89",
         "launches": e2e_launches["subtile_max"], **kernel,
         "launches_graph": graph_launches["subtile_max"], "graph_f32": graph["subtile_max_f32"]},
        {"name": "subtile_max_l2", "route": "cuda", "source": src + "subtile_max.cu",
         "replaces": "rag_arc_tpu/ops/two_level.py:59",
         "launches": l2_launches, **kernel_l2},
        {"name": "subtile_max_i8", "route": "cuda", "source": src + "subtile_max_i8.cu",
         "replaces": "rag_arc_tpu/ops/two_level.py:139",
         "also_replaces": ["rag_arc_tpu/ops/two_level_stream.py:140 (int8 mode)",
                           "rag_arc_tpu/ops/two_level.py:109"],
         "launches": i8_launches, **kernel_i8},
        {"name": "subtile_select", "route": "cuda", "source": src + "subtile_select.cu",
         "replaces": "rag_arc_tpu/ops/two_level.py:416 (XLA program, no Pallas)",
         "launches": e2e_launches["subtile_select"],
         "launches_bm25_hybrid": bm25_launches,
         "launches_ivf": ivf_launches["subtile_select"],
         "launches_hybrid_retriever": hybrid_launches, **kernel_select,
         "launches_graph": graph_launches["subtile_select"], "graph_chunk": graph["subtile_select"]},
        {"name": "rope_prep", "route": "cuda", "source": src + "rope_prep.cu",
         "replaces": "rag_arc_tpu/ops/rope_prep.py:52",
         "launches": rope_launches, **kernel_rope},
        {"name": "flash_attention", "route": "cuda", "source": src + "flash_attention.cu",
         "replaces": "rag_arc_tpu/models/qwen3.py:176-196 (library Pallas flash attention)",
         "launches": flash_launches, **kernel_flash},
        {"name": "subtile_max_piped", "route": "cuda", "source": src + "subtile_max_piped.cu",
         "replaces": "rag_arc_tpu/ops/two_level_stream.py:53",
         "launches": probe_launches["subtile_max_piped"], **kernel_piped},
        {"name": "fused_mips_topk", "route": "cuda", "source": src + "fused_mips.cu",
         "replaces": "rag_arc_tpu/ops/fused_mips.py:50",
         "launches": probe_launches["fused_mips_topk"], **kernel_fused},
        {"name": "corpus_stream", "route": "cuda", "source": src + "corpus_stream.cu",
         "replaces": "tools/kernel_probe.py:194",
         "launches": probe_launches["corpus_stream"], **kernel_stream},
        {"name": "ivf_scan", "route": "cuda", "source": src + "ivf_scan.cu",
         "replaces": "rag_arc_tpu/index/ivf.py:743 (_ivf_search_body's probe gather and "
                     "scores, :768-812; XLA program, no Pallas)",
         "launches": ivf_launches["ivf_scan"],
         "launches_plan": ivf_launches["ivf_scan_plan"], **kernel_ivf},
    ]
    for row in rows:  # each kernel's launches on the four serving phases
        row["launches_serving"] = serving[row["name"]]
    rows[-1]["launches_plan_serving"] = serving["ivf_scan_plan"]
    # the LFM2 reranker's: no TPU counterpart; launches a served forward
    rows += [
        {"name": "short_conv", "route": "triton", "source": "rag_arc_tpu_torch/ops/short_conv.py",
         "replaces": None, **lfm2["short_conv"]},
        {"name": "moe_swiglu", "route": "triton", "source": "rag_arc_tpu_torch/ops/moe.py",
         "replaces": None, **lfm2["moe_swiglu"]},
        {"name": "moe_experts", "route": "torch._grouped_mm x2 + moe_swiglu",
         "source": "rag_arc_tpu_torch/ops/moe.py", "replaces": None, **lfm2["moe_experts"]},
    ]
    # the Granite 4.0-H reranker's: no TPU counterpart; launches a served forward
    rows += [
        {"name": "mamba_conv", "route": "triton", "source": "rag_arc_tpu_torch/ops/short_conv.py",
         "replaces": None, **granite["mamba_conv"]},
        {"name": "ssd_scan", "route": "cuda", "source": src + "ssd_scan.cu",
         "replaces": None, **granite["ssd_scan"]},
        {"name": "gated_rms_norm", "route": "triton",
         "source": "rag_arc_tpu_torch/ops/rms_norm.py", "replaces": None,
         **granite["gated_rms_norm"]},
        {"name": "moe_experts (36 of 72 held)",
         "route": "torch._grouped_mm x2 + moe_swiglu",
         "source": "rag_arc_tpu_torch/ops/moe.py", "replaces": None,
         **granite["moe_experts_held"]},
    ]
    # XLA fused this chain on the TPU: no Pallas kernel. One row a served
    # reranker's shape, with the launches a forward that the rerank,
    # serve_rerank and lfm2 phases counted on that model
    norm_launches = ({"launches": qwen3_norm_launches, "launches_serving": qwen3_norm_served},
                     {"launches": lfm2["add_rms_norm_launches"]})
    for (t, h, what), counted in zip(RMS_NORM_SHAPES, norm_launches):
        rows.append({"name": "add_rms_norm", "route": "triton",
                     "source": "rag_arc_tpu_torch/ops/rms_norm.py", "replaces": None,
                     "shape": f"T={t} H={h} ({what})", **counted,
                     **kernel_rms_norm[f"T{t}_H{h}"]})
    print(json.dumps({"kernels": rows, "crossover": crossover}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
