"""Corpus-stream bandwidth floor: one pass over the corpus, reduced to an
(8, d) running max.

Counterpart of the kernel probe's ``_dma_kernel``
(``tools/kernel_probe.py:194``, its ``dma_only`` config): the same DMA stream as
the stream producer with no matmul, so the probe can tell whether pass 1 is
bound by memory or by the matrix units. On the card it runs the
hand-written CUDA kernel ``csrc/corpus_stream.cu`` (16-byte loads, partial
maxima per thread, a second pass over them); on the CPU it runs
:func:`corpus_stream_plain`.

``out[j, c] = max over rows r with r % 8 == j of float(corpus[r, c])``,
starting from -3e38, for bf16, f32 and int8 corpora. Max is exact in the
storage type, so kernel and plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import Built, build
from rag_arc_tpu_torch.ops.subtile_max import NEG

# kernel launches since the count was last set to 0; only the wrapper's
# CUDA branch adds to it (one per call: the stream pass and its combine)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PLAIN_ROWS = 1 << 16  # rows widened to f32 at a time (a multiple of 8)


def corpus_stream_plain(corpus: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (8, d) f32, widened in row chunks."""
    n, d = corpus.shape
    out = torch.full((8, d), NEG, dtype=torch.float32, device=corpus.device)
    for start in range(0, n, _PLAIN_ROWS):
        part = corpus[start : start + _PLAIN_ROWS].float()
        part = F.pad(part, (0, 0, 0, -part.shape[0] % 8), value=NEG)
        out = torch.maximum(out, part.reshape(-1, 8, d).amax(dim=0))
    return out


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("corpus_stream")
    lib = built.lib
    lib.corpus_stream_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.corpus_stream_launch.restype = ctypes.c_int
    lib.corpus_stream_blocks.argtypes = [ctypes.c_int] * 3
    lib.corpus_stream_blocks.restype = ctypes.c_int
    lib.corpus_stream_partial_rows.argtypes = [ctypes.c_int] * 3
    lib.corpus_stream_partial_rows.restype = ctypes.c_long
    return built


def corpus_stream(corpus: torch.Tensor) -> torch.Tensor:
    """(8, d) f32 running max of the corpus rows by row index mod 8.

    CPU tensors take :func:`corpus_stream_plain`; CUDA tensors launch the
    kernel on the current stream or raise."""
    global launches
    if corpus.ndim != 2 or corpus.dtype not in _DTYPE_CODE:
        raise ValueError(
            f"expected an (N, d) bf16, f32 or int8 corpus, got "
            f"{tuple(corpus.shape)} {corpus.dtype}"
        )
    if corpus.device.type == "cpu":
        return corpus_stream_plain(corpus)
    if corpus.device.type != "cuda":
        raise ValueError(f"no corpus_stream kernel for device {corpus.device}")
    if not corpus.is_contiguous():
        raise ValueError("corpus_stream kernel needs a contiguous corpus")
    n, d = corpus.shape
    elem = corpus.element_size()
    if d * elem % 16 or corpus.data_ptr() % 16:
        raise ValueError(
            "corpus_stream kernel loads 16 bytes at a time: rows must be a "
            "multiple of 16 bytes and start 16-byte aligned"
        )
    if n >= 2**31:
        raise ValueError("corpus_stream kernel counts rows with 32-bit ints")
    lib = load().lib
    sms = torch.cuda.get_device_properties(corpus.device).multi_processor_count
    blocks = lib.corpus_stream_blocks(d, elem, 8 * sms)  # 2048 threads an SM
    rows = lib.corpus_stream_partial_rows(blocks, d, elem)
    partial = torch.empty((rows, 8 * d), dtype=torch.float32, device=corpus.device)
    out = torch.empty((8, d), dtype=torch.float32, device=corpus.device)
    with torch.cuda.device(corpus.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.corpus_stream_launch(
            corpus.data_ptr(), partial.data_ptr(), out.data_ptr(), n, d,
            _DTYPE_CODE[corpus.dtype], blocks, stream,
        )
    if err != 0:
        raise RuntimeError(f"corpus_stream kernel launch failed: CUDA error {err}")
    launches += 1
    return out
