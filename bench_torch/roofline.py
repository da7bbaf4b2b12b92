"""Peaks of the card and the operations and bytes each piece of work needs.

Counts follow from the work a user asked for (the shapes of the search,
the real token lengths of each sequence), never from a kernel's choices:
a kernel that pads, re-reads or recomputes is held to the same count.
Peaks are NVIDIA's H100 SXM data-sheet rates without sparsity, at the
full 700 W limit.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
FP8_FLOPS = 1979e12
TF32_FLOPS = 495e12
F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> float:
    """The least time the card could take: compute or memory, the larger."""
    return max(flops / peak, nbytes / HBM_BYTES_S)


def share_pct(bound_total_s: float, device_total_s: float) -> float:
    """A roofline or peak share in %. Above 100 the counts or the timing
    are wrong, so it raises instead of clamping."""
    if device_total_s <= 0:
        raise ValueError("no device time to divide by")
    pct = 100.0 * bound_total_s / device_total_s
    if pct > 100.0:
        raise ValueError(f"share {pct:.3f}% above 100%: the counted work or the timing is wrong")
    return pct


# -- exact search ---------------------------------------------------------------


def search_flops(b: int, n: int, d: int) -> float:
    """Scoring B queries against N rows of width d."""
    return 2.0 * b * n * d


def search_bytes(b: int, n: int, d: int, row_bytes: int = 2, k: int = 10) -> float:
    """Each stored row read once, each query read once (f32), each answer
    (an f32 score and an int32 position) written once."""
    return float(n) * d * row_bytes + 4.0 * b * d + 8.0 * b * k


def search_bound_s(b: int, n: int, d: int, row_bytes: int = 2, k: int = 10) -> float:
    return bound_s(search_flops(b, n, d), search_bytes(b, n, d, row_bytes, k))


# -- the encoder ------------------------------------------------------------------


def encoder_flops(length: int, d: int, depth: int, mlp: int) -> float:
    """One bidirectional sequence of ``length`` real tokens: the q/k/v,
    output and MLP matmuls, and QK^T and PV over the sequence."""
    per_token = 2.0 * d * (3 * d + d + 2 * mlp)
    attn = 4.0 * length * length * d
    return depth * (length * per_token + attn)


# -- the reranker ---------------------------------------------------------------


def rerank_flops_per_pair(cfg, length: int) -> float:
    """Matmul FLOPs of one pair's forward, as bench.py:421-429 counts them
    (qkvo + SwiGLU per layer, plus 4·L·NH·D attention per token).
    A copy of ``chip_smoke.py::rerank_flops_per_pair``, kept so that the
    program may change without moving this count."""
    h, hd, nh, nkv, inter = (cfg.hidden_size, cfg.head_dim, cfg.num_attention_heads,
                             cfg.num_key_value_heads, cfg.intermediate_size)
    per_layer = 2 * h * hd * (2 * nh + 2 * nkv) + 6 * h * inter
    attn = 4 * length * nh * hd
    return float(length * cfg.num_hidden_layers * (per_layer + attn))


def causal_attention_flops(length: int, nh: int, hd: int) -> float:
    """QK^T and PV of one layer, causal: row i meets i + 1 keys."""
    return 4.0 * nh * hd * length * (length + 1) / 2.0


def rerank_model_flops(cfg, length: int) -> float:
    """What a pair of ``length`` real tokens needs: the copied count with
    its attention term made causal, plus the yes/no readout's vocabulary
    head at the last token."""
    full_attn = 4.0 * length * length * cfg.num_attention_heads * cfg.head_dim
    causal = causal_attention_flops(length, cfg.num_attention_heads, cfg.head_dim)
    layers = cfg.num_hidden_layers
    head = 2.0 * cfg.hidden_size * cfg.vocab_size
    return rerank_flops_per_pair(cfg, length) - layers * (full_attn - causal) + head


def attention_layer_bound_s(length: int, nh: int, nkv: int, hd: int) -> float:
    """One layer's attention calls for one sequence of ``length`` real
    tokens, in bf16: the rope/qk-norm pass (reads q, k, v from the
    projection, writes them once) and the causal attention (reads q, k, v
    once, writes the output once)."""
    elems_qkv = (nh + 2 * nkv) * hd * length
    rope = bound_s(0.0, 2.0 * 2 * elems_qkv)
    flash = bound_s(causal_attention_flops(length, nh, hd),
                    2.0 * (elems_qkv + nh * hd * length))
    return rope + flash
