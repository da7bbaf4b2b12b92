"""The Mamba-2 state-space scan (SSD), segment-resetting, chunked.

Replaces no TPU kernel: the JAX package has no state-space model. It was
added for ``models/granite_hybrid.py`` (Granite 4.0-H's Mamba-2 mixers,
``granitemoehybrid`` in HF transformers). For each head h of P channels,
over the tokens t of a row, with a state of P × N in f32:

    dt_t = softplus(dt_raw[t, h] + dt_bias[h])       A = −exp(A_log[h])
    state_t = exp(dt_t · A) · state_{t−1} + dt_t · x_t ⊗ B_t
    y_t = state_t · C_t + D[h] · x_t

with one group (B and C of N channels shared by every head). The state
starts from zero at each segment start: sequences packed several to a row
(``models/packing.py``) never read each other, which is HF's ``seq_idx``
(its torch path refuses ``seq_idx``, and without it materializes a
(rows, chunks, Q, Q, heads, N) f32 product). Padding (segment −1) adds
nothing to any state and its output is zero.

The chunked form (SSD): within a chunk of Q tokens, with ``cum`` the
cumulative sum of dt·A from the chunk's start,

    y_t = sum_{s <= t, same segment} (C_t · B_s) · exp(cum_t − cum_s) · dt_s · x_s
          + [t's segment held the state at the chunk's start] · exp(cum_t) · C_t · H
          + D · x_t

and the state H carried to the next chunk is that of the chunk's last
token: its own segment's terms of this chunk decayed to the end, plus
``exp(cum_end) · H`` where that segment already held H. Every decay is
taken only between tokens of one segment, so no term crosses a start.

On the card :func:`ssd_scan` launches the CUDA kernel ``csrc/ssd_scan.cu``
(head_dim 64, d_state 128): a block a (head, row), walking the
row's chunks in order with the head's state in f32 registers (P = 64 by
N = 128: 32 KB over four warps), so the state never touches device
memory. Each chunk is four tensor-core products (C·Bᵀ, the masked decay
times x, C times the carried state, the state update) on bf16 operands
with f32 sums, as mamba_ssm's kernels take them: the masked decay weights,
the carried state and the scaled x are rounded to bf16 for their product
only, and the state itself stays f32. It reads x, B, C and dt once a head
(B and C, shared by the heads, come from L2 after the first) and writes y
once in the input dtype. Per token and head the recurrence is ~5·P·N
FLOPs against ~4·P bytes of x and y: near the card's ridge, so its bound
is the larger of the two (``bench_torch/roofline_granite4h.py``). On the
CPU it runs :func:`ssd_scan_plain`, the same chunked arithmetic in f32.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from rag_arc_tpu_torch.ops._build import Built, build, count_launch

# kernel launches since the count was last set to 0; only the CUDA branch adds
launches = 0

CHUNK = 64
# the shape the CUDA kernel is built for (granite-4.0-h's)
KERNEL_HEAD_DIM = 64
KERNEL_D_STATE = 128


def _check(xbc, dt, a_log, dt_bias, d, seg, heads, head_dim, d_state) -> tuple:
    if xbc.ndim != 3 or xbc.shape[-1] != heads * head_dim + 2 * d_state:
        raise ValueError(f"xbc must be (R, L, {heads * head_dim + 2 * d_state}) = "
                         f"[x | B | C], got {tuple(xbc.shape)}")
    r, l, _ = xbc.shape
    if dt.shape != (r, l, heads):
        raise ValueError(f"dt must be ({r}, {l}, {heads}), got {tuple(dt.shape)}")
    for name, t in (("A_log", a_log), ("dt_bias", dt_bias), ("D", d)):
        if t.shape != (heads,):
            raise ValueError(f"{name} must be ({heads},), got {tuple(t.shape)}")
    if seg.shape != (r, l):
        raise ValueError(f"seg must be ({r}, {l}), got {tuple(seg.shape)}")
    return r, l


def ssd_scan_plain(xbc: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                   dt_bias: torch.Tensor, d: torch.Tensor, seg: torch.Tensor, *, heads: int,
                   head_dim: int, d_state: int, chunk: int = CHUNK) -> torch.Tensor:
    """Plain PyTorch version of :func:`ssd_scan`: the same chunked form, in
    f32, every chunk of every row at once and the states carried over the
    chunks in a loop; rounded once to xbc's dtype."""
    r, l = _check(xbc, dt, a_log, dt_bias, d, seg, heads, head_dim, d_state)
    p, n, q = head_dim, d_state, chunk
    nc = -(-l // q)
    pad = nc * q - l
    v = F.pad(xbc.float(), (0, 0, 0, pad))
    x = v[..., : heads * p].reshape(r, nc, q, heads, p)
    b = v[..., heads * p : heads * p + n].reshape(r, nc, q, n)
    c = v[..., heads * p + n :].reshape(r, nc, q, n)
    sg = F.pad(seg, (0, pad), value=-1).reshape(r, nc, q)
    live = sg >= 0
    step = F.softplus(F.pad(dt.float(), (0, 0, 0, pad)).reshape(r, nc, q, heads)
                      + dt_bias.float())
    step = torch.where(live[..., None], step, 0.0)
    cum = torch.cumsum(step * -torch.exp(a_log.float()), dim=2)  # (r, nc, q, heads)
    # within the chunk: token t reads s <= t of its own live segment
    tri = torch.ones(q, q, dtype=torch.bool, device=xbc.device).tril()
    same = (sg[..., :, None] == sg[..., None, :]) & live[..., :, None] & tri
    gap = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (r, nc, t, s, heads)
    decay = torch.exp(torch.where(same[..., None], gap, -torch.inf))
    cb = torch.einsum("rctn,rcsn->rcts", c, b)
    w = cb[..., None] * decay * step[:, :, None, :, :]
    y = torch.einsum("rctsh,rcshp->rcthp", w, x)
    # each chunk's own contribution to the state of its last token's segment
    end_seg = sg[:, :, -1]
    to_end = torch.where(((sg == end_seg[..., None]) & live)[..., None],
                         torch.exp(cum[:, :, -1:, :] - cum), 0.0) * step
    own = torch.einsum("rcshp,rcsn->rchpn", to_end[..., None] * x, b)  # (r, nc, heads, p, n)
    state = torch.zeros(r, heads, p, n, device=xbc.device)
    prev = torch.full((r,), -1, dtype=sg.dtype, device=xbc.device)
    for k in range(nc):
        held = (sg[:, k] == prev[:, None]) & live[:, k]  # (r, q)
        carried = torch.einsum("rtn,rhpn->rthp", c[:, k], state)
        y[:, k] += torch.where(held[..., None, None], torch.exp(cum[:, k])[..., None] * carried,
                               0.0)
        keep = (end_seg[:, k] == prev) & (prev >= 0)
        state = torch.where(keep[:, None, None, None],
                            torch.exp(cum[:, k, -1])[:, :, None, None] * state, 0.0) + own[:, k]
        prev = end_seg[:, k]
    y = y + d.float()[:, None] * x
    y = torch.where(live[..., None, None], y, 0.0)
    return y.reshape(r, nc * q, heads * p)[:, :l].to(xbc.dtype)


@functools.lru_cache(maxsize=None)
def load() -> Built:
    """Build (once) and bind the CUDA kernel library."""
    built = build("ssd_scan")
    fn = built.lib.ssd_scan_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,                   # xbc, dt
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # A_log, dt_bias, D
        ctypes.c_void_p, ctypes.c_void_p,                   # segment ids, y
        ctypes.c_int, ctypes.c_int, ctypes.c_int,           # R L H
        ctypes.c_longlong, ctypes.c_void_p,                 # dt's token stride, stream
    ]
    fn.restype = ctypes.c_int
    return built


def ssd_scan(xbc: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor, dt_bias: torch.Tensor,
             d: torch.Tensor, seg: torch.Tensor, *, heads: int, head_dim: int,
             d_state: int) -> torch.Tensor:
    """``xbc`` (R, L, heads·head_dim + 2·d_state), the convolved ``[x | B |
    C]``, contiguous; ``dt`` (R, L, heads), the raw time steps, a view whose
    last axis is dense and whose tokens lie one row stride apart (a column
    slice of the mixer's input projection); ``a_log``, ``dt_bias``, ``d``
    (heads,); ``seg`` (R, L) int32 segment ids, −1 on padding. Returns
    ``y`` (R, L, heads·head_dim) in xbc's dtype, zero on padding. CPU
    tensors take :func:`ssd_scan_plain`; CUDA tensors launch the kernel on
    the current stream or raise."""
    r, l = _check(xbc, dt, a_log, dt_bias, d, seg, heads, head_dim, d_state)
    if xbc.device.type == "cpu":
        return ssd_scan_plain(xbc, dt, a_log, dt_bias, d, seg, heads=heads,
                              head_dim=head_dim, d_state=d_state)
    if xbc.device.type != "cuda":
        raise ValueError(f"no ssd_scan kernel for device {xbc.device}")
    if any(t.device != xbc.device for t in (dt, a_log, dt_bias, d, seg)):
        raise ValueError("ssd_scan inputs must share one device")
    if xbc.dtype != torch.bfloat16 or dt.dtype != xbc.dtype:
        raise ValueError(f"ssd_scan kernel takes bf16 xbc and dt, got {xbc.dtype}, {dt.dtype}")
    if any(t.dtype != torch.float32 for t in (a_log, dt_bias, d)):
        raise ValueError("ssd_scan kernel takes f32 A_log, dt_bias and D")
    if seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32, not {seg.dtype}")
    if (head_dim, d_state) != (KERNEL_HEAD_DIM, KERNEL_D_STATE):
        raise ValueError(f"ssd_scan kernel takes head_dim {KERNEL_HEAD_DIM} and d_state "
                         f"{KERNEL_D_STATE}, got {head_dim}, {d_state}")
    if not all(t.is_contiguous() for t in (xbc, a_log, dt_bias, d, seg)):
        raise ValueError("ssd_scan kernel needs contiguous xbc, parameters and segment ids")
    if xbc.data_ptr() % 16:
        raise ValueError("ssd_scan kernel needs xbc on a 16-byte boundary")
    stride = dt.stride(1)
    if dt.stride(2) != 1 or (r > 1 and dt.stride(0) != l * stride):
        raise ValueError("ssd_scan kernel needs dt with a dense last axis and one token stride")
    y = torch.empty((r, l, heads * head_dim), dtype=xbc.dtype, device=xbc.device)
    if r * l == 0:
        return y
    fn = load().lib.ssd_scan_launch
    with torch.cuda.device(xbc.device):
        err = fn(xbc.data_ptr(), dt.data_ptr(), a_log.data_ptr(), dt_bias.data_ptr(),
                 d.data_ptr(), seg.data_ptr(), y.data_ptr(), r, l, heads, stride,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    count_launch(__name__)
    return y
