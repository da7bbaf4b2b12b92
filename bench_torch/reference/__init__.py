"""Plain float32 references the benchmark holds the served system to.

They import no module of the program and compute with plain ``torch``
operations, TF32 off. Every matmul goes through a ``mm`` argument, so the
same code, given :func:`fp8_mm`, is the control that computes in the
precision below the configuration's (bf16 → fp8 e4m3, per-tensor scales).
"""

from __future__ import annotations

import torch


def exact_f32() -> None:
    """Switch TF32 off: a float32 matmul on the card is then float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def f32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its amax at 448)."""
    t = t.float()
    scale = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(fp8_round(a), fp8_round(b))
