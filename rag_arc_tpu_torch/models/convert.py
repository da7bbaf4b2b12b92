"""Flax → PyTorch weight bridge for the text encoder.

``encoder_state_dict_from_flax`` maps the Flax ``TextEncoder`` parameter
tree (``rag_arc_tpu/models/encoder.py``), given as numpy arrays, to the
``state_dict`` of the port's ``TextEncoder``, so both packages can run on
identical weights. It needs numpy only; the Flax tree comes from the JAX
package's tests or a saved checkpoint.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_BLOCK_LAYERS = ("ln_attn", "qkv", "attn_out", "ln_mlp", "mlp_up", "mlp_down")


def _tensor(a: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _layer(prefix: str, p: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "kernel" in p:  # Dense: Flax kernel is (in, out), Linear weight (out, in)
        return {
            f"{prefix}.weight": _tensor(p["kernel"]).T.contiguous(),
            f"{prefix}.bias": _tensor(p["bias"]),
        }
    return {  # LayerNorm
        f"{prefix}.weight": _tensor(p["scale"]),
        f"{prefix}.bias": _tensor(p["bias"]),
    }


def encoder_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax ``TextEncoder`` params (the ``init`` result, or its
    ``"params"`` entry) → the port's ``TextEncoder`` state_dict (f32)."""
    if "params" in params:
        params = params["params"]
    trunk = params["trunk"]
    out = {
        "trunk.tok_embed.weight": _tensor(trunk["tok_embed"]["embedding"]),
        "trunk.pos_embed.weight": _tensor(trunk["pos_embed"]["embedding"]),
        **_layer("trunk.ln_final", trunk["ln_final"]),
    }
    depth = sum(1 for name in trunk if name.startswith("block_"))
    for i in range(depth):
        block = trunk[f"block_{i}"]
        for name in _BLOCK_LAYERS:
            out.update(_layer(f"trunk.blocks.{i}.{name}", block[name]))
    return out
