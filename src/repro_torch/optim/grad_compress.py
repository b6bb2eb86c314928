"""Error-feedback int8 gradient compression.  The port of
``repro.optim.grad_compress``.

Each gradient, plus the residual carried from the last step, is quantized
to int8 in blocks of 256 with f32 scales and dequantized again; what the
round trip lost becomes the next residual (error feedback, Karimireddy et
al., 2019), so the accumulated applied gradient converges to the true sum.
The transform is applied where a data-parallel reduction would sit, as in
the reference (after the gradients are reduced to their parameters'
layout, on a mesh too: the blocks are the global tensor's, see
``optimizer.quantize_i8``), and ``compressed_bytes_fraction`` gives the
bytes it would save.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.optim.optimizer import dequantize_i8, quantize_i8

Tensors = Dict[str, torch.Tensor]


def init_error_feedback(params: Tensors) -> Tensors:
    """f32 zeros laid out as each parameter (a DTensor on a mesh)."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


@torch.no_grad()
def compress_with_error_feedback(grads: Tensors, ef_state: Tensors
                                 ) -> Tuple[Tensors, Tensors]:
    """grads -> (compressed-roundtrip grads in each gradient's dtype, new
    error-feedback residuals in f32).  ``grads`` is left as it is; the
    residuals are updated in place (``ef_state`` is returned), so a step
    holds one set of them."""
    newg = {}
    for name, g in grads.items():
        e = ef_state[name]
        gf = g.float() + e
        q, s = quantize_i8(gf)
        deq = dequantize_i8(q, s, gf.shape, like=gf)
        newg[name] = deq.to(g.dtype)
        e.copy_(gf.sub_(deq))
    return newg, ef_state


def compressed_bytes_fraction() -> float:
    """int8 + per-256 f32 scale vs f32: (1 + 4/256) / 4."""
    return (1.0 + 4.0 / 256.0) / 4.0
