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
bytes it would save.  The blocks are the reference's stacked leaves': the
gradients of a group (``models/convert.py::stack_groups``, given by the
train step) are quantized as one flattened concatenation
(``optimizer.block_units``, ``quantize_stack``); each parameter keeps its
own f32 residual.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.optim.optimizer import (Groups, block_units,
                                         dequantize_stack, quantize_stack)

Tensors = Dict[str, torch.Tensor]


def init_error_feedback(params: Tensors) -> Tensors:
    """f32 zeros laid out as each parameter (a DTensor on a mesh)."""
    return {n: torch.zeros_like(p, dtype=torch.float32)
            for n, p in params.items()}


@torch.no_grad()
def compress_with_error_feedback(grads: Tensors, ef_state: Tensors,
                                 groups: Optional[Groups] = None
                                 ) -> Tuple[Tensors, Tensors]:
    """grads -> (compressed-roundtrip grads in each gradient's dtype, new
    error-feedback residuals in f32), each of ``groups`` quantized as one.
    ``grads`` is left as it is; the residuals are updated in place
    (``ef_state`` is returned), so a step holds one set of them."""
    newg = {}
    for names in block_units(grads, groups).values():
        gfs = [grads[n].float() + ef_state[n] for n in names]
        q, s = quantize_stack(gfs)
        for name, gf, deq in zip(names, gfs, dequantize_stack(q, s, gfs)):
            newg[name] = deq.to(grads[name].dtype)
            ef_state[name].copy_(gf.sub_(deq))
    return {n: newg[n] for n in grads}, ef_state


def compressed_bytes_fraction() -> float:
    """int8 + per-256 f32 scale vs f32: (1 + 4/256) / 4."""
    return (1.0 + 4.0 / 256.0) / 4.0
