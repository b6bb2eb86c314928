"""Kernel entry points of the port: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain version.  Nothing else.  Under
autograd every entry point raises (``kernels/guard.py``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import ref as R
from repro_torch.kernels.guard import refuse_autograd
# These three wrappers route a CPU tensor to the plain version themselves and
# count their own launches (``flash_attention.launches``,
# ``decode_attention.launches``, ``ssd.launches``).
# One query per row against a KV prefix, q [B,H,D], k/v [B,S,Hkv,D],
# lengths [B] int32 -> [B,H,D]:
from repro_torch.kernels.decode_attention import \
    decode_attention  # noqa: F401
# Prefill attention, q [B,Sq,H,D], k/v [B,Skv,Hkv,D] -> [B,Sq,H,D]:
from repro_torch.kernels.flash_attention import flash_attention  # noqa: F401
# Mamba2 chunked SSD scan (every mamba layer's full-sequence path),
# x [b,s,h,p], dt [b,s,h], A [h], B/C [b,s,n], chunk, init_state [b,h,p,n]
# or None -> (y, final state [b,h,p,n]):
from repro_torch.kernels.ssd_scan import ssd_scan as ssd  # noqa: F401


def cache_moe(x: torch.Tensor, slot_ids: torch.Tensor, weights: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor,
              wg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot-indexed grouped expert FFN over ExpertCache slot buffers
    (SP-MoE verification hot path).  slot_ids < 0 contribute zero.
    ``cache_moe.launches`` counts the calls that launched the kernels (not
    those inside a CUDA graph capture, which launch nothing)."""
    refuse_autograd("cache_moe", x, weights, wu, wd, wg)
    if x.device.type == "cuda":
        y = K.cache_moe(x, slot_ids, weights, wu, wd, wg)
        if not torch.cuda.is_current_stream_capturing():
            cache_moe.launches += 1
        return y
    return R.cache_moe_ref(x, slot_ids, weights, wu, wd, wg)


cache_moe.launches = 0



def moe_gemm(xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
             wd: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Dense-layout grouped swiglu expert FFN (the reference's
    ``ops.moe_gemm``): xg [E, C, d]; wg/wu [E, d, f]; wd [E, f, d];
    valid [E, C] -> [E, C, d] in xg's dtype, rows with ``valid`` false 0.

    On a CUDA tensor it runs the expert-FFN kernel's two stages
    (``csrc/cache_moe.cu``) with expert e as slot e and its C rows as one
    group; on a CPU tensor the plain ``ref.moe_gemm_ref``.  No model path
    calls it, as in the reference.  ``moe_gemm.launches`` counts the calls
    that launched the kernels (not those inside a CUDA graph capture)."""
    refuse_autograd("moe_gemm", xg, wg, wu, wd)
    if xg.device.type == "cpu":
        return R.moe_gemm_ref(xg, wg, wu, wd, valid)
    E, C, d = xg.shape
    dev = xg.device
    i32 = torch.int32
    rows = torch.arange(E * C, dtype=i32, device=dev)
    g = K.SlotGroups(
        grp_slot=torch.arange(E, dtype=i32, device=dev),
        grp_start=torch.arange(0, E * C, C, dtype=i32, device=dev),
        grp_count=torch.full((E,), C, dtype=i32, device=dev),
        row_tok=rows, inv=rows.long(),
        valid=torch.ones((E * C, 1), dtype=torch.bool, device=dev))
    h = K.gate_up(xg.reshape(E * C, d).contiguous(), g, wg, wu)
    y = K.down(h, g, wd).reshape(E, C, d)
    if not torch.cuda.is_current_stream_capturing():
        moe_gemm.launches += 1
    return y * valid[..., None].to(y.dtype)


moe_gemm.launches = 0
