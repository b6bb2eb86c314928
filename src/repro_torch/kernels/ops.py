"""Kernel entry points of the port: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the kernel's plain version.  Nothing else."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import ref as R
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
# x [b,s,h,p], dt [b,s,h], A [h], B/C [b,s,n] -> (y, final state [b,h,p,n]):
from repro_torch.kernels.ssd_scan import ssd_scan as ssd  # noqa: F401


def cache_moe(x: torch.Tensor, slot_ids: torch.Tensor, weights: torch.Tensor,
              wu: torch.Tensor, wd: torch.Tensor,
              wg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Slot-indexed grouped expert FFN over ExpertCache slot buffers
    (SP-MoE verification hot path).  slot_ids < 0 contribute zero.
    ``cache_moe.launches`` counts the calls that launched the kernels (not
    those inside a CUDA graph capture, which launch nothing)."""
    if x.device.type == "cuda":
        y = K.cache_moe(x, slot_ids, weights, wu, wd, wg)
        if not torch.cuda.is_current_stream_capturing():
            cache_moe.launches += 1
        return y
    return R.cache_moe_ref(x, slot_ids, weights, wu, wd, wg)


cache_moe.launches = 0

