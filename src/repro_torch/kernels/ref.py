"""Plain PyTorch versions of the port's kernels.

They compute what the kernels compute, with plain tensor ops: the CPU path
of every kernel wrapper, and what ``chip_smoke.py`` holds each kernel against
on the card.  They may synchronise with the host (they loop over occupied
slots in Python); nothing on the main path calls them with a CUDA tensor.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# grouped expert GEMM (capacity-gathered layout)
# ---------------------------------------------------------------------------

def moe_gemm_ref(xg: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                 wd: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """xg: [E,C,d]; wg/wu: [E,d,f]; wd: [E,f,d]; valid: [E,C] -> [E,C,d].

    SwiGLU expert FFN applied per expert block, invalid rows zeroed."""
    h = F.silu(torch.einsum("ecd,edf->ecf", xg, wg))
    h = h * torch.einsum("ecd,edf->ecf", xg, wu)
    y = torch.einsum("ecf,efd->ecd", h, wd)
    return y * valid[..., None].to(y.dtype)


# ---------------------------------------------------------------------------
# slot-indexed cache MoE (SP-MoE verification hot path)
# ---------------------------------------------------------------------------

def _expert(xr: torch.Tensor, s: int, wu: torch.Tensor, wd: torch.Tensor,
            wg: Optional[torch.Tensor]) -> torch.Tensor:
    if wg is not None:
        h = F.silu(xr @ wg[s]) * (xr @ wu[s])
    else:
        h = F.gelu(xr @ wu[s], approximate="tanh")
    return h @ wd[s]


def cache_moe_ref(x: torch.Tensor, slot_ids: torch.Tensor,
                  weights: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
                  wg: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [T, d]; slot_ids/weights: [T, k]; wu/wg: [S, d, f]; wd: [S, f, d]
    -> [T, d].  Per (token, choice): y += w · FFN_{slot}(x); slot_ids < 0
    contribute 0.  swiglu when wg is given, tanh-gelu up-projection
    otherwise.

    Choices are stably sorted by slot and each occupied slot's rows go
    through that slot's weights in one product: no [T·k, d, f] weight
    gather.  The combine is in f32, in each token's choice order."""
    T, k = slot_ids.shape
    S = wu.shape[0]
    flat = slot_ids.reshape(-1).long()
    sane = torch.where(flat >= 0, flat, torch.full_like(flat, S))
    order = torch.sort(sane, stable=True).indices
    tok = order // k
    xs = x[tok]
    counts = torch.bincount(sane, minlength=S + 1).tolist()
    ys = torch.zeros((T * k, x.shape[1]), dtype=torch.float32,
                     device=x.device)
    lo = 0
    for s in range(S):
        hi = lo + counts[s]
        if hi > lo:
            ys[lo:hi] = _expert(xs[lo:hi], s, wu, wd, wg).float()
        lo = hi
    wf = torch.where(flat >= 0, weights.reshape(-1).float(),
                     torch.zeros((), dtype=torch.float32, device=x.device))
    y = torch.zeros((T, x.shape[1]), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, ys * wf[order][:, None])
    return y.to(x.dtype)


def slot_gate_up_ref(x: torch.Tensor, row_tok: torch.Tensor,
                     wg: torch.Tensor, wu: torch.Tensor,
                     grp_slot: torch.Tensor, grp_start: torch.Tensor,
                     grp_count: torch.Tensor) -> torch.Tensor:
    """Plain version of the stage-1 kernel: for each group g and each of its
    sorted rows p, h[p] = silu(x[row_tok[p]] @ wg[s]) * (x[row_tok[p]] @
    wu[s]) with s = grp_slot[g], in x's dtype.  Rows of no group are 0."""
    h = torch.zeros((row_tok.shape[0], wg.shape[2]), dtype=x.dtype,
                    device=x.device)
    for s, lo, n in zip(grp_slot.tolist(), grp_start.tolist(),
                        grp_count.tolist()):
        if n:
            xr = x[row_tok[lo:lo + n].long()]
            h[lo:lo + n] = F.silu(xr @ wg[s]) * (xr @ wu[s])
    return h


def slot_down_ref(h: torch.Tensor, wd: torch.Tensor, grp_slot: torch.Tensor,
                  grp_start: torch.Tensor, grp_count: torch.Tensor
                  ) -> torch.Tensor:
    """Plain version of the stage-2 kernel: y[p] = h[p] @ wd[grp_slot[g]]
    for every sorted row p of group g.  Rows of no group are 0."""
    y = torch.zeros((h.shape[0], wd.shape[2]), dtype=h.dtype, device=h.device)
    for s, lo, n in zip(grp_slot.tolist(), grp_start.tolist(),
                        grp_count.tolist()):
        if n:
            y[lo:lo + n] = h[lo:lo + n] @ wd[s]
    return y
