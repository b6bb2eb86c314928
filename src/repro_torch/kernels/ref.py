"""Plain PyTorch versions of the port's kernels.

They compute what the kernels compute, with plain tensor ops: the CPU path
of every kernel wrapper, and what ``chip_smoke.py`` holds each kernel against
on the card.  They may synchronise with the host (they loop over occupied
slots in Python); nothing on the main path calls them with a CUDA tensor,
except ``ssd_decode_ref``: the one-token recurrent SSD step, which the
reference too runs as plain array code and no kernel replaces.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# attention (causal + sliding window + GQA)
# ---------------------------------------------------------------------------

def _attn_mask(sq: int, skv: int, causal: bool, window: Optional[int],
               q0: int = 0, k0: int = 0, bq: Optional[int] = None,
               bk: Optional[int] = None, device=None) -> torch.Tensor:
    """[bq, bk] mask of queries q0.. against keys k0..; queries are
    right-aligned to the keys (absolute position i + skv - sq)."""
    bq = sq if bq is None else bq
    bk = skv if bk is None else bk
    qpos = q0 + torch.arange(bq, device=device)[:, None] + (skv - sq)
    kpos = k0 + torch.arange(bk, device=device)[None, :]
    m = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q: [B,Sq,H,D], k/v: [B,Skv,Hkv,D] -> [B,Sq,H,D].  f32 softmax over
    scores masked to -1e30 (the reference's ``attention_ref``)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, D)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg, k).float() / math.sqrt(D)
    m = _attn_mask(Sq, Skv, causal, window, device=q.device)
    s = torch.where(m[None, None, None], s,
                    torch.full((), NEG_INF, dtype=torch.float32,
                               device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkrqs,bskd->bqkrd", p, v).reshape(B, Sq, H, D)


def flash_blocks(sq: int, skv: int, block_q: int, block_k: int):
    """The reference's blocking (``flash_attention.py:82-84``): block sizes
    capped at the sequence lengths, which they must divide."""
    bq, bk = min(block_q, sq), min(block_k, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"flash attention: sequence lengths ({sq}, {skv}) "
                         f"must be multiples of the blocks ({bq}, {bk}); "
                         f"pad sequences to block multiples")
    return bq, bk


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        block_q: int = 128, block_k: int = 128
                        ) -> torch.Tensor:
    """Plain version of the flash-attention kernel: the reference's blocked
    online softmax (``_flash_kernel``) step by step, with its blocks.

    Per (q block, kv block): scores in f32 times 1/sqrt(D), masked to
    -1e30; m_new = max(m, rowmax s); p = exp(s - m_new) in f32;
    l = l·alpha + rowsum p; acc = acc·alpha + p (rounded to v's dtype) @ v
    in f32; out = acc / max(l, 1e-30) in q's dtype.  Every block is
    visited, masked or not."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    bq, bk = flash_blocks(Sq, Skv, block_q, block_k)
    scale = 1.0 / math.sqrt(D)
    qh = q.permute(0, 2, 1, 3).float()                     # [B,H,Sq,D]
    kh = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1).float()
    vh = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    out = torch.empty((B, H, Sq, D), dtype=q.dtype, device=q.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
    for i in range(Sq // bq):
        qb = qh[:, :, i * bq:(i + 1) * bq]
        m = torch.full((B, H, bq, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, H, bq, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, bq, D), dtype=torch.float32,
                          device=q.device)
        for j in range(Skv // bk):
            kb = kh[:, :, j * bk:(j + 1) * bk]
            vb = vh[:, :, j * bk:(j + 1) * bk]
            s = (qb @ kb.transpose(-1, -2)) * scale
            mask = _attn_mask(Sq, Skv, causal, window, i * bq, j * bk, bq,
                              bk, q.device)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).float() @ vb.float()
            m = m_new
        out[:, :, i * bq:(i + 1) * bq] = \
            (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# decode attention (one query per row against a long KV prefix)
# ---------------------------------------------------------------------------

def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """q: [B,H,D], k/v: [B,S,Hkv,D], lengths: [B] valid prefix -> [B,H,D]
    (the reference's ``decode_attention_ref``, in its order: scores in the
    input dtype, then f32 / sqrt(D), masked to -1e30, softmax, p cast to
    v's dtype, then the PV product)."""
    B, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, H // Hkv, D)
    s = torch.einsum("bkrd,bskd->bkrs", qg, k).float() / math.sqrt(D)
    valid = torch.arange(S, device=q.device)[None, :] < \
        lengths.to(q.device)[:, None]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, dtype=torch.float32,
                               device=q.device))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkrs,bskd->bkrd", p, v).reshape(B, H, D)


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

    Choices are stably sorted by slot and each routed row goes through its
    slot's weights as a product of one row: no [T·k, d, f] weight gather,
    and a row's bits do not depend on how many rows share the call (a
    product over several rows may sum each row in another order as the row
    count changes, which would make batched verify rounds differ from solo
    blocks).  The combine is in f32, in each token's choice order."""
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
        for p in range(lo, lo + counts[s]):
            ys[p:p + 1] = _expert(xs[p:p + 1], s, wu, wd, wg).float()
        lo += counts[s]
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


def slot_up_gelu_ref(x: torch.Tensor, row_tok: torch.Tensor,
                     wu: torch.Tensor, grp_slot: torch.Tensor,
                     grp_start: torch.Tensor, grp_count: torch.Tensor
                     ) -> torch.Tensor:
    """Plain version of the gelu stage-1 kernel: h[p] =
    gelu_tanh(x[row_tok[p]] @ wu[s]) for each sorted row p of group g with
    s = grp_slot[g], in x's dtype (``jax.nn.gelu`` is the tanh form by
    default).  Rows of no group are 0."""
    h = torch.zeros((row_tok.shape[0], wu.shape[2]), dtype=x.dtype,
                    device=x.device)
    for s, lo, n in zip(grp_slot.tolist(), grp_start.tolist(),
                        grp_count.tolist()):
        if n:
            xr = x[row_tok[lo:lo + n].long()]
            h[lo:lo + n] = F.gelu(xr @ wu[s], approximate="tanh")
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


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space dual) chunked scan
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: [..., L] -> [..., L, L] with out[i, j] = sum_{j<t<=i} x[t] for
    j <= i and -inf above the diagonal (so exp gives exactly 0 there)."""
    L = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    return torch.where(mask, seg, torch.full((), -math.inf,
                                             dtype=seg.dtype,
                                             device=x.device))


def ssd_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, chunk: int,
            init_state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (Mamba2, alg. 1 of arXiv:2405.21060), single B/C group:
    the reference's ``ssd_ref``, all maths in f32.

    x: [b,s,h,p]  dt: [b,s,h]  A: [h] (negative)  B, C: [b,s,n]; s must be
    a multiple of ``chunk``.  Returns (y [b,s,h,p] in x's dtype,
    final_state [b,h,p,n] f32).  ``init_state`` [b,h,p,n] is the state
    before the first token (zeros when omitted)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = B.reshape(b, nc, chunk, n).to(f32)
    Cc = C.reshape(b, nc, chunk, n).to(f32)
    dA = dtc * A.to(f32)                                       # [b,nc,l,h]
    dA_cum = torch.cumsum(dA, dim=2)                           # inclusive
    xdt = xc * dtc[..., None]                                  # [b,nc,l,h,p]
    # intra-chunk (diagonal blocks): (C B^T o L) (dt x)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))         # [b,nc,h,l,l]
    CB = torch.einsum("bcln,bcsn->bcls", Cc, Bc)               # [b,nc,l,l]
    y_diag = torch.einsum("bchls,bcshp->bclhp", CB[:, :, None] * Lmat, xdt)
    # each chunk's own contribution to the state at its end
    decay_to_end = torch.exp(dA_cum[:, :, -1:, :] - dA_cum)    # [b,nc,l,h]
    states = torch.einsum("bcln,bclhp->bchpn", Bc,
                          xdt * decay_to_end[..., None])       # [b,nc,h,p,n]
    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(dA_cum[:, :, -1, :])               # [b,nc,h]
    st = torch.zeros((b, h, p, n), dtype=f32, device=x.device) \
        if init_state is None else init_state.to(f32)
    prev = []
    for c in range(nc):
        prev.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                     # [b,nc,h,p,n]
    # off-diagonal contribution: C S, decayed from the chunk start
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev_states) \
        * torch.exp(dA_cum)[..., None]
    y = (y_diag + y_off).reshape(b, s, h, p)
    return y.to(x.dtype), st


def ssd_decode_ref(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                   A: torch.Tensor, B: torch.Tensor, C: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrent step.  state: [b,h,p,n]; x: [b,h,p]; dt: [b,h];
    A: [h]; B, C: [b,n] -> (y [b,h,p] in x's dtype, new state in state's
    dtype).  All maths in f32, in broadcasts (one kernel each on the card,
    where an ``einsum`` launches several)."""
    f32 = torch.float32
    dtf = dt.to(f32)
    dA = torch.exp(dtf * A.to(f32))                            # [b,h]
    upd = (dtf[:, :, None] * x.to(f32))[..., None] \
        * B.to(f32)[:, None, None, :]                          # [b,h,p,n]
    new = state.to(f32) * dA[:, :, None, None] + upd
    y = (new * C.to(f32)[:, None, None, :]).sum(dim=-1)
    return y.to(x.dtype), new.to(state.dtype)
