"""Speculative decoding (draft-then-verify, greedy acceptance) and the greedy
reference.  The port of ``repro/core/sd.py``.

Semantics follow Leviathan et al. with greedy (temperature-0) decoding, as
the paper does: the emitted sequence equals target-only greedy decoding.
Models own their weights (``models/transformer.py``), so the functions here
take models, not parameter trees; caches are updated in place.

Invariant: caches hold absolute positions 0..pos-1; ``cur`` is the token at
position ``pos`` that has not been fed yet.  One iteration:

  drafting     the draft model proposes d_1..d_N from cur;
  verification the target runs ONE forward over [cur, d_1..d_N] and accepts
               the longest matching prefix, then appends the correction /
               bonus token.

Rejected positions leave stale cache slots; the next block starts at
pos+n+1 and spans N+1 positions, so it overwrites them before they can be
attended.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch


class SDStepOut(NamedTuple):
    tokens: list             # emitted tokens (host ints), length n_emitted
    n_accepted: int          # accepted draft tokens, in [0, N]
    cur: torch.Tensor        # [B,1] next cur token
    pos: int                 # new pos
    dcache: Any
    tcache: Any


def _argmax_last(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def make_sd_step(draft_model, target_model, draft_len: int) -> Callable:
    """One SD iteration for batch-1 decoding (paper §4.2):
    ``sd_step(dcache, tcache, cur, pos) -> SDStepOut``."""
    N = draft_len

    def sd_step(dcache, tcache, cur: torch.Tensor, pos: int) -> SDStepOut:
        tok = cur
        drafts = []
        for i in range(N):
            lg, dcache, _ = draft_model.decode_step(dcache, tok, pos + i)
            tok = _argmax_last(lg)
            drafts.append(tok)
        block = torch.cat([cur] + drafts, dim=1)            # [B, N+1]
        tlogits, tcache, _ = target_model.decode_step(tcache, block, pos)
        # one readback: the verified argmax row and the drafts together
        both = torch.cat([torch.argmax(tlogits[0], dim=-1),
                          block[0, 1:]]).tolist()
        g, d = both[:N + 1], both[N + 1:]
        n_acc = 0
        while n_acc < N and d[n_acc] == g[n_acc]:
            n_acc += 1
        emitted = d[:n_acc] + [g[n_acc]]
        cur_next = torch.full_like(cur, g[n_acc])
        return SDStepOut(tokens=emitted, n_accepted=n_acc, cur=cur_next,
                         pos=pos + n_acc + 1, dcache=dcache, tcache=tcache)

    return sd_step


def _bump(stats: Optional[dict], iters=0, drafted=0, accepted=0):
    if stats is None:
        return
    stats["iterations"] = stats.get("iterations", 0) + iters
    stats["drafted"] = stats.get("drafted", 0) + drafted
    stats["accepted"] = stats.get("accepted", 0) + accepted


def adaptive_next_len(n: int, n_accepted: int, acc_ewma: float,
                      min_len: int, max_len: int, ewma: float
                      ) -> Tuple[int, float]:
    """The acceptance-EWMA draft-length controller, shared by
    ``sd_adaptive_stream`` and the offload engine's decode loop.

    ±1 steps keep the stale-cache overwrite invariant: the next block
    (N_new+1 tokens from pos+n+1) must cover the previous iteration's
    rejected writes (N_prev-n positions); N_new >= N_prev-1 suffices.
    Returns (next_n, next_ewma)."""
    frac = n_accepted / max(n, 1)
    acc_ewma = (1 - ewma) * acc_ewma + ewma * frac
    if acc_ewma > 0.8 and n < max_len:
        n += 1
    elif acc_ewma < 0.4 and n > min_len:
        n -= 1
    return n, acc_ewma


def greedy_stream(model, prompt: torch.Tensor, max_new_tokens: int,
                  max_seq: int, stats: Optional[dict] = None):
    """Vanilla autoregressive greedy decoding, one token per chunk."""
    if max_new_tokens <= 0:
        return
    logits, cache = model.prefill(prompt, max_seq)
    cur = torch.argmax(logits, dim=-1)[:, None]
    pos = prompt.shape[1]
    emitted = 1
    yield [int(cur[0, 0])]
    while emitted < max_new_tokens:
        lg, cache, _ = model.decode_step(cache, cur, pos)
        cur = _argmax_last(lg)
        pos += 1
        emitted += 1
        _bump(stats, iters=1)
        yield [int(cur[0, 0])]


def sd_stream(draft_model, target_model, prompt: torch.Tensor,
              max_new_tokens: int, draft_len: int, max_seq: int,
              stats: Optional[dict] = None):
    """Fixed-N speculative decoding, one chunk per verify block."""
    assert prompt.shape[0] == 1, "SD engine is batch-1 (paper §4.2)"
    if max_new_tokens <= 0:
        return
    step = make_sd_step(draft_model, target_model, draft_len)
    tlog, tcache = target_model.prefill(prompt, max_seq)
    _, dcache = draft_model.prefill(prompt, max_seq)
    cur = torch.argmax(tlog, dim=-1)[:, None]
    pos = prompt.shape[1]
    emitted = 1
    yield [int(cur[0, 0])]
    while emitted < max_new_tokens:
        res = step(dcache, tcache, cur, pos)
        cur, pos, dcache, tcache = res.cur, res.pos, res.dcache, res.tcache
        _bump(stats, iters=1, drafted=draft_len, accepted=res.n_accepted)
        chunk = res.tokens[:max_new_tokens - emitted]
        emitted += len(chunk)
        yield chunk


def sd_adaptive_stream(draft_model, target_model, prompt: torch.Tensor,
                       max_new_tokens: int, max_seq: int, min_len: int = 1,
                       max_len: int = 8, ewma: float = 0.5,
                       stats: Optional[dict] = None):
    """Acceptance-adaptive draft length, one chunk per verify block."""
    assert prompt.shape[0] == 1
    if max_new_tokens <= 0:
        return
    steps = {}
    tlog, tcache = target_model.prefill(prompt, max_seq)
    _, dcache = draft_model.prefill(prompt, max_seq)
    cur = torch.argmax(tlog, dim=-1)[:, None]
    pos = prompt.shape[1]
    emitted = 1
    yield [int(cur[0, 0])]
    n = min_len
    acc_ewma = 0.5
    while emitted < max_new_tokens:
        if n not in steps:
            steps[n] = make_sd_step(draft_model, target_model, n)
        res = steps[n](dcache, tcache, cur, pos)
        cur, pos, dcache, tcache = res.cur, res.pos, res.dcache, res.tcache
        _bump(stats, iters=1, drafted=n, accepted=res.n_accepted)
        n, acc_ewma = adaptive_next_len(n, res.n_accepted, acc_ewma,
                                        min_len, max_len, ewma)
        chunk = res.tokens[:max_new_tokens - emitted]
        emitted += len(chunk)
        yield chunk


def greedy_generate(model, prompt: torch.Tensor, max_new_tokens: int,
                    max_seq: int) -> torch.Tensor:
    """Vanilla autoregressive greedy decoding (the lossless reference)."""
    out: list = []
    for chunk in greedy_stream(model, prompt, max_new_tokens, max_seq):
        out.extend(chunk)
    return torch.tensor(out, dtype=torch.int64)
