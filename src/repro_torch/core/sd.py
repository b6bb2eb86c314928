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

Captured steps.  Given a ``GraphSet`` and a ``SessionPool``
(``core/graphs.py``; the engine's for offload none), a stream takes a pool
slot for its caches and runs each greedy step (``make_greedy_step``) and
each whole SD iteration (``make_sd_step``: N draft steps, the verify pass
and the argmax rows) as a captured step keyed by the slot and the steps'
routes, the port of the reference's jitted steps; it gives the slot back
on every exit.  Without them every step runs eagerly on caches of its own.
"""
from __future__ import annotations

import contextlib
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import torch

from repro_torch.core.graphs import GraphSet, SessionPool, SessionSlot


class SDStepOut(NamedTuple):
    tokens: list             # emitted tokens (host ints), length n_emitted
    n_accepted: int          # accepted draft tokens, in [0, N]
    cur: torch.Tensor        # [B,1] next cur token
    pos: int                 # new pos
    dcache: Any
    tcache: Any


def _argmax_last(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, -1], dim=-1)[:, None]


def make_greedy_step(model, graphs: Optional[GraphSet] = None) -> Callable:
    """One-token greedy step ``step(cache, cur, pos, slot=None) -> next
    token [B, 1]`` (the reference's jitted ``make_greedy_step``).  With
    ``graphs`` and the pool ``slot`` whose cache it is, the step runs as
    the captured step keyed by (slot, flash-decode route); its output is
    valid until the slot's next greedy step."""

    def step(cache, cur: torch.Tensor, pos: int,
             slot: Optional[SessionSlot] = None) -> torch.Tensor:
        if graphs is None or slot is None:
            lg, _, _ = model.decode_step(cache, cur, pos)
            return _argmax_last(lg)
        contiguous, flash = model.decode_route(cache, pos, 1)

        def body(t, p):
            return _argmax_last(model.decode_body(cache, t, pos, contiguous,
                                                  False, p)[0])
        nxt = graphs.run(("greedy", slot.index, flash), body, cur, pos)
        model.note_written(cache, pos, 1, contiguous)
        return nxt

    return step


def make_sd_step(draft_model, target_model, draft_len: int,
                 graphs: Optional[GraphSet] = None) -> Callable:
    """One SD iteration for batch-1 decoding (paper §4.2):
    ``sd_step(dcache, tcache, cur, pos, slot=None) -> SDStepOut``.  With
    ``graphs`` and the pool ``slot`` whose caches they are, the draft
    steps, the verify pass and the argmax rows run as one captured step
    keyed by (slot, N, each draft step's flash-decode route), the
    reference's jitted SD iteration; one readback either way."""
    N = draft_len

    def device(dcache, tcache, cur, pos, routes, tcontig, pos_dev=None):
        """-> [2N + 1]: the verified argmax row, then the drafts."""
        tok = cur
        drafts = []
        for i in range(N):
            p = None if pos_dev is None else pos_dev + i
            lg, _ = draft_model.decode_body(dcache, tok, pos + i, routes[i],
                                            False, p)
            tok = _argmax_last(lg)
            drafts.append(tok)
        block = torch.cat([cur] + drafts, dim=1)            # [B, N+1]
        tlogits, _ = target_model.decode_body(tcache, block, pos, tcontig,
                                              False, pos_dev)
        return torch.cat([torch.argmax(tlogits[0], dim=-1), block[0, 1:]])

    def sd_step(dcache, tcache, cur: torch.Tensor, pos: int,
                slot: Optional[SessionSlot] = None) -> SDStepOut:
        # the host's routes, with the written prefixes each step leaves
        shadow = dict(dcache)
        routes, flashes = [], []
        for i in range(N):
            contiguous, flash = draft_model.decode_route(shadow, pos + i, 1)
            draft_model.note_written(shadow, pos + i, 1, contiguous)
            routes.append(contiguous)
            flashes.append(flash)
        tcontig, _ = target_model.decode_route(tcache, pos, N + 1)
        if graphs is None or slot is None:
            out = device(dcache, tcache, cur, pos, routes, tcontig)
        else:
            key = ("sd", slot.index, N, tuple(flashes))
            out = graphs.run(key, lambda c, p: device(
                dcache, tcache, c, pos, routes, tcontig, p), cur, pos)
        if "written" in shadow:
            dcache["written"] = shadow["written"]
        target_model.note_written(tcache, pos, N + 1, tcontig)
        # one readback: the verified argmax row and the drafts together
        both = out.tolist()
        g, d = both[:N + 1], both[N + 1:]
        n_acc = 0
        while n_acc < N and d[n_acc] == g[n_acc]:
            n_acc += 1
        emitted = d[:n_acc] + [g[n_acc]]
        cur_next = torch.full_like(cur, g[n_acc])
        return SDStepOut(tokens=emitted, n_accepted=n_acc, cur=cur_next,
                         pos=pos + n_acc + 1, dcache=dcache, tcache=tcache)

    return sd_step


def _bump(stats: Optional[dict], iters=0, drafted=0, accepted=0, **extra):
    if stats is None:
        return
    stats["iterations"] = stats.get("iterations", 0) + iters
    stats["drafted"] = stats.get("drafted", 0) + drafted
    stats["accepted"] = stats.get("accepted", 0) + accepted
    for k, v in extra.items():
        stats.setdefault(k, []).append(v)


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


@contextlib.contextmanager
def _session_slot(pool: Optional[SessionPool]
                  ) -> Iterator[Optional[SessionSlot]]:
    """A pool slot for one stream's caches, given back on every exit (a
    generator closed early runs this ``finally`` too)."""
    if pool is None:
        yield None
        return
    slot = pool.take()
    try:
        yield slot
    finally:
        pool.give(slot)


def _caches(slot: Optional[SessionSlot]) -> Tuple[Any, Any]:
    """(target cache, draft cache) to prefill into: the slot's, or new."""
    return (None, None) if slot is None else (slot.tcache, slot.dcache)


def greedy_stream(model, prompt: torch.Tensor, max_new_tokens: int,
                  max_seq: int, stats: Optional[dict] = None,
                  graphs: Optional[GraphSet] = None,
                  pool: Optional[SessionPool] = None):
    """Vanilla autoregressive greedy decoding, one token per chunk."""
    if max_new_tokens <= 0:
        return
    step = make_greedy_step(model, graphs)
    with _session_slot(pool) as slot:
        logits, cache = model.prefill(prompt, max_seq,
                                      cache=_caches(slot)[0])
        cur = torch.argmax(logits, dim=-1)[:, None]
        pos = prompt.shape[1]
        emitted = 1
        yield [int(cur[0, 0])]
        while emitted < max_new_tokens:
            cur = step(cache, cur, pos, slot)
            pos += 1
            emitted += 1
            _bump(stats, iters=1)
            yield [int(cur[0, 0])]


def _sd_iterations(draft_model, target_model, prompt, max_new_tokens,
                   max_seq, pool, stats, step_for, next_len, n):
    """The SD loop of the fixed and the adaptive stream: prefill both
    models (into a pool slot's caches where ``pool`` is given), then one
    ``step_for(n)`` iteration per chunk, the next draft length from
    ``next_len(n, n_accepted)``."""
    with _session_slot(pool) as slot:
        tc, dc = _caches(slot)
        tlog, tcache = target_model.prefill(prompt, max_seq, cache=tc)
        _, dcache = draft_model.prefill(prompt, max_seq, cache=dc)
        cur = torch.argmax(tlog, dim=-1)[:, None]
        pos = prompt.shape[1]
        emitted = 1
        yield [int(cur[0, 0])]
        while emitted < max_new_tokens:
            res = step_for(n)(dcache, tcache, cur, pos, slot)
            cur, pos = res.cur, res.pos
            _bump(stats, iters=1, drafted=n, accepted=res.n_accepted)
            n = next_len(n, res.n_accepted)
            chunk = res.tokens[:max_new_tokens - emitted]
            emitted += len(chunk)
            yield chunk


def sd_stream(draft_model, target_model, prompt: torch.Tensor,
              max_new_tokens: int, draft_len: int, max_seq: int,
              stats: Optional[dict] = None,
              graphs: Optional[GraphSet] = None,
              pool: Optional[SessionPool] = None):
    """Fixed-N speculative decoding, one chunk per verify block."""
    assert prompt.shape[0] == 1, "SD engine is batch-1 (paper §4.2)"
    if max_new_tokens <= 0:
        return
    step = make_sd_step(draft_model, target_model, draft_len, graphs)
    yield from _sd_iterations(draft_model, target_model, prompt,
                              max_new_tokens, max_seq, pool, stats,
                              lambda n: step, lambda n, n_acc: n, draft_len)


def sd_adaptive_stream(draft_model, target_model, prompt: torch.Tensor,
                       max_new_tokens: int, max_seq: int, min_len: int = 1,
                       max_len: int = 8, ewma: float = 0.5,
                       stats: Optional[dict] = None,
                       graphs: Optional[GraphSet] = None,
                       pool: Optional[SessionPool] = None):
    """Acceptance-adaptive draft length, one chunk per verify block; one
    SD step (one captured step per slot, with ``graphs``) per ladder
    length."""
    assert prompt.shape[0] == 1
    if max_new_tokens <= 0:
        return
    steps = {}
    acc_ewma = 0.5

    def step_for(n: int):
        if n not in steps:
            steps[n] = make_sd_step(draft_model, target_model, n, graphs)
        return steps[n]

    def next_len(n: int, n_accepted: int) -> int:
        nonlocal acc_ewma
        _bump(stats, draft_lens=n)
        n, acc_ewma = adaptive_next_len(n, n_accepted, acc_ewma, min_len,
                                        max_len, ewma)
        return n

    yield from _sd_iterations(draft_model, target_model, prompt,
                              max_new_tokens, max_seq, pool, stats, step_for,
                              next_len, min_len)


def sd_generate(draft_model, target_model, prompt: torch.Tensor,
                max_new_tokens: int, draft_len: int, max_seq: int
                ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """One-shot fixed-N SD: prompt [1, P] -> (tokens [<= max_new_tokens],
    stats).  Thin wrapper over :func:`sd_stream`."""
    c: Dict[str, Any] = {}
    out: list = []
    for chunk in sd_stream(draft_model, target_model, prompt, max_new_tokens,
                           draft_len, max_seq, stats=c):
        out.extend(chunk)
    iters = c.get("iterations", 0)
    return torch.tensor(out, dtype=torch.int64), {
        "iterations": iters,
        "acceptance_rate": c.get("accepted", 0) / max(iters * draft_len, 1),
        "tokens_per_iteration": len(out) / max(iters, 1)}


def sd_generate_adaptive(draft_model, target_model, prompt: torch.Tensor,
                         max_new_tokens: int, max_seq: int, min_len: int = 1,
                         max_len: int = 8, ewma: float = 0.5
                         ) -> Tuple[torch.Tensor, Dict[str, float]]:
    """Acceptance-adaptive draft length (beyond the paper): an EWMA of
    each iteration's acceptance grows or shrinks N between ``min_len`` and
    ``max_len``; lossless for any schedule.  Thin wrapper over
    :func:`sd_adaptive_stream`."""
    c: Dict[str, Any] = {}
    out: list = []
    for chunk in sd_adaptive_stream(draft_model, target_model, prompt,
                                    max_new_tokens, max_seq, min_len=min_len,
                                    max_len=max_len, ewma=ewma, stats=c):
        out.extend(chunk)
    iters = c.get("iterations", 0)
    lens = c.get("draft_lens", [])
    return torch.tensor(out, dtype=torch.int64), {
        "iterations": iters,
        "acceptance_rate": c.get("accepted", 0) / max(c.get("drafted", 0), 1),
        "tokens_per_iteration": len(out) / max(iters, 1),
        "final_draft_len": lens[-1] if lens else min_len,
        "mean_draft_len": sum(lens) / len(lens) if lens else float(min_len)}


def greedy_generate(model, prompt: torch.Tensor, max_new_tokens: int,
                    max_seq: int) -> torch.Tensor:
    """Vanilla autoregressive greedy decoding (the lossless reference)."""
    out: list = []
    for chunk in greedy_stream(model, prompt, max_new_tokens, max_seq):
        out.extend(chunk)
    return torch.tensor(out, dtype=torch.int64)
