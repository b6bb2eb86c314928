#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's SP-MoE serving paths (decode="sd" x offload="spmoe",
``attn_impl="kernel"``) on mixtral-8x7b at full width (d_model 4096, 32/8
heads x 128, expert d_ff 14336, 8 experts top-2, vocab 32000, sliding window
4096) with its dense mistral-7b draft, both cut to 4 layers, random weights
from fixed seeds.  Every admitted request prefills its draft through the
flash-attention kernel, drafts through the flash-decode kernel and verifies
through the expert-FFN kernels.  Then the same with gelu experts, the
SSD families' path (decode="greedy" x offload="none": mamba2-780m at full
width and full depth (48 layers, d_model 1536, 48 heads x 64, state 128,
vocab 50280) and zamba2-7b at full width cut to 12 layers (two groups of 5
mamba layers around the shared attention block), bf16, random weights from
seed 0; every prefill runs each mamba layer through the SSD-scan kernel),
the dense target llama3.2-3b at full width and full depth, greedy and
speculative, every one-token step through flash-decode, and
deepseek-v2-lite-16b (MLA, one leading dense layer, shared experts, 64
experts top-6) at full width cut to 1 dense + 3 MoE layers (its 26 MoE
layers' 1664 routed experts would be 28.8 GB on the host, plus pinned
staging), sd x spmoe with its derived dense MLA draft and with its MoE
self-draft, through the expert-FFN kernels at top-6, and phi-3.5-moe (16
experts top-2 of width 6400) at full width cut to 4 layers with its MoE
draft phi-mini-moe (experts of width 960, resident on the card), whose
every draft step runs its MoE layers through the expert-FFN kernels with
no host sync.

Phases (each raises on failure):
  1. device line; build the CUDA kernels from ``src/repro_torch/csrc``
  2. each kernel against its plain PyTorch version at full-width shapes,
     bf16 and f32 (expert FFN at T 1 / 5 / 64 / 512 with a batch-invariance
     check, for swiglu experts and for gelu experts' up-gelu stage, timed at
     T 5 and T 512; flash
     attention at S 64 / 512 / 2048 causal, 1024 with a 256 window and 8192
     with the 4096 window (32 / 8 heads), and S 512 at 24 / 8 heads (the
     llama3.2-3b draft's widths), and at S 512 at the other head shapes of
     the registered configs (32 / 32 x 112, zamba2-7b; 96 / 8 x 192,
     nemotron-4-340b; 48 / 1 x 128, granite-20b; and 384 with a 100 window
     at 96 / 8 x 192), each timed shape one device kernel per
     call; flash-decode at the llama3.2-3b and mixtral-draft
     widths and those three, lengths 1 / 77 / 512 / 543 / 4096 in caches of
     576 and 4112, and three rows of mixed lengths each equal to its one-row
     call bit for bit; the SSD scan at the mamba2 widths at S 77 / 300 / 512 / 2048 and
     the zamba2 widths at S 512 and 300, 300 padded to 384, y and final
     state, timed (event and device time, its three device kernels per
     call) at mamba2 S 512 / 2048 and zamba2 S 512)
  3. solo serving with a tight cache (12 slots): misses, prefetches,
     evictions
  4. solo serving with an ample cache (32 slots): the fast path, <=2 host
     syncs per fast block; then a timed breakdown of one fast verify block,
     and that block and the drafting stage as the engine serves them, a
     captured step replayed (``core/graphs.py``), against their eager
     bodies: bit for bit, event ms, and in one traced call its span on the
     device, busy ms, kernels and idle share
  5. concurrent serving (``Engine.serve_all``, 4 requests of 512-token
     prompts, 2 at a time, ample cache): fused rounds, <=2 host syncs per
     round, and one all-hit round's logits equal to each session's solo fast
     block on the same cache snapshot, bit for bit
  6. lossless check: every emitted token of phases 3-5 against the
     resident-expert model run teacher-forced over the stream (argmax, or
     within a stated margin)
  7. gelu experts: mixtral-8x7b widths with ``ffn_activation="gelu"`` (a
     variant the config allows, not a published model), 2 layers, sd x
     spmoe, one 64-token request: up-gelu and down launch, gate_up never;
     every token teacher-forced
  8. mamba2-780m serving through ``Engine.submit``: two 512-token prompts
     and one of 300, 32 new tokens each; the SSD kernel launches once per
     layer per prefill (48 per request); then one prefill and one decode
     step timed alone and traced with ``torch.profiler`` (the device's
     kernels, their busy time with the SSD scan's apart, its idle share;
     the traced SSD kernels must be three per mamba layer)
  9. zamba2-7b serving, one 512-token prompt, the same way (10 launches),
     under ``attn_impl="kernel"``: its shared attention block (32 / 32 heads
     x 112) runs flash attention in the prefill and flash-decode in every
     greedy step; both must have launched
 10. lossless check of phases 8-9: every emitted token against the same
     model run teacher-forced over the stream on the card, which holds the
     recurrent decode step against the chunked kernel
 11. llama3.2-3b (28 layers, d 3072, 24 / 8 heads x 128, vocab 128256)
     through ``Engine.submit``: a 512-token prompt greedy x none (one
     flash-decode launch per layer per target step) and one sd x none with
     the derived 14-layer draft (one per layer per draft step), 32 new
     tokens each; one warm greedy decode step timed alone and traced; the
     greedy step and the sd x none iteration replayed against their eager
     bodies (as in phase 4); every token teacher-forced
 12. deepseek-v2-lite-16b (d 2048, 16 MLA heads, latent 512, 64 experts
     top-6 of width 1408, 2 shared, vocab 102400; 1 dense + 3 MoE layers,
     bf16, ``attn_impl="kernel"``): the expert FFN against its plain
     version at top-6 over a 48-slot pool (T 1 / 5 / 64 / 512, bf16 and
     f32, batch invariance; timed at T 5 and T 512); sd x spmoe with a
     tight cache (48 slots for 192 experts: misses, waves, evictions) and
     an ample one (192 slots: <= 2 host syncs per fast block, counters
     reset after the first request); two 256-token requests two at a time
     on a cache preloaded with every expert (fused rounds, <= 2 syncs each,
     one all-hit round equal to the solo blocks bit for bit); no attention
     kernel launches (MLA is plain tensor ops); one request with the MoE
     self-draft (the target's architecture, seed 1, its experts on the
     card) on a preloaded 192-slot cache, every drafted token through the
     draft's MoE layers on the kernel; the ample engine's fast verify block
     and the self-draft's drafting stage replayed against their eager
     bodies (as in phase 4); every token teacher-forced
 13. phi-3.5-moe (d 4096, 32 / 8 heads x 128, vocab 32064, 16 experts
     top-2 of width 6400; 4 layers, bf16, ``attn_impl="kernel"``) with its
     MoE draft phi-mini-moe (16 experts of width 960, 4 layers, resident):
     the expert FFN against its plain version at the target's widths (a
     16-slot pool, timed at T 5) and the draft's (its 16 experts, timed at
     T 1 and T 512), bf16 and f32, batch invariance; sd x spmoe with a
     tight cache (16 slots for 64 experts) and an ample one (64 slots: <= 2
     host syncs per fast block, counters reset after the first request),
     every drafted token through the draft's MoE layers on the kernel; one
     MoE draft decode step under CUDA sync debugging against the derived
     dense draft's of the same depth (no more syncs; one gate_up and one
     down launch per MoE layer), both drafting stages timed; the fast
     verify block and the MoE drafting stage replayed against their eager
     bodies (as in phase 4); every token teacher-forced

Every serving engine runs with ``EngineConfig.precompile`` on: its fast
verify blocks of the ladder length, its draft steps, and (offload none) its
greedy steps and sd iterations are replays of captured steps.  A replay
calls no kernel wrapper, so the wrappers count only the launches they make
(eager calls, a build's warm-up); a capture launches nothing.

Each serving path (3-4, 5, 7, 8, 9, 11 greedy, 11 sd, 12 solo, 12
concurrent, 12 self-draft and 13 solo) runs with the kernels' launch counts
set to 0 and a ``torch.profiler`` trace of the device started just before
it, both read just after: a kernel's launches on the path are the calls
whose kernels the device ran in the trace (replays included), beside the
wrappers' own counts.  The SSD paths (8, 9) capture nothing and go
untraced: there every launch is its wrapper's own.  Each kernel of the path must have launched through
its wrapper and run on the device, and every counted launch must have run.
Where a path has an MoE draft (12 self-draft, 13), a marker kernel before
and after each draft step tells the draft's expert-FFN kernels apart in the
trace: every drafted token must have run each MoE layer of the draft.

Prints JSON lines (kernels, decode_timing, flash_timing, ssd_timing,
kernel_checks, requests, ssm_requests, gelu_requests, dense_requests,
deepseek_requests, deepseek_kernel_timing, phi_requests, phi_kernel_timing,
breakdown, graphs (every eager-against-replay measure, each engine's builds,
capture seconds and private pool bytes, the concurrent engines' fused
rounds among them), memory), then the
card's name and power limit, then ``{"ok":
true, "device": {...}}`` as the last line.  Exits non-zero, printing no
result, without a CUDA device or without the rest of the repository.
Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import resource
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

S_POOL, K_TOP = 12, 2                 # phase-2 pool and routing width
BLOCK_T = 5                           # verify block: draft_len 4 + 1
HBM_BYTES_S = 3.35e12                 # H100 SXM memory rate
BF16_FLOPS = 989e12                   # H100 SXM dense bf16 tensor rate
# f32: kernel and plain version differ only in summation order over 4096 /
# 14336 terms (~sqrt(n) * 6e-8 relative): 1e-4 of the output's scale.
# bf16: the kernel rounds once from f32, the plain version rounds the two
# GEMM outputs, silu and the product each to bf16 (2^-8 relative apiece).
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# flash attention at the mixtral widths, held per query row to that row's
# own max |out| (a row that sees many keys has a small output).  f32: kernel
# and plain version sum the same products in another order (and p is not
# rounded): 1e-4.  bf16: both round p to bf16 relative to the running max of
# 128-key tiles, but sum in another order (so p may round across a bf16
# step), and each rounds the output once, which may differ by one bf16 step
# (up to 2^-7 of an element): 1e-2.
FA_HEADS, FA_KV_HEADS, FA_DIM = 32, 8, 128
LLAMA_HEADS = 24                      # llama3.2-3b (and its draft): 24 / 8
FA_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
# the other head shapes of the registered configs: (model, q heads, kv
# heads, head dim); zamba2-7b's shared block serves under attn_impl="kernel"
# in phase 9, nemotron-4-340b and granite-20b are the reference's configs
# the port has yet to register (at D 192 the bf16 kernel takes 64-key tiles,
# which moves where p rounds by at most one bf16 step)
FA_SHAPES = (("zamba2-7b", 32, 32, 112), ("nemotron-4-340b", 96, 8, 192),
             ("granite-20b", 48, 1, 128))
# lossless check: the engine (5-token verify blocks, f32 expert combine) and
# the resident reference (one teacher-forced forward, bf16 combine) round
# the bf16 residual stream at different places; a token that is not the
# reference's argmax must be within this many logits of it.
MARGIN = 0.25
CONC_PROMPT, CONC_NEW, CONC_REQS = 512, 32, 4     # phase 5
# SSD scan: (model, heads, head dim p, state n, sequence lengths); a length
# past 128 that 128 does not divide is padded at the end with dt = 0, as
# mamba_forward pads it.  Tolerance of y relative to its max |value|: f32
# differs from the plain version in summation order and in how the prefix
# sums of dt*A are taken; bf16 also in y's one rounding (2^-8 of an
# element).  The final state is f32 in both types: 1e-4.
SSD_SHAPES = (("mamba2", 48, 64, 128, (77, 300, 512, 2048)),
              ("zamba2", 112, 64, 64, (512, 300)))
SSD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_STATE_TOL = 1e-4
# timed (bf16): (model, S); a call is three device kernels (each chunk's end
# state, the carry from chunk to chunk, y)
SSD_TIMED = (("mamba2", 512), ("mamba2", 2048), ("zamba2", 512))
SSD_KERNELS_PER_CALL = 3
SSM_PROMPTS, SSM_NEW = (512, 512, 300), 32            # phase 7
ZAMBA_LAYERS = 12                                     # phase 8
# lossless check of the SSD families: the engine (chunked prefill, then the
# recurrent step in f32 with its own conv) and the teacher-forced forward
# round the bf16 residual stream at different places through 48 layers.  A
# token that is not the reference's argmax must be within this many logits
# of it (on an H100 the worst gap moved between 0.09 and 0.31 as only the
# kernel's f32 summation order changed), and at least this share of the
# tokens must be the exact argmax, so that a wrong recurrent step, whose
# tokens would fall near the top of random-weight logits, cannot pass.
SSM_MARGIN, SSM_MIN_EXACT = 0.5, 0.8
# flash-decode: (model, q heads, kv heads, head dim) and (cache length,
# three mixed lengths, the model timed at the first of them).  Tolerance:
# the reference's own sweep (tests/test_kernels.py), atol 2e-5 f32 / 2e-2
# bf16 plus rtol 1e-2: f32 differs in summation order and where the softmax
# is split, bf16 also in that the plain version rounds the scores and p to
# bf16 (as the reference's decode_attention_ref) and the kernel p only.
DECODE_WIDTHS = (("llama3.2-3b", 24, 8, 128),
                 ("mistral-7b-draft", 32, 8, 128), *FA_SHAPES)
DECODE_CACHES = ((576, (543, 1, 77), ("llama3.2-3b", "zamba2-7b")),
                 (4112, (4096, 1, 512), ("mistral-7b-draft",)))
DECODE_LENGTHS = (1, 77, 512, 543, 4096)
DECODE_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DECODE_RTOL = 1e-2
# the gelu-expert phase: mixtral-8x7b widths with ffn_activation="gelu"
GELU_LAYERS, GELU_PROMPT, GELU_NEW = 2, 64, 16
# the dense phase: llama3.2-3b at full width and depth; its one-token
# steps read a cache of DENSE_MAX_SEQ slots.  Lossless check: the engine
# (cached decode steps through flash-decode, verify blocks of five) and
# the teacher-forced forward round the bf16 residual stream at different
# places through 28 layers: the deep stacks' rule of the SSD phases.
DENSE_PROMPT, DENSE_NEW, DENSE_MAX_SEQ = 512, 32, 576
DENSE_MARGIN, DENSE_MIN_EXACT = SSM_MARGIN, SSM_MIN_EXACT

# the deepseek phase: deepseek-v2-lite-16b at full width (d 2048, 16 MLA
# heads of nope 128 + rope 64 / v 128, latent 512, 64 experts top-6 of width
# 1408, 2 shared, vocab 102400) cut to 1 dense + 3 MoE layers; pools of 48
# (tight: 3 x 64 = 192 experts) and 192 slots (ample: every expert).  Its
# kernel check times the expert FFN at top-6 over the 48-slot pool; the
# T 512 call routes into all 48 slots (~64 rows a slot).
DS_LAYERS, DS_TIGHT, DS_AMPLE = 4, 48, 192
DS_D, DS_F, DS_K = 2048, 1408, 6
DS_PROMPT, DS_NEW = 64, 32
DS_CONC_PROMPT, DS_CONC_REQS = 256, 2
# expert FFN launches on its path; MLA runs no attention kernel
DS_PATH = ("cache_moe_gate_up", "cache_moe_down")
# lossless check: the deep stacks' rule (a margin and a minimum exact share)
# rather than mixtral's margin alone.  Top-6 of 64 routes each token through
# its 6th and 7th experts at near-equal gate probabilities; the engine (f32
# expert combine, 5-token blocks) and the resident reference (bf16 combine
# of 6 terms, one forward) round the gate input differently, so a near-tie
# may pick the other expert in one of them, which moves that token's logits
# by more than mixtral's top-2 of 8 tolerates.
DS_MARGIN, DS_MIN_EXACT = SSM_MARGIN, SSM_MIN_EXACT
DS_SELF_PROMPT, DS_SELF_SEED = 64, 90    # the MoE self-draft's request

# the phi phase: phi-3.5-moe at full width (d 4096, 32 / 8 heads x 128,
# vocab 32064, 16 experts top-2 of width 6400) with its MoE draft
# phi-mini-moe (16 experts top-2 of width 960, resident on the card), both
# cut to 4 layers, the depth that keeps the Table 1 pair layer for layer:
# the target's 64 routed experts are 10.1 GB of bf16 on the host (at full
# depth 80.5 GB).  Pools of 16 (tight) and 64 slots (ample: every expert).
# The expert FFN is checked and timed at the target's verify block (T 5,
# a 16-slot pool) and at the draft's step (T 1) and prefill (T 512) over
# its 16 resident experts.
PHI_LAYERS, PHI_TIGHT, PHI_AMPLE = 4, 16, 64
PHI_D, PHI_F, PHI_DRAFT_F, PHI_E, PHI_K = 4096, 6400, 960, 16, 2
PHI_PROMPT, PHI_NEW = 64, 32
# lossless check: the deep stacks' rule, as for deepseek.  Top-2 of 16
# routes many tokens through a second and third expert of near-equal gate
# probability; the engine (f32 expert combine, 5-token blocks) and the
# resident reference (``moe_global``: bf16 combine, one forward through
# flash) round the gate input differently, so a near-tie may pick the other
# expert in one of them, which moves that token's logits by more than
# mixtral's margin.
PHI_MARGIN, PHI_MIN_EXACT = SSM_MARGIN, SSM_MIN_EXACT


T_START = time.perf_counter()


def log(msg: str):
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", file=sys.stderr,
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def device_spans(fn, iters: int, keep=None, tries: int = 5):
    """Durations (us) of the device activities ``torch.profiler`` saw over
    ``iters`` warm calls of ``fn``, those whose names ``keep`` accepts where
    it is given.  A window can come back without them (seen right after a
    plain version's thousands of launches, and once in the phi draft's
    expert-FFN timing): it is traced again, after a pause, before failing."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = [e.time_range.end - e.time_range.start for e in seen
                 if keep is None or keep(e.name)]
        if spans:
            return spans
        log(f"the profiler saw none of the device activity sought (window "
            f"{attempt + 1} of {tries}; {len(seen)} other activities, "
            f"{sorted({e.name[:60] for e in seen})[:3]}); tracing again")
        time.sleep(0.5)
    return []


def traced(fn, iters: int = 50):
    """Device time per call of ``fn`` in ms, the summed durations of the
    kernels and copies ``torch.profiler`` saw over ``iters`` warm calls
    (unlike ``cuda_ms``, not set by the host's issue time), and the device
    activities per call."""
    spans = device_spans(fn, iters)
    if not spans:
        raise AssertionError("the profiler saw no device activity")
    # the profiler may drop an event or two of a long window: count whole
    # activities per call, and time them by the mean of those it kept
    per_call = max(1, round(len(spans) / iters))
    return sum(spans) / len(spans) * per_call / 1e3, per_call


def traced_ms(fn, iters: int = 50) -> float:
    return traced(fn, iters)[0]


def kernel_device_ms(fn, prefix: str, iters: int = 10) -> float:
    """Device time per call of ``fn``'s kernels whose names start with
    ``prefix`` (one kernel of several that a call launches), from
    ``torch.profiler``."""
    spans = device_spans(
        fn, iters, lambda name: name.split("<")[0].split("::")[-1]
        .split("(")[0].removeprefix("void ").startswith(prefix))
    if not spans:
        raise AssertionError(f"the profiler saw no {prefix} kernel")
    return sum(spans) / len(spans) / 1e3          # one such kernel a call


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev, d: int, f: int, gelu: bool = False, k: int = K_TOP,
                 pool: int = S_POOL, prefill_slots: int = 8, seed: int = 0,
                 timed=(BLOCK_T, CONC_PROMPT)):
    """The expert-FFN stages against their plain versions at T 1 / 5 / 64 /
    512, bf16 and f32, with a batch-invariance check: swiglu experts
    (gate_up, then down), or with ``gelu`` the gelu experts' route (up_gelu,
    then down).  Each token takes ``k`` slots of a ``pool``-slot pool; the
    T 512 call (a prefill block) routes into its first ``prefill_slots``.
    The bf16 calls at the row counts ``timed`` are timed."""
    import torch
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import ref as R
    stage1 = "cache_moe_up_gelu" if gelu else "cache_moe_gate_up"
    experts = "gelu" if gelu else "swiglu"
    gen = torch.Generator(dev).manual_seed(seed)
    rows, main = [], {}
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        def w(shape, fan):
            return (torch.randn(shape, generator=gen, device=dev)
                    * fan ** -0.5).to(dt)
        wg = None if gelu else w((pool, d, f), d)
        wu = w((pool, d, f), d)
        wd = w((pool, f, d), f)
        outs = {}
        for T in (1, BLOCK_T, 64, CONC_PROMPT):
            x = torch.randn((T, d), generator=gen, device=dev).to(dt)
            # T = CONC_PROMPT is a target's prefill block: its experts all
            # resident (mixtral: its 8, about 128 rows per slot)
            lo_s, hi_s = (0, prefill_slots) if T == CONC_PROMPT \
                else (-1, pool)
            si = torch.randint(lo_s, hi_s, (T, k), generator=gen,
                               device=dev).to(torch.int32)
            if T > 1 or 1 not in timed:   # a timed T 1 is a draft step
                si[0, 0] = -1                         # a miss
            if T > 1:
                si[1, 1] = si[1, 0] = max(int(si[1, 0]), 0)   # a repeat
            wt = torch.rand((T, k), generator=gen, device=dev).to(dt)
            g = K.slot_groups(si, pool)
            if gelu:
                h = K.up_gelu(x, g, wu)
                h_ref = R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot,
                                           g.grp_start, g.grp_count)
            else:
                h = K.gate_up(x, g, wg, wu)
                h_ref = R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot,
                                           g.grp_start, g.grp_count)
            y = K.down(h, g, wd)
            y_ref = R.slot_down_ref(h, wd, g.grp_slot, g.grp_start,
                                    g.grp_count)
            full = K.cache_moe(x, si, wt, wu, wd, wg)
            full_ref = R.cache_moe_ref(x, si, wt, wu, wd, wg)
            torch.cuda.synchronize()
            for name, got, want in ((stage1, h, h_ref),
                                    ("cache_moe_down", y, y_ref),
                                    ("cache_moe", full, full_ref)):
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                ok = torch.isfinite(got).all().item() and \
                    err <= TOL[dt_name] * max(scale, 1e-6)
                rows.append({"kernel": name, "experts": experts,
                             "dtype": dt_name, "T": T, "max_abs_err": err,
                             "max_rel_err": err / max(scale, 1e-30),
                             "tol_rel": TOL[dt_name], "ok": bool(ok)})
                if not ok:
                    raise AssertionError(f"{name} ({experts}) {dt_name} "
                                         f"T={T}: max abs err {err} vs "
                                         f"scale {scale}")
            outs[T] = (x, si, wt, full)
            if dt_name == "bfloat16" and T in timed:
                main[T] = dict(x=x, si=si, wt=wt, g=g, h=h, wg=wg, wu=wu,
                               wd=wd,
                               err={stage1: rows[-3]["max_abs_err"],
                                    "cache_moe_down": rows[-2]["max_abs_err"]})
        # batch invariance: each row of the T=5 and T=512 calls equals its
        # own T=1 call, bit for bit
        for T in (BLOCK_T, CONC_PROMPT):
            x, si, wt, full = outs[T]
            for t in range(T):
                one = K.cache_moe(x[t:t + 1], si[t:t + 1], wt[t:t + 1], wu,
                                  wd, wg)
                if not torch.equal(one, full[t:t + 1]):
                    raise AssertionError(f"{experts} {dt_name}: row {t} of "
                                         f"the T={T} call differs from its "
                                         f"T=1 call")
            rows.append({"check": "batch_invariance", "experts": experts,
                         "dtype": dt_name, "T": T, "ok": True})
        if dt_name == "bfloat16":
            for T in timed:
                main[T]["timing"] = time_kernels(main[T], d, f, gelu)
                for name in ("x", "si", "wt", "g", "h", "wg", "wu", "wd"):
                    del main[T][name]
        del wg, wu, wd, outs
        gc.collect()
        torch.cuda.empty_cache()
    return rows, main


def time_kernels(m, d: int, f: int, gelu: bool = False):
    """Kernel, plain and library times of one call (bf16, the phase's k and
    pool: the verify block, T=5, or a prefill block, T=512),
    with the bound from this input's touched slots and rows: gate_up and
    down for swiglu experts, up_gelu (its down stage is the same kernel)
    for gelu experts.  ``device_ms`` is the kernel's own time from the
    profiler (``ms``, an event time, also holds the wrapper's zeroed
    output and the host's issue time)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import ref as R
    g, x, h = m["g"], m["x"], m["h"]
    wg, wu, wd = m["wg"], m["wu"], m["wd"]
    counts = g.grp_count.tolist()
    touched = [s for s, c in zip(g.grp_slot.tolist(), counts) if c]
    rows_n = sum(counts)
    # library yardstick: torch.bmm over the same compacted shapes (rows
    # padded to the largest group; weights gathered beforehand, untimed)
    C = max(counts)
    idx = torch.tensor(touched, device=x.device)
    xg = torch.zeros((len(touched), C, d), dtype=x.dtype, device=x.device)
    hg = torch.zeros((len(touched), C, f), dtype=x.dtype, device=x.device)
    wu_c = wu[idx]
    b = 2                                   # bf16 bytes
    out = {}
    h_bytes = x.numel() * b + g.row_tok.numel() * f * b
    if gelu:
        cases = (("cache_moe_up_gelu",
                  lambda: K.up_gelu(x, g, wu),
                  lambda: R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot,
                                             g.grp_start, g.grp_count),
                  lambda: F.gelu(torch.bmm(xg, wu_c), approximate="tanh"),
                  len(touched) * d * f * b + h_bytes,
                  2 * rows_n * d * f),)
    else:
        wg_c, wd_c = wg[idx], wd[idx]
        cases = (("cache_moe_gate_up",
                  lambda: K.gate_up(x, g, wg, wu),
                  lambda: R.slot_gate_up_ref(x, g.row_tok, wg, wu,
                                             g.grp_slot, g.grp_start,
                                             g.grp_count),
                  lambda: (torch.bmm(xg, wg_c), torch.bmm(xg, wu_c)),
                  len(touched) * 2 * d * f * b + h_bytes,
                  2 * 2 * rows_n * d * f),
                 ("cache_moe_down",
                  lambda: K.down(h, g, wd),
                  lambda: R.slot_down_ref(h, wd, g.grp_slot, g.grp_start,
                                          g.grp_count),
                  lambda: torch.bmm(hg, wd_c),
                  len(touched) * f * d * b + g.row_tok.numel() * (f + d) * b,
                  2 * rows_n * f * d))
    for name, kern, plain, lib, nbytes, flops in cases:
        t_bytes = nbytes / HBM_BYTES_S * 1e3
        t_ops = flops / BF16_FLOPS * 1e3
        out[name] = {"ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                     "library_ms": cuda_ms(lib),
                     "device_ms": kernel_device_ms(kern, "slot_ffn"),
                     "library_device_ms": traced_ms(lib, iters=10),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                     "touched_slots": len(touched), "rows": rows_n,
                     "T": x.shape[0]}
    return out


def flash_bound(S: int, window, nbytes_el: int, H: int = FA_HEADS,
                Hkv: int = FA_KV_HEADS, D: int = FA_DIM):
    """Least time for one causal flash call at B 1 (H 32 / Hkv 8 x 128 by
    default): the unmasked (q, k) pairs x 4·D flops at the bf16 tensor rate,
    against q, k, v and out moved once at the memory rate."""
    W = S if window is None else min(window, S)
    pairs = sum(min(i + 1, W) for i in range(S)) * H
    t_ops = pairs * 4 * D / BF16_FLOPS * 1e3
    nbytes = S * D * (2 * H + 2 * Hkv) * nbytes_el
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_phase(dev):
    """The flash kernel against its plain version at the widths of the
    mixtral draft's prefill (32 / 8 heads) and the llama3.2-3b draft's (24 /
    8), and at the head shapes of FA_SHAPES (zamba2-7b's D 112, nemotron's
    D 192, granite's 48 : 1), bf16 and f32; timed (bf16) at S 512 and 2048
    (32 heads), S 512 (24 heads) and S 512 of each FA_SHAPES model: event
    time, and device time from the profiler for the kernel, the plain
    version and SDPA."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as R
    gen = torch.Generator(dev).manual_seed(1)
    rows, timing = [], {}
    both = ("bfloat16", "float32")
    mixtral = (FA_HEADS, FA_KV_HEADS, FA_DIM, None)
    for S, window, dtypes, (H, Hkv, D, model) in (
            (64, None, both, mixtral),
            (512, None, both, mixtral),
            (1024, 256, both, mixtral),
            (2048, None, both, mixtral),
            (8192, 4096, ("bfloat16",), mixtral),
            (512, None, ("bfloat16",), (LLAMA_HEADS, FA_KV_HEADS, FA_DIM,
                                        None)),
            *((512, None, both, (h, hkv, d, m))
              for m, h, hkv, d in FA_SHAPES),
            (384, 100, both, FA_SHAPES[1][1:] + (None,))):
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            q, k, v = [torch.randn((1, S, h, D), generator=gen,
                                   device=dev).to(dt)
                       for h in (H, Hkv, Hkv)]
            got = FA.flash_attention(q, k, v, causal=True, window=window)
            torch.cuda.synchronize()
            want = R.flash_attention_ref(q, k, v, causal=True, window=window)
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            row_rel = (diff.amax(dim=-1) / want.float().abs().amax(dim=-1)
                       .clamp_min(1e-30)).max().item()
            ok = torch.isfinite(got).all().item() and \
                row_rel <= FA_TOL[dt_name]
            rows.append({"kernel": "flash_attention", "dtype": dt_name,
                         "S": S, "H": H, "Hkv": Hkv, "D": D,
                         "window": window,
                         "max_abs_err": err,
                         "max_row_rel_err": row_rel,
                         "tol_row_rel": FA_TOL[dt_name], "ok": bool(ok)})
            if not ok:
                raise AssertionError(f"flash_attention {dt_name} S={S} "
                                     f"{H}/{Hkv}x{D} window={window}: a "
                                     f"row's max abs err is {row_rel} of its "
                                     f"max |out|")
            del diff
            if dt_name == "bfloat16" and S in (512, 2048) and window is None:
                bound, by = flash_bound(S, window, 2, H, Hkv, D)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                kern = lambda: FA.flash_attention(q, k, v)  # noqa: E731
                plain = lambda: R.flash_attention_ref(q, k, v)  # noqa: E731
                F = torch.nn.functional
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
                dev_ms, per_call = traced(kern)
                if per_call != 1:
                    raise AssertionError(f"flash_attention S={S}: {per_call} "
                                         f"device kernels per call, not 1")
                key = S if (H, D) == (FA_HEADS, FA_DIM) else \
                    f"{S}_{model}" if model else f"{S}_h{H}"
                timing[key] = {
                    "H": H, "Hkv": Hkv, "D": D, "ms": cuda_ms(kern),
                    "plain_ms": cuda_ms(plain, iters=2),
                    "library_ms": cuda_ms(sdpa),
                    "device_ms": dev_ms,
                    "plain_device_ms": traced_ms(plain, iters=2),
                    "library_device_ms": traced_ms(sdpa),
                    "bound_ms": bound, "bound_by": by, "max_abs_err": err}
            del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows, timing


def decode_bound(B: int, H: int, Hkv: int, D: int, lengths, el: int):
    """Least time for one flash-decode call: 4 * D flops per (q head, live
    key) at the bf16 tensor rate, against the live K and V prefix, q and
    out moved once at the memory rate."""
    keys = sum(lengths)
    t_ops = H * keys * 4 * D / BF16_FLOPS * 1e3
    nbytes = (2 * keys * Hkv * D + 2 * B * H * D) * el
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes


def decode_phase(dev):
    """The flash-decode kernel against its plain version at the llama3.2-3b
    and mixtral-draft widths and the head shapes of FA_SHAPES, bf16 and
    f32: one row at each length that fits the cache, and three rows of
    mixed lengths whose every row must equal its own one-row call bit for
    bit.  Timed (bf16, one row) at length 543 of 576 (llama3.2-3b,
    zamba2-7b) and 4096 of 4112 (mixtral draft)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import ref as R
    gen = torch.Generator(dev).manual_seed(5)
    rows, timing = [], {}

    def check(model, dt_name, q, k, v, lens_list):
        lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
        got = DA.decode_attention(q, k, v, lens)
        torch.cuda.synchronize()
        want = R.decode_attention_ref(q, k, v, lens).float()
        diff = (got.float() - want).abs()
        excess = (diff - DECODE_TOL[dt_name] - DECODE_RTOL * want.abs()
                  ).max().item()
        ok = torch.isfinite(got).all().item() and excess <= 0
        rows.append({"kernel": "decode_attention", "model": model,
                     "dtype": dt_name, "S": k.shape[1], "lengths": lens_list,
                     "max_abs_err": diff.max().item(),
                     "atol": DECODE_TOL[dt_name], "rtol": DECODE_RTOL,
                     "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"decode_attention {model} {dt_name} "
                                 f"S={k.shape[1]} lengths={lens_list}: "
                                 f"{excess} over atol + rtol |want|")
        return got, lens

    for model, H, Hkv, D in DECODE_WIDTHS:
        for S, mixed, timed in DECODE_CACHES:
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                q = torch.randn((3, H, D), generator=gen, device=dev).to(dt)
                k, v = [torch.randn((3, S, Hkv, D), generator=gen,
                                    device=dev).to(dt) for _ in range(2)]
                errs = {}
                for n in DECODE_LENGTHS:
                    if n <= S:
                        check(model, dt_name, q[:1], k[:1], v[:1], [n])
                        errs[n] = rows[-1]["max_abs_err"]
                got, lens = check(model, dt_name, q, k, v, list(mixed))
                for b in range(3):
                    one = DA.decode_attention(q[b:b + 1], k[b:b + 1],
                                              v[b:b + 1], lens[b:b + 1])
                    if not torch.equal(one, got[b:b + 1]):
                        raise AssertionError(
                            f"decode_attention {model} {dt_name} S={S}: row "
                            f"{b} of the 3-row call differs from its 1-row "
                            f"call")
                rows.append({"check": "batch_invariance",
                             "kernel": "decode_attention", "model": model,
                             "dtype": dt_name, "S": S, "lengths": list(mixed),
                             "ok": True})
                if dt_name == "bfloat16" and model in timed:
                    n = mixed[0]
                    q1, k1, v1, l1 = q[:1], k[:1], v[:1], lens[:1]
                    bound, by, nbytes = decode_bound(1, H, Hkv, D, [n], 2)
                    qs = q1[:, :, None, :]
                    ks, vs = (t[:, :n].transpose(1, 2) for t in (k1, v1))
                    timing[model] = {
                        "S": S, "length": n, "H": H, "Hkv": Hkv, "D": D,
                        "ms": cuda_ms(lambda: DA.decode_attention(
                            q1, k1, v1, l1), iters=100),
                        "plain_ms": cuda_ms(lambda: R.decode_attention_ref(
                            q1, k1, v1, l1), iters=20),
                        "library_ms": cuda_ms(
                            lambda: F.scaled_dot_product_attention(
                                qs, ks, vs, enable_gqa=True), iters=100),
                        "bound_ms": bound, "bound_by": by, "bytes": nbytes,
                        "max_abs_err": errs[n]}
                    # the kernel's own time, which the host's issue time
                    # hides in "ms" at these sizes, and the others'; the
                    # kernel is one device kernel per call
                    dev_ms, per_call = traced(lambda: DA.decode_attention(
                        q1, k1, v1, l1))
                    if per_call != 1:
                        raise AssertionError(f"decode_attention: {per_call} "
                                             f"device kernels per call")
                    timing[model].update(
                        device_ms=dev_ms, kernels_per_call=per_call,
                        plain_device_ms=traced_ms(
                            lambda: R.decode_attention_ref(q1, k1, v1, l1)),
                        library_device_ms=traced_ms(
                            lambda: F.scaled_dot_product_attention(
                                qs, ks, vs, enable_gqa=True)))
                del q, k, v, got
    torch.cuda.empty_cache()
    return rows, timing


def ssd_inputs(gen, dev, S: int, h: int, p: int, n: int, dtype):
    """One sequence of SSD inputs as a mamba layer at init sees them: dt
    log-uniform in [1e-3, 1e-1] and A = -(1..h), so slow heads carry their
    state across chunks and fast ones forget it."""
    import math
    import torch
    u = torch.rand((1, S, h), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    x, B, C = [torch.randn(shape, generator=gen, device=dev).to(dtype)
               for shape in ((1, S, h, p), (1, S, n), (1, S, n))]
    return x, dt, A, B, C


def ssd_bound(S: int, Q: int, h: int, p: int, n: int, el: int):
    """Least time for one SSD call at batch 1: the per-head chunked
    algorithm's operations, 2 (Q^2 n + Q^2 p + 2 Q n p) per head and chunk,
    at the bf16 tensor rate, against x, y, B and C (``el`` bytes each), dt,
    A and the f32 final state moved once at the memory rate."""
    flops = h * (S // Q) * 2 * (Q * Q * n + Q * Q * p + 2 * Q * n * p)
    nbytes = (2 * S * h * p + 2 * S * n) * el + (S * h + h + h * p * n) * 4
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops, nbytes


def ssd_phase(dev):
    """The SSD-scan kernel against its plain version at the mamba2 and
    zamba2 widths, bf16 and f32, y and final state; a padded length also
    against the plain version of the unpadded sequence (its state must not
    move over the pad).  Timed (bf16) at ``SSD_TIMED``: event time, device
    time and kernels per call from the profiler."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as SSD
    gen = torch.Generator(dev).manual_seed(3)
    rows, timing = [], {}
    for model, h, p, n, lengths in SSD_SHAPES:
        for S in lengths:
            Q = min(128, S)
            pad = (-S) % Q
            for dt_name in ("bfloat16", "float32"):
                dtype = getattr(torch, dt_name)
                raw = ssd_inputs(gen, dev, S, h, p, n, dtype)
                x, dt, A, B, C = [
                    F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                    if pad and t.dim() > 1 else t for t in raw]
                y, st = SSD.ssd_scan(x, dt, A, B, C, Q)
                torch.cuda.synchronize()
                y_ref, st_ref = R.ssd_ref(x, dt, A, B, C, Q)
                checks = [("y", y, y_ref, SSD_TOL[dt_name]),
                          ("state", st, st_ref, SSD_STATE_TOL)]
                if pad:                 # the unpadded sequence, chunks of Q'
                    Qu = max(q for q in range(1, 129) if S % q == 0)
                    yu, su = R.ssd_ref(*raw, Qu)
                    checks += [("y_unpadded", y[:, :S], yu,
                                SSD_TOL[dt_name]),
                               ("state_unpadded", st, su, SSD_STATE_TOL)]
                for what, got, want, tol in checks:
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    ok = torch.isfinite(got).all().item() and \
                        err <= tol * max(scale, 1e-6)
                    rows.append({"kernel": "ssd_scan", "model": model,
                                 "dtype": dt_name, "S": S, "chunk": Q,
                                 "padded_to": S + pad, "output": what,
                                 "max_abs_err": err,
                                 "max_rel_err": err / max(scale, 1e-30),
                                 "tol_rel": tol, "ok": bool(ok)})
                    if not ok:
                        raise AssertionError(
                            f"ssd_scan {model} {dt_name} S={S} {what}: max "
                            f"abs err {err} vs scale {scale}")
                if dt_name == "bfloat16" and (model, S) in SSD_TIMED:
                    bound, by, flops, nbytes = ssd_bound(S, Q, h, p, n, 2)
                    dev_ms, per_call = traced(
                        lambda: SSD.ssd_scan(x, dt, A, B, C, Q))
                    if per_call != SSD_KERNELS_PER_CALL:
                        raise AssertionError(f"ssd_scan: {per_call} device "
                                             f"kernels per call")
                    timing[f"{model}_S{S}"] = {
                        "h": h, "p": p, "n": n, "chunk": Q,
                        "ms": cuda_ms(lambda: SSD.ssd_scan(x, dt, A, B, C,
                                                           Q)),
                        "device_ms": dev_ms, "kernels_per_call": per_call,
                        "plain_ms": cuda_ms(
                            lambda: R.ssd_ref(x, dt, A, B, C, Q), iters=3),
                        "library_ms": None, "bound_ms": bound,
                        "bound_by": by, "flops": flops, "bytes": nbytes,
                        "max_abs_err": rows[-2]["max_abs_err"]}
                del x, dt, A, B, C, raw, y, st, y_ref, st_ref, checks
    torch.cuda.empty_cache()
    return rows, timing


# ---------------------------------------------------------------------------
# phases 3-6: serving
# ---------------------------------------------------------------------------

MOE_PATH = ("cache_moe_gate_up", "cache_moe_down", "flash_attention",
            "decode_attention")


def host_launches():
    """Each counted wrapper's own count: the calls that launched its kernel
    (eager calls and a build's warm-up; a call inside a capture launches
    nothing and a replay calls no wrapper)."""
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    return {"cache_moe_gate_up": K.gate_up.launches,
            "cache_moe_up_gelu": K.up_gelu.launches,
            "cache_moe_down": K.down.launches,
            "flash_attention": FA.flash_attention.launches,
            "decode_attention": DA.decode_attention.launches,
            "ssd_scan": SSD.ssd_scan.launches}


_PATH = {}                      # the device trace of the path being driven


def reset_launches(trace: bool = True):
    """Just before a main path: set every wrapper's count to 0 and start
    tracing the device (``torch.profiler``, CUDA activity).  A path that
    captures nothing (the SSD families' eager steps) goes untraced with
    ``trace=False``: there every launch is its wrapper's own."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as SSD
    if _PATH:
        raise AssertionError("a path trace is already open")
    K.gate_up.launches = K.up_gelu.launches = K.down.launches = 0
    ops.cache_moe.launches = 0
    FA.flash_attention.launches = DA.decode_attention.launches = 0
    SSD.ssd_scan.launches = 0
    _PATH["prof"] = profile(activities=[ProfilerActivity.CUDA]) \
        if trace else None
    if trace:
        _PATH["prof"].start()
        time.sleep(EDGE_S)


def read_launches(path: str, kernels=MOE_PATH):
    """Just after a main path: stop its trace and count, per wrapper, the
    calls whose kernels the device ran in it (``KERNEL_NAMES``): the
    wrappers' own launches and every replay of a captured step that holds
    them (untraced, the wrappers' own counts).  Those counts are returned
    by name; the wrappers' own counts under ``"host"``; the calls run
    between the markers of ``mark_draft_steps`` under ``"draft"``, with
    the markers seen under ``"draft_marks"``.  Each of ``kernels`` must
    have launched through its wrapper and run on the device, and every
    launch a wrapper counted must have run."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    prof = _PATH.pop("prof")
    host = host_launches()
    ran = dict(host)
    draft = dict.fromkeys(KERNEL_NAMES, 0)
    marks, seen, names = 0, 0, set()
    if prof is not None:
        time.sleep(EDGE_S)
        t0 = time.perf_counter()
        prof.stop()
        ours = []                 # (start, name) of the port's and markers
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            seen += 1
            name = e.name()
            if OURS.search(name):
                ours.append((e.start_ns(), name))
            elif len(names) < 8:
                names.add(name[:80])
        ours.sort()
        log(f"{path}: the trace's {seen} device activities read in "
            f"{time.perf_counter() - t0:.1f} s")
        ran = dict.fromkeys(KERNEL_NAMES, 0)
        inside = False
        for _, name in ours:
            if MARK.search(name):
                inside, marks = not inside, marks + 1
                continue
            for k, (pattern, _) in KERNEL_NAMES.items():
                if pattern.search(name):
                    ran[k] += 1
                    draft[k] += inside
                    break
        for k, (_, per_call) in KERNEL_NAMES.items():
            if ran[k] % per_call or draft[k] % per_call:
                raise AssertionError(f"{path}: {ran[k]} {k} kernels, not "
                                     f"{per_call} a call")
            ran[k] //= per_call
            draft[k] //= per_call
    for k in kernels:
        if host[k] <= 0 or ran[k] <= 0:
            raise AssertionError(
                f"{k} was never launched on the {path} path (its wrapper "
                f"{host[k]}, the device {ran[k]}; the trace held {seen} "
                f"activities, among them {sorted(names)})")
    for k in KERNEL_NAMES:
        if ran[k] < host[k]:
            raise AssertionError(f"{path}: {k} launched {host[k]} times, "
                                 f"the device ran {ran[k]}")
    return {**ran, "host": host, "draft": draft, "draft_marks": marks}


def mark_draft_steps(rt, calls: list):
    """Put a marker kernel (``torch.cuda._sleep``, ``MARK``) on the stream
    before and after each of the runtime's draft steps, so that a path's
    trace tells the draft's kernels apart (``read_launches``); each step
    appends to ``calls``.  ``del rt._draft_step`` takes the markers away."""
    import torch
    step = rt._draft_step

    def marked(*a):
        calls.append(1)
        torch.cuda._sleep(1)
        out = step(*a)
        torch.cuda._sleep(1)
        return out
    rt._draft_step = marked


def serve_phase(name, target, draft, cfg, dcfg, slots, prompts, new_tokens,
                spy: bool, draft_calls=None):
    """Serve ``prompts`` one after another (sd x spmoe).  The engine's
    counters are reset after the first request (``Engine.reset_stats``), so
    ``info["steady"]`` holds the runtime's counters over the warm requests
    alone (each request's own metrics are deltas, which the reset leaves
    as they are).  With ``draft_calls`` (a list) the draft steps are
    marked (``mark_draft_steps``) while the prompts are served."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, Request
    config = EngineConfig(model=cfg, draft=dcfg, decode="sd",
                          offload="spmoe", cache_slots=slots, draft_len=4,
                          max_seq=256)
    t0 = time.perf_counter()
    eng = Engine(config, target, draft)
    rt = eng.runtime
    setup_s = time.perf_counter() - t0
    if draft_calls is not None:
        mark_draft_steps(rt, draft_calls)
    fast_syncs = []
    if spy:
        orig = rt.session_turn

        def turn(st):
            s0, f0 = rt.host_syncs, rt.fast_blocks
            out = orig(st)
            if rt.fast_blocks > f0:
                fast_syncs.append(rt.host_syncs - s0)
            return out
        rt.session_turn = turn
    results = []
    for i, p in enumerate(prompts):
        res = eng.submit(Request(prompt=p, max_new_tokens=new_tokens,
                                 request_id=f"{name}-{i}"))
        torch.cuda.synchronize()
        if len(res.tokens) != new_tokens or res.finish_reason != "length":
            raise AssertionError(f"{name}: request {i} ended "
                                 f"{res.finish_reason} after "
                                 f"{len(res.tokens)} tokens")
        results.append(res)
        if i == 0:
            eng.reset_stats()
            if any(rt.counters().values()) or eng.metrics().requests:
                raise AssertionError(f"{name}: counters after reset_stats")
    if not rt.cache.check_invariants():
        raise AssertionError(f"{name}: cache invariants violated")
    if draft_calls is not None:
        del rt._draft_step
    info = {"setup_s": setup_s, "pinned_staging_bytes":
            rt.store.pinned_bytes, "fast_syncs": fast_syncs,
            "counters": rt.counters()}
    c = info["counters"]
    info["steady"] = {
        **c, "requests": eng.metrics().requests,
        "hit_rate": c["hits"] / max(c["lookups"], 1),
        "host_syncs_per_verify_block":
            c["host_syncs"] / max(c["verify_blocks"], 1)}
    return eng, results, info


def check_tight(results):
    tot = {k: sum(r.metrics[k] for r in results)
           for k in ("on_demand_loads", "prefetched", "evictions")}
    for k, v in tot.items():
        if v <= 0:
            raise AssertionError(f"tight cache: {k} = {v}, expected > 0")
    return tot


def check_ample(results, info):
    fast = sum(r.metrics["fast_blocks"] for r in results)
    blocks = sum(r.metrics["verify_blocks"] for r in results)
    falls = sum(r.metrics["fast_fallbacks"] for r in results)
    if fast <= 0:
        raise AssertionError("ample cache: the fast path never engaged")
    if falls > max(2, blocks // 10):
        raise AssertionError(f"ample cache: {falls} fast fallbacks in "
                             f"{blocks} blocks")
    if not info["fast_syncs"] or max(info["fast_syncs"]) > 2:
        raise AssertionError(f"ample cache: host syncs per fast block "
                             f"{info['fast_syncs']}")
    return {"fast_blocks": fast, "verify_blocks": blocks,
            "fast_fallbacks": falls,
            "max_syncs_per_fast_block": max(info["fast_syncs"])}


def clone_tree(tree):
    """A deep copy of a cache or taps tree (dicts, lists, tensors)."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone_tree(v) for v in tree]
    return tree.clone() if hasattr(tree, "clone") else tree


def tree_equal(a, b) -> bool:
    """Bit-equal trees of tensors (and host values)."""
    import torch
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(tree_equal(x, y)
                                        for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def replay_ab(eager, replay, focus):
    """A step's eager body against its captured step (``core/graphs.py``)
    on the same inputs, in turns (eager, replay, replay, eager): event ms
    per call (``cuda_ms``) and one traced call's span, kernels, device busy
    ms and idle share (``device_profile``) each time.  Each traced eager
    call must run the ``focus`` kernels its wrappers launched; each traced
    replay the same number, none of them through a wrapper."""
    name = focus[0]
    keys = ("event_ms", "traced_span_ms", "kernels", f"{name}_kernels",
            f"{name}_host_kernels", "device_busy_ms", "idle_share")
    runs = {"eager": [], "replay": []}
    for side in ("eager", "replay", "replay", "eager"):
        fn = eager if side == "eager" else replay
        prof = device_profile(fn, cuda_ms(fn), focus)
        runs[side].append({k: prof[k] for k in keys})
    want = runs["eager"][0][f"{name}_kernels"]
    for side, rs in runs.items():
        for r in rs:
            host = r[f"{name}_host_kernels"]
            if r[f"{name}_kernels"] != want or \
                    host != (want if side == "eager" else 0):
                raise AssertionError(
                    f"{side}: {r[f'{name}_kernels']} {name} kernels ran, "
                    f"{host} launched through their wrappers; the eager "
                    f"body ran {want}")
    return runs


def graph_summary(gs):
    """An engine's captured steps: builds and runs per kind, the builds'
    seconds (warm-up and capture), each private pool's device bytes."""
    pools = gs.pool_bytes()
    return {"builds": dict(gs.builds), "runs": dict(gs.runs),
            "capture_s": gs.capture_s,
            "pool_bytes": {str(k): v for k, v in pools.items()},
            "pool_bytes_total": sum(pools.values())}


def verify_replay_ab(rt, seed: int):
    """The fast verify block (``BLOCK_T`` tokens, a ladder length) of a
    session at position 100 on the runtime's warm cache: its replay
    against the eager body on a copy of the session's state, bit for bit,
    then the two timed in turns (``replay_ab``)."""
    import torch
    cfg, dev = rt.cfg, rt.device
    if BLOCK_T not in rt._ladder():
        raise AssertionError(f"block of {BLOCK_T} off the ladder "
                             f"{rt._ladder()}")
    gen = torch.Generator().manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (1, 100), generator=gen)
    st = rt.start_session(prompt.to(dev), 8)
    block = torch.cat([st.cur, torch.randint(
        0, cfg.vocab_size, (1, BLOCK_T - 1), generator=gen).to(dev)], dim=1)
    tc, hist = clone_tree(st.tcache), st.history_dev.clone()
    b0 = sum(rt.graphs.builds.values())

    def eager():
        lg, ok, hists, nact = rt._fast_body([block], [st.pos], [tc], [hist])
        return lg[0], ok[0], hists[0], nact[0]

    def replay():
        return rt._verify_fast(block, st.pos, st.slot)
    want = eager()
    r0 = rt.graphs.runs["fast"]
    got = replay()
    torch.cuda.synchronize()
    if rt.graphs.runs["fast"] != r0 + 1:
        raise AssertionError("the fast verify block did not replay")
    if not tree_equal(list(got), list(want)) or \
            not tree_equal(st.tcache, tc):
        raise AssertionError("the fast verify block's replay differs from "
                             "its eager body")
    ab = replay_ab(eager, replay, FOCUS_FFN)
    rt.finish_session(st)
    return {"block_tokens": BLOCK_T, "position": 100,
            "all_hit": bool(got[1]), "bit_equal": True,
            "builds_during": sum(rt.graphs.builds.values()) - b0, **ab}


def draft_stage_ab(rt, prompt):
    """The drafting stage of one verify block (``BLOCK_T - 1`` draft steps
    with taps after ``prompt``'s prefill): ``draft.decode_step`` on a copy
    of the session's draft cache against ``_draft_step`` (a replay per
    step, next token included), one step held bit for bit first."""
    import torch
    st = rt.start_session(prompt.to(rt.device), 8)
    d, tok, pos = rt.draft, st.cur, st.pos
    dc = clone_tree(st.dcache)
    lg, _, taps = d.decode_step(dc, tok, pos, collect_taps=True)
    nxt, gtaps = rt._draft_step(st, tok, pos)
    torch.cuda.synchronize()
    if not torch.equal(nxt, torch.argmax(lg[:, -1], dim=-1)[:, None]) or \
            not tree_equal(gtaps, taps) or not tree_equal(st.dcache, dc):
        raise AssertionError("the draft step's replay differs from its "
                             "eager body")
    steps = range(BLOCK_T - 1)
    ab = replay_ab(
        lambda: [d.decode_step(dc, tok, pos + i, collect_taps=True)
                 for i in steps],
        lambda: [rt._draft_step(st, tok, pos + i) for i in steps],
        FOCUS_FFN if d.cfg.is_moe else FOCUS_DECODE)
    syncs = sync_warnings(lambda: rt._draft_step(st, tok, pos))
    rt.finish_session(st)
    return {"steps": BLOCK_T - 1, "draft": d.cfg.name,
            "draft_layers": d.cfg.num_layers, "bit_equal": True,
            "replay_step_syncs": len(syncs), **ab}


def breakdown(eng, draft, dev):
    """Where one full-width fast verify block spends its time (warm ample
    cache, block of 5 tokens): the whole block, its expert FFN share, and
    the drafting stage that precedes it."""
    import torch
    rt = eng.runtime
    tgt = rt.target
    cfg = rt.cfg
    tcache = tgt.init_cache(1, 256)
    block = torch.randint(0, cfg.vocab_size, (1, BLOCK_T),
                          generator=torch.Generator().manual_seed(7)
                          ).to(dev)
    hist = torch.zeros((rt.store.num_layers, cfg.num_experts), device=dev)
    block_ms = cuda_ms(lambda: rt._fast_body([block], [100], [tcache],
                                             [hist]))
    # the same block's expert FFN calls alone, with the routing it produced
    calls, touched = [], []
    with rt.cache.reading() as (bufs, table):
        x = tgt.embed(block)
        for l in range(rt.store.num_layers):
            x, h2 = tgt.attn_half(l, x, tcache["layers"][l], 100)
            w, ids, _ = rt._gate(l, h2)
            calls.append((h2.reshape(BLOCK_T, -1), table[l][ids], w))
            touched.append(len(set(ids.reshape(-1).tolist())))
            x = x + rt._moe_apply(bufs, *calls[-1]).reshape(1, BLOCK_T, -1)

        def moe():
            for c in calls:
                rt._moe_apply(bufs, *c)
        moe_ms = cuda_ms(moe)
        # the host's side of the same calls: the time to issue them, the
        # device left to run behind (a share near 1 means the device waited
        # on the host)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            moe()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
    # the draft's steps over a prefilled prefix, as served (flash-decode)
    _, dcache = draft.prefill(torch.randint(
        0, cfg.vocab_size, (1, 100), generator=torch.Generator().manual_seed(
            8)).to(dev), 256)
    tok = block[:, :1]
    draft_ms = cuda_ms(lambda: [draft.decode_step(dcache, tok, 100 + i,
                                                  collect_taps=True)
                                for i in range(BLOCK_T - 1)])
    # the same two stages as the engine serves them: captured and replayed
    preload_every_expert(rt)
    graphs = {"verify_block": verify_replay_ab(rt, 7),
              "drafting_stage": draft_stage_ab(rt, torch.randint(
                  0, cfg.vocab_size, (1, 100),
                  generator=torch.Generator().manual_seed(8))),
              "engine": graph_summary(eng.graphs)}
    return {"fast_verify_block_ms": block_ms,
            "expert_ffn_ms": moe_ms,
            "expert_ffn_host_issue_ms": host_ms,
            "expert_ffn_host_share": host_ms / moe_ms,
            "experts_touched_per_layer": touched,
            "rest_of_block_ms": block_ms - moe_ms,
            "drafting_stage_ms": draft_ms,
            "layers": rt.store.num_layers, "block_tokens": BLOCK_T,
            "graphs": graphs}


def concurrent_phase(target, draft, cfg, dcfg, prompts, slots: int = 32,
                     new_tokens: int = CONC_NEW, kernels=MOE_PATH,
                     name: str = "concurrent", preload: bool = False):
    """Phase 5: ``serve_all`` of the long-prompt requests, two at a time, on
    an ample cache, with every fused round's host syncs recorded; then one
    all-hit round held to the solo fast blocks on the same snapshot.  The
    launch counts are set to 0 just before ``serve_all`` and read just
    after: each of ``kernels`` must have launched.  With ``preload`` every
    expert is inserted first, layer by layer (a warm ample cache: a first
    prefill need not route into every expert of a layer, and a decode token
    that later does would make its round fall back)."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, Request
    config = EngineConfig(model=cfg, draft=dcfg, decode="sd",
                          offload="spmoe", cache_slots=slots, draft_len=4,
                          max_seq=prompts[0].shape[1] + new_tokens + 32)
    eng = Engine(config, target, draft)
    rt = eng.runtime
    rounds = []
    orig = rt._round_fused

    def spy(fused, *a):
        s0, f0, b0 = rt.host_syncs, rt.fast_fallbacks, rt.fast_blocks
        orig(fused, *a)
        rounds.append({"sessions": len(fused), "syncs": rt.host_syncs - s0,
                       "fast": rt.fast_blocks - b0,
                       "fallbacks": rt.fast_fallbacks - f0})

    rt._round_fused = spy
    if preload:
        preload_every_expert(rt)
    reqs = [Request(prompt=p, max_new_tokens=new_tokens,
                    request_id=f"{name}-{i}")
            for i, p in enumerate(prompts)]
    reset_launches()
    r0, l0 = rt.verify_rounds, rt.round_launches
    t0 = time.perf_counter()
    results = eng.serve_all(reqs, concurrency=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(f"{name} serving", kernels)
    rt._round_fused = orig
    for i, res in enumerate(results):
        if len(res.tokens) != new_tokens or res.finish_reason != "length":
            raise AssertionError(f"{name}: request {i} ended "
                                 f"{res.finish_reason} after "
                                 f"{len(res.tokens)} tokens")
    if not rounds:
        raise AssertionError(f"{name}: no fused round ran")
    for r in rounds:
        if r["fallbacks"] or r["syncs"] > 2:
            raise AssertionError(f"{name}: a fused round on the ample "
                                 f"cache fell back or synced more than "
                                 f"twice: {r}")
    if not rt.cache.check_invariants():
        raise AssertionError(f"{name}: cache invariants violated")
    counters = {"verify_rounds": rt.verify_rounds - r0,
                "round_launches": rt.round_launches - l0,
                "fused_rounds": len(rounds),
                "fused_sessions": sum(r["sessions"] for r in rounds),
                "max_syncs_per_fused_round": max(r["syncs"]
                                                 for r in rounds),
                "wall_s": wall,
                "tokens_per_s": len(prompts) * new_tokens / wall}
    # one all-hit round: fused logits == each session's solo fast block
    sts = [rt.start_session(p.to(rt.device), 8) for p in prompts[:2]]
    gen = torch.Generator().manual_seed(9)
    blocks = [torch.cat([st.cur, torch.randint(
        0, cfg.vocab_size, (1, BLOCK_T - 1), generator=gen).to(rt.device)],
        dim=1) for st in sts]

    def caches():
        return [{s: [{n: t.clone() for n, t in c.items()}
                     for c in st.tcache[s]]
                 for s in ("dense_layers", "layers") if s in st.tcache}
                for st in sts]

    solo = [[o[0] for o in rt._fast_body([b], [st.pos], [tc],
                                         [st.history_dev])]
            for b, st, tc in zip(blocks, sts, caches())]
    logits, ok, _, _ = rt._fast_body(
        blocks, [st.pos for st in sts], caches(),
        [st.history_dev for st in sts])
    torch.cuda.synchronize()
    for st in sts:
        rt.finish_session(st)
    if not bool(ok.all()) or not all(bool(o) for _, o, _, _ in solo):
        raise AssertionError(f"{name}: the snapshot round was not all-hit")
    for j, (lg, _, _, _) in enumerate(solo):
        if not torch.equal(logits[j], lg):
            diff = (logits[j].float() - lg.float()).abs().max().item()
            raise AssertionError(f"{name}: session {j}'s fused logits "
                                 f"differ from its solo fast block (max "
                                 f"{diff})")
    counters["fused_equals_solo_bitwise"] = True
    counters["graphs"] = graph_summary(eng.graphs)
    eng.close()
    return results, counters, launches


def preload_every_expert(rt):
    """Insert every expert into the runtime's cache, layer by layer (a warm
    ample cache)."""
    for l in range(rt.store.num_layers):
        keys = [(l, e) for e in range(rt.store.num_experts)]
        rt.cache.insert(keys, rt.store.fetch(keys))
    rt.cache.wait()


def teacher_force(target, seq):
    """Logits of one causal forward over seq [1, S].  Under
    ``attn_impl="kernel"`` a length past 128 must be a multiple of 128 (the
    reference's flash precondition), so the sequence is padded at its end:
    causal attention and per-token routing keep the padding out of every
    earlier position."""
    import torch
    S = seq.shape[1]
    pad = (-S) % 128 if S > 128 else 0
    if pad:
        seq = torch.cat([seq, torch.zeros((1, pad), dtype=seq.dtype,
                                          device=seq.device)], dim=1)
    logits, _ = target.forward(seq)
    return logits[:, :S]


def lossless_phase(target, prompts_by_req, dev, forward=teacher_force,
                   margin: float = MARGIN):
    """Teacher-force the resident model over each emitted stream
    (``forward(target, seq) -> logits``)."""
    import torch
    exact = explained = 0
    worst = 0.0
    for prompt, tokens in prompts_by_req:
        seq = torch.cat([prompt[0].to(dev),
                         torch.tensor(tokens[:-1], device=dev)])[None]
        logits = forward(target, seq)
        lg = logits[0, prompt.shape[1] - 1:].float()
        tok = torch.tensor(tokens, device=dev)
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        top = lg.argmax(dim=-1) == tok
        for is_top, g in zip(top.tolist(), gap.tolist()):
            if is_top:
                exact += 1
            elif g <= margin:
                explained += 1
                worst = max(worst, g)
            else:
                raise AssertionError(f"emitted token {g:.4f} logits below "
                                     f"the reference's argmax (margin "
                                     f"{margin})")
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite reference logits")
    return {"exact": exact, "margin_explained": explained,
            "worst_gap": worst, "margin": margin}


# every kernel of csrc/ssd_scan.cu (ssd_state_mma / _fma, ssd_state_pass,
# ssd_scan_mma / _fma)
SSD_NAMES = r"\bssd_(state|scan)_(mma|fma|pass)\b"
DECODE_NAMES = r"\bdecode_(mma|fma)<"


def ffn_names(act: int) -> str:
    """csrc/cache_moe.cu's kernels of one epilogue (0 down, 1 swiglu
    gate_up, 2 up_gelu): ``slot_ffn<T, act>`` (f32) and
    ``slot_ffn_tc<act, ...>`` (bf16), as the profiler demangles them."""
    return (rf"\bslot_ffn<[^,<>]+, (\(int\))?{act}>"
            rf"|\bslot_ffn_tc<(\(int\))?{act},")


# each counted wrapper's device kernels by name, and how many a call runs
KERNEL_NAMES = {
    "cache_moe_gate_up": (re.compile(ffn_names(1)), 1),
    "cache_moe_up_gelu": (re.compile(ffn_names(2)), 1),
    "cache_moe_down": (re.compile(ffn_names(0)), 1),
    "flash_attention": (re.compile(r"\bflash_fwd(_wgmma)?<"), 1),
    "decode_attention": (re.compile(DECODE_NAMES), 1),
    "ssd_scan": (re.compile(SSD_NAMES), SSD_KERNELS_PER_CALL)}
# the marker kernel of torch.cuda._sleep (ATen's spin_kernel)
MARK = re.compile(r"\bspin_kernel\b")
OURS = re.compile("|".join(p.pattern for p, _ in KERNEL_NAMES.values()) +
                  "|" + MARK.pattern)
# host seconds at each end of a trace with no device work: without them
# the profiler dropped a window's last kernels (seen after a long trace)
EDGE_S = 0.05
# a traced call's focus: (name, pattern of its kernels' names, the wrappers
# that launch them)
FOCUS_SSD = ("ssd", SSD_NAMES, ("ssd_scan",))
FOCUS_DECODE = ("decode", DECODE_NAMES, ("decode_attention",))
FOCUS_FFN = ("expert_ffn", r"\bslot_ffn",
             ("cache_moe_gate_up", "cache_moe_up_gelu", "cache_moe_down"))


def cuda_events(prof):
    """(name, start ns, end ns) of every device activity of a finished
    trace, in order of start."""
    from torch.autograd import DeviceType
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA),
                  key=lambda e: e[1])


def host_kernels(wrappers) -> int:
    """The device kernels that ``wrappers``' own launches so far make."""
    got = host_launches()
    return sum(got[w] * KERNEL_NAMES[w][1] for w in wrappers)


def device_profile(fn, ms: float, focus=FOCUS_SSD, tries: int = 5):
    """One warm call of ``fn`` traced with ``torch.profiler``, with a CUDA
    event recorded on the stream before it and one after: the kernels the
    device ran (those of one of the port's kernels, ``focus``, counted
    apart, beside the kernels that its wrappers launched in the call), the
    time the device was busy (union of the kernels' and copies'
    intervals), the call's span on the device (the two events' elapsed
    time: from the device reaching the call to its last work, the host's
    issue time included) and the share of that span in which the device
    was idle, all from that one call.  ``ms``, the mean event time of
    untraced calls, stands beside them as ``event_ms``.  A trace that comes
    back empty is taken again, after a pause, before failing."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    name, pattern, wrappers = focus
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    for attempt in range(tries):
        h0 = host_kernels(wrappers)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(EDGE_S)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            time.sleep(EDGE_S)
        host = host_kernels(wrappers) - h0
        events = cuda_events(prof)
        if events:
            break
        log(f"the profiler saw no device activity of a traced call (window "
            f"{attempt + 1} of {tries}); tracing again")
        time.sleep(0.5)
    else:
        raise AssertionError("the profiler saw no device activity of a "
                             "traced call")
    spans = {name: [], "rest": [], "copy": []}
    for n, t0, t1 in events:
        kind = "copy" if n.startswith(("Memcpy", "Memset")) else \
            name if re.search(pattern, n) else "rest"
        spans[kind].append((t0, t1))

    def busy_ms(iv):
        total, end = 0, float("-inf")
        for t0, t1 in sorted(iv):
            if t1 > end:
                total += t1 - max(t0, end)
                end = t1
        return total / 1e6

    busy = busy_ms(spans[name] + spans["rest"] + spans["copy"])
    span = a.elapsed_time(b)
    return {"kernels": len(spans[name]) + len(spans["rest"]),
            f"{name}_kernels": len(spans[name]),
            f"{name}_host_kernels": host, "copies": len(spans["copy"]),
            "device_busy_ms": busy, f"{name}_busy_ms": busy_ms(spans[name]),
            "rest_busy_ms": busy_ms(spans["rest"]), "event_ms": ms,
            "traced_span_ms": span, "idle_share": 1 - busy / span}


def mamba_layers(cfg) -> int:
    """Mamba blocks of a model: one SSD launch each per prefill."""
    shared = cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" \
        else 0
    return cfg.num_layers - shared


def ssm_phase(name: str, cfg, dev, prompts, new_tokens: int,
              kernels=("ssd_scan",)):
    """Greedy x none serving of an ssm / hybrid model through
    ``Engine.submit``, with the launch counts set to 0 just before and read
    just after (each of ``kernels`` must have run; the SSD scan once per
    mamba layer per prefill); then the model's prefill and one decode step
    timed alone, and every emitted token teacher-forced (under
    ``attn_impl="kernel"`` through ``teacher_force``, which pads the
    sequence for flash attention)."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, Request
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    target = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    max_seq = max(p.shape[1] for p in prompts) + new_tokens + 8
    eng = Engine(EngineConfig(model=cfg, decode="greedy", offload="none",
                              max_seq=max_seq), target)
    reset_launches(trace=False)
    t0 = time.perf_counter()
    results = [eng.submit(Request(prompt=p, max_new_tokens=new_tokens,
                                  request_id=f"{name}-{i}"))
               for i, p in enumerate(prompts)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(name, kernels)
    want = mamba_layers(cfg) * len(prompts)
    if launches["ssd_scan"] != want:
        raise AssertionError(f"{name}: {launches['ssd_scan']} SSD launches, "
                             f"expected {want} (one per mamba layer per "
                             f"prefill)")
    for i, res in enumerate(results):
        if len(res.tokens) != new_tokens or res.finish_reason != "length":
            raise AssertionError(f"{name}: request {i} ended "
                                 f"{res.finish_reason} after "
                                 f"{len(res.tokens)} tokens")
    p0 = prompts[0].to(dev)
    prefill_ms = cuda_ms(lambda: target.prefill(p0, max_seq), iters=3)
    _, cache = target.prefill(p0, max_seq)
    tok = p0[:, -1:]
    step_ms = cuda_ms(lambda: target.decode_step(cache, tok, p0.shape[1]))
    prefill_prof = device_profile(lambda: target.prefill(p0, max_seq),
                                  prefill_ms)
    # the profiler's focus must see every kernel of every SSD call
    want_traced = mamba_layers(cfg) * SSD_KERNELS_PER_CALL
    if prefill_prof["ssd_kernels"] != want_traced:
        raise AssertionError(f"{name}: the traced prefill holds "
                             f"{prefill_prof['ssd_kernels']} SSD kernels, "
                             f"expected {want_traced}")
    step_prof = device_profile(
        lambda: target.decode_step(cache, tok, p0.shape[1]), step_ms)
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts, results)], dev,
                          forward=teacher_force
                          if cfg.attn_impl == "kernel"
                          else lambda m, seq: m.forward(seq)[0],
                          margin=SSM_MARGIN)
    if loss["exact"] < SSM_MIN_EXACT * len(prompts) * new_tokens:
        raise AssertionError(f"{name}: only {loss['exact']} of "
                             f"{len(prompts) * new_tokens} tokens are the "
                             f"teacher-forced argmax")
    info = {"model": cfg.name, "layers": cfg.num_layers,
            "mamba_layers": mamba_layers(cfg),
            "params": sum(t.numel() for t in target.parameters()),
            "model_init_s": init_s, "wall_s": wall,
            "tokens_per_s": len(prompts) * new_tokens / wall,
            "prefill_ms": prefill_ms, "prefill_tokens": p0.shape[1],
            "decode_step_ms": step_ms, "prefill_profile": prefill_prof,
            "decode_step_profile": step_prof,
            "launches": launches["ssd_scan"],
            "host_launches": launches["host"]["ssd_scan"],
            "attn_impl": cfg.attn_impl,
            "kernel_launches": {k: launches[k] for k in kernels},
            "lossless": loss}
    requests = [{"id": r.request_id, "prompt": p.shape[1],
                 "tokens": len(r.tokens), "tpot_wall_s": r.metrics.tpot_wall,
                 "finish_reason": r.finish_reason}
                for p, r in zip(prompts, results)]
    del eng, target, cache
    gc.collect()
    torch.cuda.empty_cache()
    return requests, info


def gelu_phase(dev):
    """sd x spmoe over mixtral-8x7b at full width with gelu experts
    (``ffn_activation="gelu"``, which both packages' configs allow; a
    gelu-expert variant, not a published model), cut to 2 layers with a
    2-layer mistral draft, an ample cache: one 64-token request through
    ``Engine.submit``, the launch counts set to 0 just before and read just
    after (the expert FFN must run up_gelu and down, never gate_up), then
    every token teacher-forced through the resident experts."""
    import torch
    from repro_torch.configs.registry import get_config, get_draft_config
    from repro_torch.core.engine import Engine, EngineConfig, Request
    from repro_torch.models.registry import build_model
    gcfg = dataclasses.replace(get_config("mixtral-8x7b"),
                               num_layers=GELU_LAYERS, ffn_activation="gelu",
                               attn_impl="kernel")
    dcfg = dataclasses.replace(get_draft_config("mixtral-8x7b"),
                               num_layers=GELU_LAYERS, attn_impl="kernel")
    # experts resident on the card as well: the teacher-forced check
    # reads them there, the engine copies them to its host store
    target = build_model(gcfg, dev, seed=0)
    draft = build_model(dcfg, dev, seed=1)
    prompt = torch.randint(0, gcfg.vocab_size, (1, GELU_PROMPT),
                           generator=torch.Generator().manual_seed(50))
    eng = Engine(EngineConfig(model=gcfg, draft=dcfg, decode="sd",
                              offload="spmoe",
                              cache_slots=gcfg.num_moe_layers *
                              gcfg.num_experts, draft_len=4, max_seq=128),
                 target, draft)
    names = list(eng.runtime.store.names)
    if names != ["wu", "wd"]:
        raise AssertionError(f"gelu experts: the store holds {names}")
    reset_launches()
    t0 = time.perf_counter()
    res = eng.submit(Request(prompt=prompt, max_new_tokens=GELU_NEW,
                             request_id="gelu-0"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("gelu-expert", ("cache_moe_up_gelu",
                                             "cache_moe_down",
                                             "flash_attention",
                                             "decode_attention"))
    if launches["cache_moe_gate_up"]:
        raise AssertionError("gelu experts ran the swiglu gate_up stage")
    if len(res.tokens) != GELU_NEW or res.finish_reason != "length":
        raise AssertionError(f"gelu: the request ended {res.finish_reason} "
                             f"after {len(res.tokens)} tokens")
    pinned = eng.runtime.store.pinned_bytes
    eng.close()
    loss = lossless_phase(target, [(prompt, res.tokens)], dev)
    info = {"model": gcfg.name + " (gelu experts)", "layers": GELU_LAYERS,
            "store": names, "wall_s": wall,
            "tpot_wall_s": res.metrics.tpot_wall,
            "pinned_staging_bytes": pinned, "launches": launches,
            "lossless": loss,
            **{k: res.metrics[k] for k in ("verify_blocks", "fast_blocks",
                                           "host_syncs", "on_demand_loads",
                                           "prefetched")}}
    del eng, target, draft
    gc.collect()
    torch.cuda.empty_cache()
    return info


def dense_phase(dev):
    """llama3.2-3b at full width and full depth (28 layers, d 3072, 24 / 8
    heads x 128, d_ff 8192, vocab 128256, tied embeddings, bf16,
    ``attn_impl="kernel"``), random weights from seeds 0 / 1: one 512-token
    request greedy x none (every target step through flash-decode) and one
    sd x none with the derived 14-layer draft (every draft step through
    it), through ``Engine.submit``, the launch counts set to 0 just before
    and read just after; then one warm greedy decode step timed alone and
    traced, and every token teacher-forced."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                         derive_draft_config)
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config("llama3.2-3b"), attn_impl="kernel")
    dcfg = derive_draft_config(cfg)
    t0 = time.perf_counter()
    target = build_model(cfg, dev, seed=0)
    draft = build_model(dcfg, dev, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(60)
    prompts = [torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT),
                             generator=gen) for _ in range(2)]
    greedy = Engine(EngineConfig(model=cfg, decode="greedy",
                                 max_seq=DENSE_MAX_SEQ), target)
    sd = Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             draft_len=4, max_seq=DENSE_MAX_SEQ),
                target, draft)
    reset_launches()
    t0 = time.perf_counter()
    res_g = greedy.submit(Request(prompt=prompts[0],
                                  max_new_tokens=DENSE_NEW,
                                  request_id="dense-greedy"))
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    g_launches = read_launches("dense greedy",
                               ("flash_attention", "decode_attention"))
    reset_launches()
    t1s = time.perf_counter()
    res_s = sd.submit(Request(prompt=prompts[1], max_new_tokens=DENSE_NEW,
                              request_id="dense-sd"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    s_launches = read_launches("dense sd",
                               ("flash_attention", "decode_attention"))
    launches = {k: g_launches[k] + s_launches[k] for k in KERNEL_NAMES}
    launches["host"] = {k: g_launches["host"][k] + s_launches["host"][k]
                        for k in KERNEL_NAMES}
    for res in (res_g, res_s):
        if len(res.tokens) != DENSE_NEW or res.finish_reason != "length":
            raise AssertionError(f"{res.request_id}: ended "
                                 f"{res.finish_reason} after "
                                 f"{len(res.tokens)} tokens")
    # one kernel per layer per one-token step, as the traces count them:
    # the target's steps (greedy) and the draft's (sd; a step after a draft
    # block accepted whole skips a position and takes the masked route).
    # Every step is a replay of a captured step, which runs the kernels
    # without their wrappers; each build's eager warm-up runs them once
    # more, through the wrappers
    g_dec = g_launches["decode_attention"]
    s_dec = s_launches["decode_attention"]
    g_steps = DENSE_NEW - 1 + greedy.graphs.builds["greedy"]
    if g_dec != cfg.num_layers * g_steps:
        raise AssertionError(f"greedy: {g_dec} flash-decode launches, "
                             f"expected {cfg.num_layers * g_steps}")
    g_replayed = g_dec - g_launches["host"]["decode_attention"]
    if g_replayed != cfg.num_layers * (DENSE_NEW - 1):
        raise AssertionError(f"greedy: the replays ran {g_replayed} "
                             f"flash-decode kernels, not one per layer per "
                             f"step")
    drafted = res_s.metrics.drafted
    s_steps = drafted + 4 * sd.graphs.builds["sd"]
    if not 0 < s_dec <= dcfg.num_layers * s_steps or s_dec % dcfg.num_layers:
        raise AssertionError(f"sd: {s_dec} flash-decode launches for "
                             f"{drafted} draft steps of {dcfg.num_layers} "
                             f"layers")
    want_flash = 2 * cfg.num_layers + dcfg.num_layers
    if launches["flash_attention"] != want_flash:
        raise AssertionError(f"dense: {launches['flash_attention']} flash "
                             f"launches, expected {want_flash} (the two "
                             f"target prefills and the draft's)")
    p0 = prompts[0].to(dev)
    _, cache = target.prefill(p0, DENSE_MAX_SEQ)
    tok = p0[:, -1:]
    step_ms = cuda_ms(lambda: target.decode_step(cache, tok, DENSE_PROMPT))
    step_prof = device_profile(
        lambda: target.decode_step(cache, tok, DENSE_PROMPT), step_ms,
        FOCUS_DECODE)
    graphs = dense_replay_ab(target, draft, greedy, sd, prompts)
    greedy.close()
    sd.close()
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts, (res_g, res_s))], dev,
                          margin=DENSE_MARGIN)
    if loss["exact"] < DENSE_MIN_EXACT * 2 * DENSE_NEW:
        raise AssertionError(f"dense: only {loss['exact']} of "
                             f"{2 * DENSE_NEW} tokens are the teacher-forced "
                             f"argmax")
    info = {"model": cfg.name, "layers": cfg.num_layers,
            "draft_layers": dcfg.num_layers,
            "params": sum(t.numel() for t in target.parameters()),
            "draft_params": sum(t.numel() for t in draft.parameters()),
            "model_init_s": init_s,
            "greedy": {"wall_s": t1 - t0, "tpot_wall_s":
                       res_g.metrics.tpot_wall,
                       "decode_attention_launches": g_dec,
                       "decode_attention_replayed": g_replayed,
                       "host_launches": g_launches["host"]},
            "sd": {"wall_s": t2 - t1s, "tpot_wall_s": res_s.metrics.tpot_wall,
                   "iterations": res_s.metrics.iterations,
                   "drafted": drafted, "accepted": res_s.metrics.accepted,
                   "decode_attention_launches": s_dec,
                   "host_launches": s_launches["host"]},
            "launches": launches, "decode_step_ms": step_ms,
            "decode_step_profile": step_prof, "graphs": graphs,
            "lossless": loss}
    del greedy, sd, target, draft, cache
    gc.collect()
    torch.cuda.empty_cache()
    return info


def dense_replay_ab(target, draft, greedy, sd, prompts):
    """llama3.2-3b's greedy step and sd x none iteration (draft_len 4) at
    position 512 as the engines serve them (a pool slot's caches, the
    captured step) against the eager step on copies of the caches: bit for
    bit, then timed in turns (``replay_ab``)."""
    import torch
    from repro_torch.core import sd as S
    dev = target.device
    out = {}
    slot = greedy._pool.take()
    p0 = prompts[0].to(dev)
    _, cache = target.prefill(p0, DENSE_MAX_SEQ, cache=slot.tcache)
    tok = p0[:, -1:]
    step = S.make_greedy_step(target, greedy.graphs)
    ref = clone_tree(cache)
    want = S.make_greedy_step(target)(ref, tok, DENSE_PROMPT)
    got = step(cache, tok, DENSE_PROMPT, slot)
    torch.cuda.synchronize()
    if not torch.equal(got, want) or not tree_equal(cache, ref):
        raise AssertionError("the greedy step's replay differs from its "
                             "eager body")
    out["greedy_step"] = {"position": DENSE_PROMPT, "bit_equal": True,
                          **replay_ab(lambda: S.make_greedy_step(target)(
                              ref, tok, DENSE_PROMPT),
                              lambda: step(cache, tok, DENSE_PROMPT, slot),
                              FOCUS_DECODE)}
    greedy._pool.give(slot)
    slot = sd._pool.take()
    p1 = prompts[1].to(dev)
    _, tc = target.prefill(p1, DENSE_MAX_SEQ, cache=slot.tcache)
    _, dc = draft.prefill(p1, DENSE_MAX_SEQ, cache=slot.dcache)
    cur = p1[:, -1:]
    step = S.make_sd_step(draft, target, 4, sd.graphs)
    eager = S.make_sd_step(draft, target, 4)
    tcc, dcc = clone_tree(tc), clone_tree(dc)
    want = eager(dcc, tcc, cur, DENSE_PROMPT)
    got = step(dc, tc, cur, DENSE_PROMPT, slot)
    if got.tokens != want.tokens or not tree_equal(tc, tcc) \
            or not tree_equal(dc, dcc):
        raise AssertionError("the sd iteration's replay differs from its "
                             "eager body")
    out["sd_iteration"] = {"position": DENSE_PROMPT, "draft_len": 4,
                           "bit_equal": True,
                           **replay_ab(lambda: eager(dcc, tcc, cur,
                                                     DENSE_PROMPT),
                                       lambda: step(dc, tc, cur,
                                                    DENSE_PROMPT, slot),
                                       FOCUS_DECODE)}
    sd._pool.give(slot)
    out["greedy_engine"] = graph_summary(greedy.graphs)
    out["sd_engine"] = graph_summary(sd.graphs)
    return out


def deepseek_phase(dev):
    """deepseek-v2-lite-16b at full width, 1 dense + 3 MoE layers, bf16,
    ``attn_impl="kernel"`` (MLA takes no attention kernel under it), target
    seed 0 with its routed experts on the host, the derived dense MLA draft
    (4 layers, d_ff 10944) seed 1: the expert FFN against its plain version
    at top-6 over a 48-slot pool; sd x spmoe with a tight cache (48 slots,
    two 64-token requests, 32 new tokens each: misses, waves, evictions) and
    an ample one (192 slots: <= 2 host syncs per fast block; the counters
    reset after the first request), the launch counts set to 0 just before
    and read just after; then two 256-token requests two at a time on a
    cache preloaded with every expert (fused rounds, <= 2 syncs each, one
    all-hit round equal to the solo blocks bit for bit); then every token
    teacher-forced through the resident experts."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import derive_draft_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              num_layers=DS_LAYERS, attn_impl="kernel")
    dcfg = derive_draft_config(cfg)
    if (cfg.d_model, cfg.moe_d_ff, cfg.num_experts_per_tok) != \
            (DS_D, DS_F, DS_K):
        raise AssertionError(f"deepseek widths: {cfg}")
    rows, timing = kernel_phase(dev, DS_D, DS_F, k=DS_K, pool=DS_TIGHT,
                                prefill_slots=DS_TIGHT, seed=10)
    log(f"[12] deepseek expert FFN matches its plain version ({len(rows)} "
        f"checks): {[timing[T]['timing'] for T in timing]}")
    t0 = time.perf_counter()
    target = build_model(cfg, dev, seed=0, expert_device="cpu")
    draft = build_model(dcfg, dev, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = [torch.randint(0, cfg.vocab_size, (1, DS_PROMPT),
                             generator=torch.Generator().manual_seed(70 + i))
               for i in range(4)]
    reset_launches()
    eng, tight, tight_info = serve_phase("ds-tight", target, draft, cfg,
                                         dcfg, DS_TIGHT, prompts[:2], DS_NEW,
                                         spy=False)
    tight_tot = check_tight(tight)
    log(f"[12] deepseek tight cache ok: {tight_tot}")
    eng.close()
    del eng
    gc.collect()
    eng, ample, ample_info = serve_phase("ds-ample", target, draft, cfg,
                                         dcfg, DS_AMPLE, prompts[2:], DS_NEW,
                                         spy=True)
    solo_launches = read_launches("deepseek solo serving", DS_PATH)
    ample_tot = check_ample(ample, ample_info)
    log(f"[12] deepseek ample cache ok: {ample_tot}; steady "
        f"{ample_info['steady']}; launches {solo_launches}")
    preload_every_expert(eng.runtime)
    ds_graphs = {"verify_block": verify_replay_ab(eng.runtime, 103),
                 "engine": graph_summary(eng.graphs)}
    log(f"[12] deepseek eager against replay: {ds_graphs}")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    conc_prompts = [torch.randint(0, cfg.vocab_size, (1, DS_CONC_PROMPT),
                                  generator=torch.Generator().manual_seed(
                                      80 + i))
                    for i in range(DS_CONC_REQS)]
    conc, conc_info, launches = concurrent_phase(
        target, draft, cfg, dcfg, conc_prompts, slots=DS_AMPLE,
        new_tokens=DS_NEW, kernels=DS_PATH, name="ds-concurrent",
        preload=True)
    log(f"[12] deepseek concurrent serving ok: {conc_info}; "
        f"launches {launches}")
    gc.collect()
    torch.cuda.empty_cache()
    # the reference's pairing: the target's architecture as its own draft
    # (seed 1, its 3.3 GB of routed experts resident on the card), one
    # request on a cache preloaded with every expert; each draft step runs
    # the expert FFN at top-6 of 64, T 1
    sdraft = build_model(cfg, dev, seed=1)
    self_prompt = torch.randint(0, cfg.vocab_size, (1, DS_SELF_PROMPT),
                                generator=torch.Generator().manual_seed(
                                    DS_SELF_SEED))
    self_res, self_info = moe_draft_request(
        "ds-self-draft", target, sdraft, cfg, cfg, DS_AMPLE, self_prompt,
        DS_NEW, DS_PATH)
    log(f"[12] deepseek MoE self-draft ok: {self_info}")
    del sdraft
    for path, got in (("solo", solo_launches), ("concurrent", launches),
                      ("self-draft", self_info["launches"])):
        if got["flash_attention"] or got["decode_attention"]:
            raise AssertionError(f"deepseek {path}: MLA took an attention "
                                 f"kernel: {got}")
    gc.collect()
    torch.cuda.empty_cache()
    for blk in target.layers:            # the experts resident on the card
        for n in ("wg", "wu", "wd"):
            w = getattr(blk.moe, n)
            setattr(blk.moe, n, torch.nn.Parameter(w.to(dev),
                                                   requires_grad=False))
    results = tight + ample + conc + [self_res]
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts + conc_prompts + [self_prompt],
                                       results)],
                          dev, margin=DS_MARGIN)
    n_tok = sum(len(r.tokens) for r in results)
    if loss["exact"] < DS_MIN_EXACT * n_tok:
        raise AssertionError(f"deepseek: only {loss['exact']} of {n_tok} "
                             f"tokens are the teacher-forced argmax")
    info = {
        "model": cfg.name, "layers": {"dense": cfg.first_dense_layers,
                                      "moe": cfg.num_moe_layers},
        "draft_layers": dcfg.num_layers, "draft_d_ff": dcfg.d_ff,
        "params_resident": sum(t.numel() for n, t in target.named_parameters()
                               if not n.endswith(("moe.wg", "moe.wu",
                                                  "moe.wd"))),
        "params_routed_experts": sum(
            getattr(b.moe, n).numel() for b in target.layers
            for n in ("wg", "wu", "wd")),
        "draft_params": sum(t.numel() for t in draft.parameters()),
        "model_init_s": init_s,
        "requests": [{"id": r.request_id, "tokens": len(r.tokens),
                      "tpot_wall_s": r.metrics.tpot_wall,
                      "hit_rate": r.metrics.hit_rate,
                      **{k: r.metrics[k] for k in (
                          "verify_blocks", "fast_blocks", "fast_fallbacks",
                          "host_syncs", "on_demand_loads", "prefetched",
                          "evictions")}} for r in results],
        "tight": {**tight_tot, "slots": DS_TIGHT,
                  "pinned_staging_bytes": tight_info["pinned_staging_bytes"]},
        "ample": {**ample_tot, "slots": DS_AMPLE,
                  "steady_after_reset": ample_info["steady"]},
        "concurrent": conc_info, "launches_solo_path": solo_launches,
        "launches_concurrent_path": launches, "self_draft": self_info,
        "graphs": ds_graphs, "lossless": loss, "min_exact": DS_MIN_EXACT}
    del target, draft
    gc.collect()
    torch.cuda.empty_cache()
    return info, rows, timing


def check_draft_launches(name, results, launches, dcfg, steps: int):
    """Every drafted token ran the draft's MoE layers through the kernel:
    the expert-FFN calls whose kernels the device ran between the markers
    of the path's ``steps`` draft steps (``mark_draft_steps``), as the
    path's trace counts them (``read_launches``)."""
    drafted = sum(r.metrics.drafted for r in results)
    got = launches["draft"]
    calls = min(got["cache_moe_gate_up"], got["cache_moe_down"])
    if launches["draft_marks"] != 2 * steps:
        raise AssertionError(f"{name}: {launches['draft_marks']} markers "
                             f"for {steps} draft steps")
    if drafted <= 0 or calls < drafted * dcfg.num_moe_layers:
        raise AssertionError(f"{name}: {calls} MoE draft layer launches "
                             f"for {drafted} drafted tokens")
    return {"drafted": drafted, "draft_steps": steps,
            "draft_moe_calls": got["cache_moe_gate_up"],
            "draft_down_calls": got["cache_moe_down"]}


def moe_draft_request(name, target, draft, cfg, dcfg, slots, prompt,
                      new_tokens, kernels):
    """One sd x spmoe request with an MoE draft on a cache preloaded with
    every expert, the launch counts set to 0 just before and read just
    after; each of ``kernels`` must have launched, and each drafted token
    through every MoE layer of the draft."""
    import torch
    from repro_torch.core.engine import Engine, EngineConfig, Request
    eng = Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                              offload="spmoe", cache_slots=slots,
                              draft_len=4, max_seq=256), target, draft)
    rt = eng.runtime
    preload_every_expert(rt)
    steps = []
    mark_draft_steps(rt, steps)
    reset_launches()
    res = eng.submit(Request(prompt=prompt, max_new_tokens=new_tokens,
                             request_id=f"{name}-0"))
    torch.cuda.synchronize()
    launches = read_launches(name, kernels)
    del rt._draft_step
    if len(res.tokens) != new_tokens or res.finish_reason != "length":
        raise AssertionError(f"{name}: the request ended "
                             f"{res.finish_reason} after {len(res.tokens)} "
                             f"tokens")
    info = {"launches": launches,
            **check_draft_launches(name, [res], launches, dcfg,
                                   len(steps)),
            "tpot_wall_s": res.metrics.tpot_wall,
            "hit_rate": res.metrics.hit_rate,
            **{k: res.metrics[k] for k in ("verify_blocks", "fast_blocks",
                                           "fast_fallbacks", "host_syncs",
                                           "on_demand_loads")}}
    info["graphs"] = {"drafting_stage": draft_stage_ab(rt, prompt),
                      "engine": graph_summary(eng.graphs)}
    eng.close()
    return res, info


def sync_warnings(fn):
    """The synchronizing operations ``fn`` runs, as CUDA sync debugging
    (``"warn"``) reports them: each warns "called a synchronizing CUDA
    operation" (the mode's notice that it is a prototype is not one)."""
    import warnings

    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message) for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


def draft_step_check(moe_draft, dense_draft, vocab: int, dev):
    """The MoE draft's decode step against a dense draft's of the same
    depth, each after a 100-token prefill: one warm step under CUDA sync
    debugging (``sync_warnings``), whose expert-FFN
    launches must be one gate_up and one down per MoE layer (none for the
    dense draft), and the drafting stage of one verify block
    (``BLOCK_T - 1`` steps, as ``breakdown`` times mixtral's) timed.  The
    MoE step may make no more syncs than the dense one; a readback of
    ``.item()`` first shows that the debugging sees a sync."""
    import torch
    from repro_torch.kernels import cache_moe as K
    control = sync_warnings(lambda: torch.ones(1, device=dev).sum().item())
    if not control:
        raise AssertionError("sync debugging missed the readback of .item()")
    prompt = torch.randint(0, vocab, (1, 100), generator=torch.Generator(
        ).manual_seed(110)).to(dev)
    tok = prompt[:, -1:]
    out = {}
    for name, m in (("moe", moe_draft), ("dense", dense_draft)):
        _, cache = m.prefill(prompt, 256)
        m.decode_step(cache, tok, 100, collect_taps=True)        # warm
        torch.cuda.synchronize()
        g0, d0 = K.gate_up.launches, K.down.launches
        syncs = sync_warnings(lambda: m.decode_step(cache, tok, 101,
                                                    collect_taps=True))
        launches = [K.gate_up.launches - g0, K.down.launches - d0]
        stage_ms = cuda_ms(lambda: [m.decode_step(cache, tok, 102 + i,
                                                  collect_taps=True)
                                    for i in range(BLOCK_T - 1)])
        want = [m.cfg.num_moe_layers] * 2 if m.cfg.is_moe else [0, 0]
        if launches != want:
            raise AssertionError(f"{name} draft step: expert-FFN launches "
                                 f"{launches}, expected {want}")
        out[name] = {"layers": m.cfg.num_layers, "syncs": len(syncs),
                     "sync_messages": sorted(set(syncs))[:3],
                     "expert_ffn_launches": launches,
                     "drafting_stage_ms": stage_ms,
                     "drafting_steps": BLOCK_T - 1}
    if out["moe"]["syncs"] > out["dense"]["syncs"]:
        raise AssertionError(f"the MoE draft step syncs more than the "
                             f"dense one: {out}")
    out["control_item_syncs"] = len(control)
    return out


def phi_phase(dev):
    """phi-3.5-moe at full width with its MoE draft phi-mini-moe, both cut
    to 4 layers, bf16, ``attn_impl="kernel"``, target seed 0 with its routed
    experts on the host, draft seed 1 with its experts on the card: the
    expert FFN against its plain version at the target's widths (f 6400,
    16-slot pool, timed at T 5) and the draft's (f 960, its 16 experts,
    timed at T 1 and T 512); sd x spmoe with a tight cache (16 slots, two
    64-token requests, 32 new tokens each) and an ample one (64 slots:
    <= 2 host syncs per fast block; counters reset after the first
    request), the launch counts set to 0 just before and read just after,
    every drafted token through the draft's MoE layers on the kernel; one
    MoE draft step against the derived dense draft's (no more syncs); then
    every token teacher-forced through the resident experts."""
    import torch
    from repro_torch.configs.registry import get_config, get_draft_config
    from repro_torch.core.engine import derive_draft_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config("phi-3.5-moe"),
                              num_layers=PHI_LAYERS, attn_impl="kernel")
    dcfg = dataclasses.replace(get_draft_config("phi-3.5-moe"),
                               num_layers=PHI_LAYERS, attn_impl="kernel")
    widths = (cfg.d_model, cfg.moe_d_ff, dcfg.moe_d_ff, cfg.num_experts,
              dcfg.num_experts, cfg.num_experts_per_tok, dcfg.family)
    if widths != (PHI_D, PHI_F, PHI_DRAFT_F, PHI_E, PHI_E, PHI_K, "moe"):
        raise AssertionError(f"phi widths: {widths}")
    rows, timing = kernel_phase(dev, PHI_D, PHI_F, pool=PHI_E,
                                prefill_slots=PHI_E, seed=20,
                                timed=(BLOCK_T,))
    drows, dtiming = kernel_phase(dev, PHI_D, PHI_DRAFT_F, pool=PHI_E,
                                  prefill_slots=PHI_E, seed=21,
                                  timed=(1, CONC_PROMPT))
    log(f"[13] phi expert FFN matches its plain version "
        f"({len(rows) + len(drows)} checks): target "
        f"{timing[BLOCK_T]['timing']}; draft "
        f"{[dtiming[T]['timing'] for T in dtiming]}")
    t0 = time.perf_counter()
    target = build_model(cfg, dev, seed=0, expert_device="cpu")
    draft = build_model(dcfg, dev, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    prompts = [torch.randint(0, cfg.vocab_size, (1, PHI_PROMPT),
                             generator=torch.Generator().manual_seed(100 + i))
               for i in range(4)]
    reset_launches()
    steps = []
    eng, tight, tight_info = serve_phase("phi-tight", target, draft, cfg,
                                         dcfg, PHI_TIGHT, prompts[:2],
                                         PHI_NEW, spy=False,
                                         draft_calls=steps)
    tight_tot = check_tight(tight)
    log(f"[13] phi tight cache ok: {tight_tot}")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, ample, ample_info = serve_phase("phi-ample", target, draft, cfg,
                                         dcfg, PHI_AMPLE, prompts[2:],
                                         PHI_NEW, spy=True, draft_calls=steps)
    launches = read_launches("phi solo serving")
    ample_tot = check_ample(ample, ample_info)
    drafts = check_draft_launches("phi solo serving", tight + ample,
                                  launches, dcfg, len(steps))
    log(f"[13] phi ample cache ok: {ample_tot}; steady "
        f"{ample_info['steady']}; launches {launches}; {drafts}")
    preload_every_expert(eng.runtime)
    phi_graphs = {"verify_block": verify_replay_ab(eng.runtime, 101),
                  "moe_drafting_stage": draft_stage_ab(eng.runtime,
                                                       prompts[0]),
                  "engine": graph_summary(eng.graphs)}
    log(f"[13] phi eager against replay: {phi_graphs}")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    dense = build_model(derive_draft_config(cfg), dev, seed=2)
    steps = draft_step_check(draft, dense, cfg.vocab_size, dev)
    log(f"[13] phi draft step: {steps}")
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    for blk in target.layers:            # the experts resident on the card
        for n in ("wg", "wu", "wd"):
            w = getattr(blk.moe, n)
            setattr(blk.moe, n, torch.nn.Parameter(w.to(dev),
                                                   requires_grad=False))
    results = tight + ample
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts, results)],
                          dev, margin=PHI_MARGIN)
    n_tok = sum(len(r.tokens) for r in results)
    if loss["exact"] < PHI_MIN_EXACT * n_tok:
        raise AssertionError(f"phi: only {loss['exact']} of {n_tok} tokens "
                             f"are the teacher-forced argmax")
    info = {
        "model": cfg.name, "draft": dcfg.name, "layers": cfg.num_layers,
        "draft_layers": dcfg.num_layers,
        "params_resident": sum(t.numel() for n, t in target.named_parameters()
                               if not n.endswith(("moe.wg", "moe.wu",
                                                  "moe.wd"))),
        "params_routed_experts": sum(
            getattr(b.moe, n).numel() for b in target.layers
            for n in ("wg", "wu", "wd")),
        "draft_params": sum(t.numel() for t in draft.parameters()),
        "draft_params_routed_experts": sum(
            getattr(b.moe, n).numel() for b in draft.layers
            for n in ("wg", "wu", "wd")),
        "model_init_s": init_s,
        "requests": [{"id": r.request_id, "tokens": len(r.tokens),
                      "tpot_wall_s": r.metrics.tpot_wall,
                      "hit_rate": r.metrics.hit_rate,
                      **{k: r.metrics[k] for k in (
                          "verify_blocks", "fast_blocks", "fast_fallbacks",
                          "host_syncs", "on_demand_loads", "prefetched",
                          "evictions", "drafted")}} for r in results],
        "tight": {**tight_tot, "slots": PHI_TIGHT,
                  "pinned_staging_bytes": tight_info["pinned_staging_bytes"]},
        "ample": {**ample_tot, "slots": PHI_AMPLE,
                  "pinned_staging_bytes": ample_info["pinned_staging_bytes"],
                  "steady_after_reset": ample_info["steady"]},
        "launches_solo_path": launches, "draft_launches": drafts,
        "draft_step": steps, "graphs": phi_graphs, "lossless": loss,
        "min_exact": PHI_MIN_EXACT,
        "host_max_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    del target, draft
    gc.collect()
    torch.cuda.empty_cache()
    return info, rows + drows, timing, dtiming


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from repro_torch.configs.registry import get_config, get_draft_config
    from repro_torch.kernels import _build
    from repro_torch.models.registry import build_model

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    log(f"[1] {card}; torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    ptxas = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"[1] kernels built in {build_s:.1f} s")
    for name, text in ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")

    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=4,
                              attn_impl="kernel")
    dcfg = dataclasses.replace(get_draft_config("mixtral-8x7b"),
                               num_layers=4, attn_impl="kernel")
    rows, main_k = kernel_phase(dev, cfg.d_model, cfg.moe_d_ff)
    gelu_rows, gelu_k = kernel_phase(dev, cfg.d_model, cfg.moe_d_ff,
                                     gelu=True, seed=4)
    fa_rows, fa_timing = flash_phase(dev)
    dec_rows, dec_timing = decode_phase(dev)
    ssd_rows, ssd_timing = ssd_phase(dev)
    rows += gelu_rows + fa_rows + dec_rows + ssd_rows
    log(f"[2] kernels match their plain versions ({len(rows)} checks); "
        f"flash {fa_timing}; decode {dec_timing}; ssd {ssd_timing}")

    t0 = time.perf_counter()
    target = build_model(cfg, dev, seed=0, expert_device="cpu")
    draft = build_model(dcfg, dev, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"[3] models built in {init_s:.1f} s")
    prompts = [torch.randint(0, cfg.vocab_size, (1, 64),
                             generator=torch.Generator().manual_seed(2 + i))
               for i in range(4)]

    # the solo serving path: counts from 0 just before, read just after
    reset_launches()
    eng, tight, tight_info = serve_phase("tight", target, draft, cfg, dcfg,
                                         12, prompts[:2], 32, spy=False)
    tight_tot = check_tight(tight)
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[3] tight cache ok: {tight_tot}")
    eng, ample, ample_info = serve_phase("ample", target, draft, cfg, dcfg,
                                         32, prompts[2:], 32, spy=True)
    solo_launches = read_launches("solo serving")
    ample_tot = check_ample(ample, ample_info)
    log(f"[4] ample cache ok: {ample_tot}; launches {solo_launches}")
    brk = breakdown(eng, draft, dev)
    log(f"[4] breakdown {brk}")
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()

    conc_prompts = [torch.randint(0, cfg.vocab_size, (1, CONC_PROMPT),
                                  generator=torch.Generator().manual_seed(
                                      20 + i))
                    for i in range(CONC_REQS)]
    conc, conc_info, launches = concurrent_phase(target, draft, cfg, dcfg,
                                                 conc_prompts)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[5] concurrent serving ok: {conc_info}; launches {launches}")

    # phase 6: the same target with its experts resident on the card
    for blk in target.layers:
        for n in ("wg", "wu", "wd"):
            w = getattr(blk.moe, n)
            setattr(blk.moe, n, torch.nn.Parameter(w.to(dev),
                                                   requires_grad=False))
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts + conc_prompts,
                                       tight + ample + conc)], dev)
    log(f"[6] lossless: {loss}")
    del target, draft
    gc.collect()
    torch.cuda.empty_cache()

    # phase 7: gelu experts, sd x spmoe
    gelu_info = gelu_phase(dev)
    log(f"[7] gelu-expert serving ok: {gelu_info}")

    # phases 8-10: the SSD families, greedy x none, all weights resident
    gen = torch.Generator().manual_seed(40)
    mcfg = get_config("mamba2-780m")
    ssm_prompts = [torch.randint(0, mcfg.vocab_size, (1, n), generator=gen)
                   for n in SSM_PROMPTS]
    mamba_reqs, mamba_info = ssm_phase("mamba2", mcfg, dev, ssm_prompts,
                                       SSM_NEW)
    log(f"[8] mamba2-780m serving ok: {mamba_info}")
    # zamba2-7b's shared attention block (32 / 32 heads x 112) through the
    # flash kernel in every prefill and flash-decode in every greedy step
    zcfg = dataclasses.replace(get_config("zamba2-7b"),
                               num_layers=ZAMBA_LAYERS, attn_impl="kernel")
    zamba_reqs, zamba_info = ssm_phase(
        "zamba2", zcfg, dev, [torch.randint(0, zcfg.vocab_size, (1, 512),
                                            generator=gen)], SSM_NEW,
        kernels=("ssd_scan", "flash_attention", "decode_attention"))
    log(f"[9] zamba2-7b serving ok: {zamba_info}")

    # phase 11: the dense target at full width and depth, greedy and sd
    dense_info = dense_phase(dev)
    log(f"[11] llama3.2-3b serving ok: {dense_info}")

    # phase 12: deepseek-v2-lite-16b (MLA, a dense layer, shared experts)
    ds_info, ds_rows, ds_k = deepseek_phase(dev)
    rows += ds_rows
    log(f"[12] deepseek-v2-lite-16b serving ok: {ds_info}")

    # phase 13: phi-3.5-moe with its MoE draft phi-mini-moe
    phi_info, phi_rows, phi_k, phi_dk = phi_phase(dev)
    rows += phi_rows
    log(f"[13] phi-3.5-moe serving ok: {phi_info}")

    # the eager-against-replay measures, printed on their own line
    graphs_mixtral = {**brk.pop("graphs"),
                      "concurrent_engine": conc_info.pop("graphs")}
    graphs_ds = {**ds_info.pop("graphs"),
                 "concurrent_engine": ds_info["concurrent"].pop("graphs"),
                 "self_drafting_stage": ds_info["self_draft"]["graphs"].pop(
                     "drafting_stage"),
                 "self_draft_engine": ds_info["self_draft"].pop("graphs")[
                     "engine"]}
    graphs_phi = phi_info.pop("graphs")
    graphs_dense = dense_info.pop("graphs")

    kernels = []
    # the expert FFN at the verify block (T 5) and, one row more per stage,
    # at the concurrent path's 512-token prefill block
    for T, suffix in ((BLOCK_T, ""), (CONC_PROMPT, f"_t{CONC_PROMPT}")):
        for name, line in (("cache_moe_gate_up", 28), ("cache_moe_down", 47)):
            t = main_k[T]["timing"][name]
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": "src/repro_torch/csrc/cache_moe.cu",
                "replaces": f"src/repro/kernels/moe_gemm.py:{line}",
                "launches": launches[name],
                "launches_host": launches["host"][name],
                "launches_solo_path": solo_launches[name], "T": T,
                "max_abs_err": main_k[T]["err"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    t = fa_timing[CONC_PROMPT]
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:27",
        "launches": launches["flash_attention"],
        "launches_host": launches["host"]["flash_attention"],
        "launches_solo_path": solo_launches["flash_attention"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "kernel_ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"]})
    t = ssd_timing[f"mamba2_S{SSM_PROMPTS[0]}"]
    kernels.append({
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:26",
        "launches": mamba_info["launches"],
        "launches_host": mamba_info["host_launches"],
        "launches_zamba2_path": zamba_info["launches"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "kernel_ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "kernels_per_call": t["kernels_per_call"]})
    t = dec_timing["llama3.2-3b"]
    kernels.append({
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:26",
        "launches": dense_info["launches"]["decode_attention"],
        "launches_host": dense_info["launches"]["host"]["decode_attention"],
        "launches_concurrent_path": launches["decode_attention"],
        "launches_solo_path": solo_launches["decode_attention"],
        "launches_gelu_path": gelu_info["launches"]["decode_attention"],
        "max_abs_err": t["max_abs_err"], "ms": t["ms"], "kernel_ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"],
        "library_device_ms": t["library_device_ms"]})
    for T, suffix in ((BLOCK_T, ""), (CONC_PROMPT, f"_t{CONC_PROMPT}")):
        t = gelu_k[T]["timing"]["cache_moe_up_gelu"]
        kernels.append({
            "name": "cache_moe_up_gelu" + suffix, "route": "cuda",
            "source": "src/repro_torch/csrc/cache_moe.cu",
            "replaces": "src/repro/kernels/cache_moe.py:120",
            "launches": gelu_info["launches"]["cache_moe_up_gelu"], "T": T,
            "launches_host": gelu_info["launches"]["host"][
                "cache_moe_up_gelu"],
            "max_abs_err": gelu_k[T]["err"]["cache_moe_up_gelu"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"]})
    # the expert FFN at deepseek's widths and top-6 (48-slot pool)
    for T, suffix in ((BLOCK_T, ""), (CONC_PROMPT, f"_t{CONC_PROMPT}")):
        for name, line in (("cache_moe_gate_up", 28), ("cache_moe_down", 47)):
            t = ds_k[T]["timing"][name]
            kernels.append({
                "name": f"{name}_deepseek{suffix}", "route": "cuda",
                "source": "src/repro_torch/csrc/cache_moe.cu",
                "replaces": f"src/repro/kernels/moe_gemm.py:{line}",
                "launches": ds_info["launches_concurrent_path"][name],
                "launches_host": ds_info["launches_concurrent_path"]["host"][
                    name],
                "launches_solo_path": ds_info["launches_solo_path"][name],
                "T": T, "k": DS_K, "pool": DS_TIGHT,
                "max_abs_err": ds_k[T]["err"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    # the expert FFN at phi-3.5-moe's widths (T 5, 16-slot pool) and at
    # phi-mini-moe's, its MoE draft's (T 1 and T 512 over its 16 experts);
    # launches: the phi solo path's, and of those the draft's
    for T, tm, suffix, draft_row in (
            (BLOCK_T, phi_k, "_phi", False),
            (1, phi_dk, "_phi_draft", True),
            (CONC_PROMPT, phi_dk, f"_phi_draft_t{CONC_PROMPT}", True)):
        for name, line in (("cache_moe_gate_up", 28), ("cache_moe_down", 47)):
            t = tm[T]["timing"][name]
            kernels.append({
                "name": name + suffix, "route": "cuda",
                "source": "src/repro_torch/csrc/cache_moe.cu",
                "replaces": f"src/repro/kernels/moe_gemm.py:{line}",
                "launches": phi_info["launches_solo_path"][name],
                "launches_host": phi_info["launches_solo_path"]["host"][name],
                "launches_draft": phi_info["draft_launches"][
                    "draft_moe_calls" if name == "cache_moe_gate_up"
                    else "draft_down_calls"],
                "row": "draft" if draft_row else "target",
                "T": T, "k": PHI_K, "pool": PHI_E,
                "f": PHI_DRAFT_F if draft_row else PHI_F,
                "max_abs_err": tm[T]["err"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"decode_timing": dec_timing}))
    print(json.dumps({"flash_timing": {
        "shape": {"B": 1, "H": FA_HEADS, "Hkv": FA_KV_HEADS, "D": FA_DIM,
                  "dtype": "bfloat16", "causal": True},
        **{f"S{S}": t for S, t in fa_timing.items()}}}))
    print(json.dumps({"ssd_timing": {
        "shape": {"b": 1, "dtype": "bfloat16"}, **ssd_timing}}))
    print(json.dumps({"kernel_checks": rows,
                      "timing_shape": {
                          "k": K_TOP, "pool": S_POOL, "dtype": "bfloat16",
                          **{f"T{T}": {n: {k: v for k, v in t.items()
                                           if k in ("touched_slots", "rows")}
                                       for n, t in {
                                           **main_k[T]["timing"],
                                           **gelu_k[T]["timing"]}.items()}
                             for T in (BLOCK_T, CONC_PROMPT)}}}))
    print(json.dumps({"requests": [
        {"id": r.request_id, "tokens": len(r.tokens),
         "tpot_wall_s": r.metrics.tpot_wall,
         "hit_rate": r.metrics.hit_rate,
         "acceptance_rate": r.metrics.acceptance_rate,
         **{k: r.metrics[k] for k in ("verify_blocks", "fast_blocks",
                                      "fast_fallbacks", "host_syncs",
                                      "on_demand_loads", "prefetched",
                                      "evictions")}}
        for r in tight + ample + conc],
        "tight": tight_tot, "ample": ample_tot,
        "ample_steady_after_reset": ample_info["steady"],
        "concurrent": conc_info, "lossless": loss}))
    print(json.dumps({"ssm_requests": mamba_reqs + zamba_reqs,
                      "mamba2": mamba_info, "zamba2": zamba_info}))
    print(json.dumps({"gelu_requests": gelu_info}))
    print(json.dumps({"dense_requests": dense_info}))
    print(json.dumps({"deepseek_requests": ds_info}))
    print(json.dumps({"deepseek_kernel_timing": {
        "shape": {"d": DS_D, "f": DS_F, "k": DS_K, "pool": DS_TIGHT,
                  "dtype": "bfloat16"},
        **{f"T{T}": ds_k[T]["timing"] for T in (BLOCK_T, CONC_PROMPT)}}}))
    print(json.dumps({"phi_requests": phi_info}))
    print(json.dumps({"phi_kernel_timing": {
        "shape": {"d": PHI_D, "k": PHI_K, "pool": PHI_E, "dtype": "bfloat16"},
        f"target_f{PHI_F}_T{BLOCK_T}": phi_k[BLOCK_T]["timing"],
        **{f"draft_f{PHI_DRAFT_F}_T{T}": phi_dk[T]["timing"]
           for T in (1, CONC_PROMPT)}}}))
    print(json.dumps({"breakdown": brk}))
    print(json.dumps({"graphs": {
        "launch_counting": "a path's launches are the calls whose kernels "
                           "the device ran in that path's torch.profiler "
                           "trace (replays included; the SSD paths, all "
                           "eager, untraced); launches_host are "
                           "the wrappers' own counts (eager calls and "
                           "builds' warm-ups; a capture launches nothing, "
                           "a replay calls no wrapper)",
        "mixtral-8x7b": graphs_mixtral, "deepseek-v2-lite-16b": graphs_ds,
        "phi-3.5-moe": graphs_phi, "llama3.2-3b": graphs_dense}}))
    print(json.dumps({"memory": {
        "device_max_allocated_bytes": torch.cuda.max_memory_allocated(),
        "pinned_staging_bytes": {"tight": tight_info["pinned_staging_bytes"],
                                 "ample": ample_info["pinned_staging_bytes"]},
        "host_max_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024},
        "seconds": {"build": build_s, "model_init": init_s,
                    "engine_setup_tight": tight_info["setup_s"],
                    "engine_setup_ample": ample_info["setup_s"],
                    "total": time.perf_counter() - t_start}}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
