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
experts top-2 of width 6400) at full width cut to 2 layers with its MoE
draft phi-mini-moe (experts of width 960, resident on the card), whose
every draft step runs its MoE layers through the expert-FFN kernels with
no host sync; the tight mixtral engine under seeded I/O faults; and the
other dense targets at full width (granite-20b at full depth,
command-r-35b and nemotron-4-340b cut in depth), greedy and speculative,
through flash and flash-decode at their head shapes (48 / 1 x 128, 64 / 8
x 128, 96 / 8 x 192).  Then training (``launch/train.py::Trainer``):
mixtral-8x7b at full width cut to 2 layers and llava-next-mistral-7b at
full width cut to 2 layers, bf16, through the MoE capacity route
``moe_grouped``, and the SSD families (mamba2-780m at full depth, zamba2-7b
at 12 layers) through the plain scan; no kernel is on the training path,
as in the reference (it trains through none of its Pallas kernels).  Last,
whisper-medium (encdec) at full width and depth: served through flash and
flash-decode at 16 / 16 x 64, and trained.

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
     nemotron-4-340b; 48 / 1 x 128, granite-20b; 64 / 8 x 128,
     command-r-35b; and 384 with a 100 window at 96 / 8 x 192), each timed
     shape one device kernel per
     call; flash-decode at the llama3.2-3b and mixtral-draft
     widths and those four, lengths 1 / 77 / 512 / 543 / 4096 in caches of
     576 and 4112 (timed at 543 of 576 at every width a served request
     steps at), and three rows of mixed lengths each equal to its one-row
     call bit for bit; the SSD scan at the mamba2 widths at S 77 / 300 / 512 / 2048 and
     the zamba2 widths at S 512 and 300, 300 padded to 384, y and final
     state, timed (event and device time, its three device kernels per
     call) at mamba2 S 512 / 2048 and zamba2 S 512); flash and flash-decode
     also at whisper-medium's 16 / 16 x 64 (flash at S 128 and 512, timed at
     both; flash-decode also in a 192-slot cache, lengths 129..192, timed
     at 192), and at head shapes no model here has (``EXTRA_SHAPES``:
     phi-2's 32 / 32 x 80, phi-3-mini's 32 / 32 x 96, gemma-7b's 16 / 16 x
     256, falcon-7b's 71 / 1 x 64 (flash-decode only) and 32 / 8 x 40, a
     width padded in the kernels' loads), flash timed at S 512 and
     flash-decode at 543 of 576; attention at head dims 4, 20, 100, 264,
     320 and 512 (bf16 flash on wgmma: narrow copies up to 256, the wide
     instance past it; f32 flash and flash-decode in the CUDA-core
     instance) with 1, 4 and 8 q heads per kv head (flash at S 256, causal
     and with a 100 window; flash-decode at 543 / 1 / 77 of 576 keys and
     three mixed rows), timed at 32 / 8 heads, and flash on unaligned
     views at D 64 and 128 (bit for bit the aligned call); the SSD scan also at mamba2's widths at chunk 256 (S 512 and
     300), chunks 160 and 131 and states of 160 and 256 columns, and from a
     given state (two halves, the second from the first's final state,
     against the whole), each timed; the expert FFN also at widths whose
     bf16 rows are no whole number of 16 bytes (d 100 / f 204 and d 4092 /
     f 14332, swiglu, and gelu's up stage at the first: the tensor-core
     body's narrow copies, the instance each ran in the kernels line); head
     dim 0 and a
     chunk that does not divide S must raise
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
  5b. the tight engine (12 slots) under seeded faults (fetch errors at
     0.1, staged payloads corrupted at 0.05, latency spikes at 0.05): the
     staging check first (back-to-back fetch + insert of 12 experts in
     batches of 2 on one thread, more batches than the store's two pinned
     staging buffers, no sync between; every slot must equal its store
     row), then two 64-token requests of 32 new tokens (the requests'
     metrics must show prefetch retries and checksum failures, and no
     io_error), then one concurrent round of a warm request (the first
     prompt again) and a cold one whose own ``store.fetch`` raises: its
     prefill must miss, it ends ``io_error``, and the warm one ends
     ``length`` with its full stream
  6. lossless check: every emitted token of phases 3-5b against the
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
  8b. mamba2-780m again at Mamba2's published chunk 256, the same prompts:
     48 SSD launches per prefill (a 512-token prompt in two chunks of
     256), its teacher-forced logits against the plain scan's at chunk 256
     and its tokens against phase 8's where the top-2 margin is clear; its
     prefill timed beside phase 8's
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
     top-2 of width 6400; 2 layers, bf16, ``attn_impl="kernel"``) with its
     MoE draft phi-mini-moe (16 experts of width 960, 2 layers, resident):
     the expert FFN against its plain version at the target's widths (a
     16-slot pool, timed at T 5) and the draft's (its 16 experts, timed at
     T 1 and T 512), bf16 and f32, batch invariance; sd x spmoe with a
     tight cache (8 slots for 32 experts) and an ample one (32 slots: <= 2
     host syncs per fast block, counters reset after the first request),
     every drafted token through the draft's MoE layers on the kernel (by
     the host's record of each draft step and by the trace between the
     step's markers, ``check_draft_launches``; ``--phase phi-draft <n>``
     runs this path n times, then twice with a draft layer's kernels
     skipped, uncounted and counted, which must each fail the check); one
     MoE draft decode step under CUDA sync debugging against the derived
     dense draft's of the same depth (no more syncs; one gate_up and one
     down launch per MoE layer), both drafting stages timed; the fast
     verify block and the MoE drafting stage replayed against their eager
     bodies (as in phase 4); every token teacher-forced
 14-16. granite-20b (52 layers, d 6144, 48 / 1 heads x 128, gelu d_ff
     24576, vocab 49152; full depth, a 26-layer draft), command-r-35b (d
     8192, 64 / 8 x 128, swiglu d_ff 22528, vocab 256000, tied embeddings;
     8 / 4 layers) and nemotron-4-340b (d 18432, 96 / 8 x 192, relu2 d_ff
     73728, vocab 256000; 2 / 2 layers) as phase 11: a 512-token prompt
     greedy x none and one sd x none with the derived draft, 32 new tokens
     each; flash once per layer per prefill and flash-decode once per
     layer per one-token step, every call at the model's head shape; one
     warm decode step timed; the greedy step and sd iteration replayed
     against their eager bodies; every token teacher-forced; each prints
     its TPOT (the requests served again untraced, the same tokens),
     decode step ms, its own device memory peak and its seconds

 17. training, in a child process (``--phase train``): ``ops.moe_gemm``
     (the dense-layout expert FFN, the expert-FFN kernel's two stages)
     against its plain version at mixtral's widths, 8 experts x C 64, bf16
     (timed) and f32; then mixtral-8x7b (2 layers, 3.16 B parameters),
     bf16, B 4 x S 1024 from the port's data pipeline in 2 microbatches,
     remat full: one forward and backward with every parameter's gradient
     finite and nonzero; 8 AdamW steps (lr 3e-4) whose losses are finite
     and whose last 3 average below the first, ``moe_grouped`` run in every
     MoE layer (forward and remat recompute of each microbatch); 3 steps
     of AdamW8bit with int8 gradient compression on a fresh trainer (finite
     losses); llava-next-mistral-7b (2 layers, 576 patch embeddings + 448
     text tokens, B 2) for 3 AdamW steps, its logits over the text only;
     printed: losses, grad_norm and lr per step, the median step time
     after step 1 (CUDA events), tokens/s, the step's matmul FLOPs against
     989 TFLOP/s and each optimizer's device memory peak.  Then training on
     a mesh, over a 1-rank NCCL group (``launch/train.py::Trainer(mesh=
     single_device_mesh())``, every parameter a DTensor laid out by
     ``models/placement.py``): mixtral the same for 5 steps, its losses
     against the plain run's within 1e-3 relative (bit-equality reported),
     its untraced step ms and peak, and what the dry-run's reshard
     fallback (``placement.Reshard``) would cost the step: steps with and
     without it, alternated, and the ops it ran on gathered inputs (none
     expected: the train path has no fallback); the same pairs of
     llama3.2-3b steps on the mesh; and a checkpoint across meshes:
     llama3.2-3b at full width, 2
     layers, B 4 x S 1024, 3 steps on the mesh, saved at step 3 (~7 GB),
     restored into a plain ``Trainer`` and onto a fresh 1-rank mesh (every
     tensor bit-equal to the saved one), 2 more steps in each, both equal to
     5 uninterrupted steps under ``torch.use_deterministic_algorithms``.
     Then one f32 step
     of a reduced mixtral on the card against the CPU (loss and every
     gradient within 1e-4 relative); a train step under
     ``attn_impl="kernel"`` raising (flash attention has no backward); and
     the restart drill: ``examples/train_lm_torch.py`` at its tiny default
     (a failure at step 100, the restart from its checkpoint), and 10 steps
     straight against 5 + restart + 5, bit for bit under
     ``torch.use_deterministic_algorithms(True)``.  Then the SSD families
     through ``Trainer``: mamba2-780m at full width and depth (48 layers,
     0.78 B parameters) and zamba2-7b at full width, 12 layers, bf16, B 4 x
     S 1024, 6 AdamW steps each (losses finite, the last 3 below the
     first; step ms, peak), the SSD kernel launched 0 times in training
     (the train route scans with the plain ``ssd_ref``) and once per mamba
     layer in a prefill of the trained model; mamba2-780m again for 3
     steps of AdamW8bit with int8 gradient compression (the first two
     losses finite; ``A_log`` / ``D`` / ``dt_bias``, 48 a layer, quantized
     as the reference's stacked leaves, [9, 256] each; its median step
     beside the AdamW run's); one f32 step of each, reduced, on the card
     against the CPU
 18. whisper-medium, in a child process (``--phase whisper``): 24 encoder
     + 24 decoder layers at full width (d 1024, 16 / 16 heads x 64, gelu
     d_ff 4096, vocab 51865, tied), bf16, random weights from seed 0, frames
     [1, 1500, 1024] from a seeded generator; served under
     ``attn_impl="kernel"``: encode, prefill of a 128-token prompt, 64
     greedy one-token steps (the launch counts from 0: flash 24, once per
     decoder layer; flash-decode 24 per step; every call at 16 / 16 x 64;
     the encoder and the cross-attention run ``mha``), served again for its
     times (the same tokens), one step timed and traced, every token
     teacher-forced (the deep stacks' rule); then 6 AdamW steps under
     ``"xla"`` through ``make_train_step`` at B 4 x S 448 with a frames
     batch each step (losses finite and falling; step ms, tokens/s, peak),
     and one f32 step of the reduced model on the card against the CPU
 19. sequence-parallel Mamba2 prefill, in a child process (``--phase
     seqpar``): mamba2-780m at full width and depth (48 layers), bf16, B 1
     x S 32768 (prefill_32k's sequence; its batch cut from 32 to 1 so that
     four ranks share the one card), each rank holding one shard of the
     sequence and scanning it with the SSD kernel
     (``models/mamba_sp.py``): a 1-rank NCCL group, then gloo groups of 2
     and 4 ranks (``--phase seqpar-rank``, one process each on the card);
     each run's last-position logits against the single-process forward
     under the deep stacks' rule (max abs error within ``SEQPAR_TOL``
     logits; the argmax, or a near tie within that margin), 48 SSD
     launches per rank (counted from 0 around the rank's
     forward), each rank's forward time and device memory peak; a 4-layer
     f32 run over 4 gloo ranks (the same argmax, within 1e-3); the SSD
     kernel against its
     plain version at each shard shape (timed); and one dry-run cell
     (``launch/dryrun.py``, llama3.2-3b decode_32k on the 16x16 mesh over
     a fake process group, on the host) that must end ok

Phases 5b, 14-16, 17, 18 and 19 run first, right after the build, each in
a child process of this script (``--phase chaos``, ``--phase dense
<arch>``, ``--phase train``, ``--phase whisper``, ``--phase seqpar``)
that prints its result as one JSON line: it has the
card's whole memory
(nemotron-4-340b's two models need 70 GB) and a profiler of its own (in
one process, a trace after the chaos phase's once saw no device activity
in five windows running).

Every serving engine runs with ``EngineConfig.precompile`` on: its fast
verify blocks of the ladder length, its draft steps, and (offload none) its
greedy steps and sd iterations are replays of captured steps.  A replay
calls no kernel wrapper, so the wrappers count only the launches they make
(eager calls, a build's warm-up); a capture launches nothing.

Each serving path (3-4, 5, 5b, 7, 8, 9, 11 greedy, 11 sd, 12 solo, 12
concurrent, 12 self-draft, 13 solo, 14-16 greedy and sd, 18) runs with the
kernels' launch counts set to 0 and a ``torch.profiler`` trace of the
device started just before it, both read just after: a kernel's launches
on the path are the calls whose kernels the device ran in the trace
(replays included), beside the wrappers' own counts.  The SSD paths (8,
9) and whisper's (18) capture nothing and go untraced: there every launch
is its wrapper's own.  Each kernel of the path must have launched through
its wrapper and run on the device, and every counted launch must have run.
Where a path has an MoE draft (12 self-draft, 13), every drafted token must
have run each MoE layer of the draft through the kernel, by two counts:
the host's record of each draft step (the wrappers' launches and each
replayed capture's recorded calls) and the device's, the calls the trace
holds between a marker kernel put before and after each draft step.  The
profiler's trace now and then loses a whole replay's records; the device
count forgives a step whose window it lost whole, and nothing else.

Prints JSON lines (kernels, decode_timing, flash_timing, ssd_timing,
kernel_checks, requests, ssm_requests, gelu_requests, dense_requests,
dense_targets, chaos_requests, train, whisper, seqpar, deepseek_requests,
deepseek_kernel_timing, phi_requests, phi_kernel_timing,
breakdown, graphs (every eager-against-replay measure, each engine's builds,
capture seconds and private pool bytes, the concurrent engines' fused
rounds among them), memory), then the
card's name and power limit, then ``{"ok":
true, "device": {...}}`` as the last line.  Exits non-zero, printing no
result, without a CUDA device or without the rest of the repository.
Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import json
import math
import os
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
# in phase 9, the three dense targets in phases 14-16, whisper-medium's
# decoder self-attention in phase 18 (at D 192 the bf16 kernel takes 64-key
# tiles, which moves where p rounds by at most one bf16 step)
FA_SHAPES = (("zamba2-7b", 32, 32, 112), ("nemotron-4-340b", 96, 8, 192),
             ("granite-20b", 48, 1, 128), ("command-r-35b", 64, 8, 128),
             ("whisper-medium", 16, 16, 64))
# flash at whisper-medium's served prefill too: one 128-key block a layer
FA_WHISPER = FA_SHAPES[-1]
# head shapes of public models that no model of this repository has, which
# the attention kernels take (any head dim that is a multiple of 8 from 8 to
# 256, any number of q heads per kv head): phi-2 (D 80), phi-3-mini (D 96),
# gemma-7b (D 256), falcon-7b (71 q heads on 1 kv head) and a width padded
# inside the kernel's loads (D 40 runs in the 64 instance); each held
# against its plain version (f32 and bf16) and timed (bf16) by flash at S
# 512 (not falcon-7b) and by flash-decode at 543 of 576 keys.  No model
# path launches them: their rows in the kernels line have 0 launches.
EXTRA_SHAPES = (("phi-2", 32, 32, 80), ("phi-3-mini", 32, 32, 96),
                ("gemma-7b", 16, 16, 256), ("falcon-7b", 71, 1, 64),
                ("padded-40", 32, 8, 40))
FA_EXTRA = tuple(x for x in EXTRA_SHAPES if x[0] != "falcon-7b")
# head dims no TMA instance takes: rows TMA cannot load (bf16 rows of 8, 40
# and 200 bytes) and D past 256 (128-column output slices).  bf16 runs them
# on the tensor cores (the TMA instance's kernel with narrow copies, and
# the wide instance past 256; flash on wgmma, flash-decode on mma.sync; the
# kernels line names the instance that ran), f32 in the CUDA-core instance
# (csrc/attention_any.cuh).
# Each with ANY_REPS q heads per kv head (8 q heads), causal and with an
# ANY_WINDOW window (flash at S ANY_S; flash-decode at 543, 1 and 77 of 576
# keys), bf16 and f32, against the plain versions at the served shapes'
# tolerances; timed (bf16) at 32 / 8 heads, flash at S 512 and flash-decode
# at 543 of 576.  No model path launches them: their rows in the kernels
# line have the wrappers' launches at those shapes over every main path (0).
# D 0 must still raise.
ANY_HEAD_DIMS = (4, 20, 100, 264, 320, 512)
ANY_REPS = (1, 4, 8)
ANY_S, ANY_WINDOW = 256, 100
ANY_TIMED = (32, 8)                   # timed heads: q, kv
# lossless check: the engine (5-token verify blocks, f32 expert combine) and
# the resident reference (one teacher-forced forward, bf16 combine) round
# the bf16 residual stream at different places; a token that is not the
# reference's argmax must be within this many logits of it.
MARGIN = 0.25
CONC_PROMPT, CONC_NEW, CONC_REQS = 512, 32, 4     # phase 5
# phase 5b: the tight engine under seeded faults (fetch errors, staged
# payloads corrupted, latency spikes), two requests of CHAOS_NEW tokens,
# then the io_error round's two of CHAOS_IO_NEW
CHAOS_SLOTS, CHAOS_NEW, CHAOS_IO_NEW = 12, 32, 8
CHAOS = {"seed": 7, "fetch_error_rate": 0.1, "corrupt_rate": 0.05,
         "spike_rate": 0.05}
# SSD scan: (name, heads, head dim p, state n, chunk, sequence lengths); the
# chunk of a length is min(chunk, S), and a length past it that it does
# not divide is padded at the end with dt = 0, as mamba_forward pads it.
# Past the served widths (mamba2 and zamba2 at chunk 128): mamba2 at
# Mamba2's published chunk 256 (state-spaces/mamba's Mamba2 and Hugging
# Face's Mamba2Config), chunks 160 and 131 (prime) that the kernel's
# 128-row tiles cut raggedly, and states of 160 and 256 columns (its
# 128-column blocks).  Tolerance of y relative to its max |value|: f32
# differs from the plain version in summation order and in how the prefix
# sums of dt*A are taken; bf16 also in y's one rounding (2^-8 of an
# element).  The final state is f32 in both types: 1e-4.
SSD_SHAPES = (("mamba2", 48, 64, 128, 128, (77, 300, 512, 2048)),
              ("zamba2", 112, 64, 64, 128, (512, 300)),
              ("mamba2-c256", 48, 64, 128, 256, (512, 300)),
              ("c160", 8, 64, 64, 160, (320,)),
              ("c131", 8, 64, 64, 131, (262,)),
              ("n160", 8, 64, 160, 128, (512,)),
              ("n256", 8, 64, 256, 256, (512,)))
SSD_TOL = {"float32": 1e-4, "bfloat16": 1e-2}
SSD_STATE_TOL = 1e-4
# timed (bf16): (name, S); a call is three device kernels (each tile's end
# state, the carry from tile to tile, y)
SSD_TIMED = (("mamba2", 512), ("mamba2", 2048), ("zamba2", 512),
             ("mamba2-c256", 512), ("c160", 320), ("c131", 262),
             ("n160", 512), ("n256", 512))
# from a given state: the sequence scanned in two halves, the second from
# the first's final state, against one scan of the whole (name, S)
SSD_INIT = (("mamba2", 512), ("mamba2-c256", 512), ("c131", 262),
            ("n256", 512))
SSD_KERNELS_PER_CALL = 3
SSM_PROMPTS, SSM_NEW = (512, 512, 300), 32            # phase 7
# phase 8b: mamba2-780m served again at Mamba2's published chunk 256
# (state-spaces/mamba's Mamba2 module, Hugging Face's Mamba2Config; the
# repository's configs use 128): the same prompts, its 512-token ones
# prefilled as two chunks of 256.  Its teacher-forced logits through the
# SSD kernel against those through the plain scan at chunk 256 (the
# model's train route, ``ssd_ref``): within SSM_C256_TOL logits, the deep
# stacks' margin (bf16 through 48 layers, where the kernel's f32 summation
# order alone moved logits by up to 0.31); and its tokens against the chunk
# 128 run's, up to the first that differs, which must be a near tie (top-2
# margin of the teacher-forced logits within SSM_MARGIN).
SSM_CHUNK = 256
# the expert FFN at widths whose bf16 rows are no whole number of 16 bytes
# (the tensor-core body's narrow copies; f32 on the FMA body): d 100 /
# f 204, and mixtral's widths less 4
# (d 4092, f 14332), swiglu experts (gate_up, down) at both and gelu
# experts' up stage at the first; checked at T 1 / 5 / 64 / 512 in bf16
# and f32 with the batch-invariance check, timed (bf16) at T 5 and T 512.
# No model path launches them: their rows in the kernels line have the
# stages' launches at those widths over every main path (0).
FFN_ANY = ((100, 204), (4092, 14332))
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
SSM_C256_TOL = SSM_MARGIN                             # phase 8b
# flash-decode: (model, q heads, kv heads, head dim) and (cache length,
# three mixed lengths, the model timed at the first of them).  Tolerance:
# the reference's own sweep (tests/test_kernels.py), atol 2e-5 f32 / 2e-2
# bf16 plus rtol 1e-2: f32 differs in summation order and where the softmax
# is split, bf16 also in that the plain version rounds the scores and p to
# bf16 (as the reference's decode_attention_ref) and the kernel p only.
DECODE_WIDTHS = (("llama3.2-3b", 24, 8, 128),
                 ("mistral-7b-draft", 32, 8, 128), *FA_SHAPES,
                 *EXTRA_SHAPES)
DECODE_CACHES = ((576, (543, 1, 77), ("llama3.2-3b", "zamba2-7b",
                                      "nemotron-4-340b", "granite-20b",
                                      "command-r-35b",
                                      *(x[0] for x in EXTRA_SHAPES),
                                      *(f"D{D}" for D in ANY_HEAD_DIMS))),
                 (4112, (4096, 1, 512), ("mistral-7b-draft",)),
                 # whisper-medium's served steps: lengths 129..192 of 192
                 (192, (192, 129, 160), ("whisper-medium",)))
# the head dims no TMA instance takes, in the 576-key cache only: timed at
# ANY_TIMED heads, checked also at each of ANY_REPS
DECODE_ANY = (*((f"D{D}", *ANY_TIMED, D) for D in ANY_HEAD_DIMS),
              *((f"D{D}-{r}to1", 8, 8 // r, D) for D in ANY_HEAD_DIMS
                for r in ANY_REPS if r != ANY_TIMED[0] // ANY_TIMED[1]))
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
# phases 14-16: the other dense targets at full width, each with its
# derived half-depth draft, as deep as one card holds both in bf16 (and a
# draw's f32 temporary): (arch, target layers (None: full depth), prompt
# seed).  granite-20b at full depth, 52 / 26 layers of 0.76 GB: 40.6 +
# 20.9 GB.  command-r-35b cut to 8 / 4 layers of 1.41 GB beside its tied
# 4.2 GB embedding: 15.5 + 9.8 GB (full depth, 40 / 20, would be 60.6 +
# 32.5).  nemotron-4-340b cut to 2 / 2 layers of 6.9 GB beside a 9.4 GB
# embedding and a 9.4 GB head in each model: 32.7 + 32.7 GB.
DENSE_TARGETS = (("granite-20b", None, 61), ("command-r-35b", 8, 62),
                 ("nemotron-4-340b", 2, 63))
CHILD_TIMEOUT_S = 400                # a phase run in a child process

# phase 18, whisper-medium (encdec), in a child process (``--phase
# whisper``): the whole model (24 encoder + 24 decoder layers, d 1024, 16 /
# 16 heads x 64, gelu d_ff 4096, vocab 51865, tied), bf16, random weights
# from seed 0, frames [B, 1500, 1024] (the stub frontend's output) from a
# seeded generator.  Served under attn_impl="kernel": a 128-token prompt
# (one 128-key flash block a decoder layer), then 64 greedy one-token steps
# over a 192-slot cache (flash-decode at lengths 129..192); every token
# teacher-forced under the deep stacks' rule (a margin and a minimum exact
# share).  Trained under "xla" (flash has no backward): AdamW, B 4 x S 448
# (whisper's decoder context) from the port's pipeline with a frames batch
# each step, remat full, at WHISPER_TRAIN_LR: phase 17's 3e-4 diverged on
# an H100 (losses 20.8, 35.4, 35.2, 47.7, 31.2, 27.6): the tied embedding
# drawn at scale sqrt(d) starts whisper at loss ~21, and Adam's first
# steps move every weight by ~lr (whisper's published lr for medium,
# 2.5e-4, comes with 2048 warmup steps).
WHISPER_PROMPT, WHISPER_NEW = 128, 64
WHISPER_MAX_SEQ = WHISPER_PROMPT + WHISPER_NEW
WHISPER_MARGIN, WHISPER_MIN_EXACT = SSM_MARGIN, SSM_MIN_EXACT
WHISPER_TRAIN_B, WHISPER_TRAIN_S, WHISPER_TRAIN_STEPS = 4, 448, 6
WHISPER_TRAIN_LR = 5e-5

# phase 19, sequence-parallel Mamba2 prefill (``models/mamba_sp.py``), in a
# child process (``--phase seqpar``): mamba2-780m at full width and depth
# (48 layers, d 1536, 48 heads x 64, state 128, vocab 50280), bf16, random
# weights from seed 0, B 1 x S 32768: prefill_32k's sequence, its batch cut
# from 32 to 1 so that four ranks share the one card.  Each rank holds one
# contiguous shard of the sequence and the whole model, and scans its shard
# with the SSD kernel (one launch per layer): a 1-rank NCCL group, and gloo
# groups of 2 and 4 ranks (each a process of its own on the one card; gloo
# takes the tiny payloads through the host).  Each run's last-position
# logits against the single-process ``forward`` (the plain ssd_ref over the
# whole sequence) under the deep stacks' rule: a max abs error within
# SEQPAR_TOL logits, and the reference's argmax or a token the reference
# ranks within SSM_MARGIN of its top (bf16 through 48 layers, where the
# kernel's f32 summation order alone moved logits by up to 0.31; the
# shards' scans also round y at other places than the whole sequence's,
# and fold the incoming state in f32 after the scan; on an H100 the 4-rank
# run's argmax was the reference's second token, 3.797 against 3.859).
# The exact check
# is the reduced-depth f32 run (4 layers, S 4096, 4 gloo ranks): the same
# argmax, within SEQPAR_F32_TOL absolute.  The SSD
# kernel against ssd_ref at each run's shard shape (S 32768, 16384, 8192);
# one dry-run cell (``launch/dryrun.py``: llama3.2-3b decode_32k on the
# 16x16 mesh over a fake process group, on the host) must end ok.
SEQPAR_S, SEQPAR_SEED = 32768, 50
SEQPAR_RUNS = (("nccl", 1), ("gloo", 2), ("gloo", 4))
SEQPAR_TOL = SSM_MARGIN
SEQPAR_F32_LAYERS, SEQPAR_F32_S, SEQPAR_F32_RANKS = 4, 4096, 4
SEQPAR_F32_TOL = 1e-3
SEQPAR_DRYRUN = ("llama3.2-3b", "decode_32k")
SEQPAR_RANK_TIMEOUT_S = 240

# phase 17, training (``launch/train.py::Trainer``): mixtral-8x7b at full
# width (d 4096, 32 / 8 heads x 128, 8 experts top-2 of width 14336, vocab
# 32000) cut to 2 layers, 3.16 B parameters: bf16, remat full, B 4 x S 1024
# in 2 microbatches from the port's pipeline (S 1024 > 8: every MoE layer
# takes moe_grouped's capacity route, C 320), AdamW for 8 steps at lr 3e-4
# (2 warmup steps, cosine to the 8th), then AdamW8bit with int8 gradient
# compression for 3 on a fresh trainer; llava-next-mistral-7b at full
# width, 2 layers: 576 patch embeddings + 448 text tokens, B 2, AdamW, 3
# steps.  The card's f32 step against the CPU's (reduced mixtral): loss
# and every gradient within TRAIN_CPU_RTOL of the CPU's largest magnitude.
TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_MICRO = 2, 4, 1024, 2
TRAIN_STEPS, TRAIN_8BIT_STEPS, TRAIN_LR, TRAIN_WARMUP = 8, 3, 3e-4, 2
VLM_B, VLM_S, VLM_STEPS = 2, 1024, 3
# the SSD families through Trainer (the train route scans with the plain
# ssd_ref; the SSD kernel must launch 0 times): mamba2-780m at full width
# and depth (48 layers), zamba2-7b at full width cut to ZAMBA_LAYERS (as
# served in phase 9); B 4 x S 1024, AdamW, remat full
SSD_TRAIN = (("mamba2-780m", None), ("zamba2-7b", ZAMBA_LAYERS))
SSD_TRAIN_B, SSD_TRAIN_S, SSD_TRAIN_STEPS = 4, 1024, 6
TRAIN_CPU_RTOL = 1e-4
# phase 17 on a 1-rank mesh: mixtral's steps against the plain run's
MESH_STEPS, MESH_LOSS_RTOL = 5, 1e-3
MODE_AB_PAIRS = 3   # mesh steps without and with the reshard mode, each
MOE_GEMM_C = 64                      # ops.moe_gemm rows per expert
PEAK_BF16_FLOPS = 989e12             # H100 SXM, dense bf16

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
# cut to 2 layers (4 until the script's later phases needed its time), a
# depth that keeps the Table 1 pair layer for layer: the target's 32 routed
# experts are 5.0 GB of bf16 on the host (at full depth 80.5 GB).  Pools of
# 8 (tight) and 32 slots (ample: every expert).
# The expert FFN is checked and timed at the target's verify block (T 5,
# a 16-slot pool) and at the draft's step (T 1) and prefill (T 512) over
# its 16 resident experts.
PHI_LAYERS, PHI_TIGHT, PHI_AMPLE = 2, 8, 32
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


_PEAK = [0]                     # the script's device memory peak so far


def reset_peak():
    """Start a phase's own peak of device memory
    (``torch.cuda.max_memory_allocated``), keeping the script's."""
    import torch
    _PEAK[0] = max(_PEAK[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def script_peak() -> int:
    import torch
    return max(_PEAK[0], torch.cuda.max_memory_allocated())


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


# what was timed by CUDA events because the profiler saw nothing of it,
# printed with the timing lines (``profiler_fallbacks``)
PROFILER_FALLBACKS: list = []
_PROFILER_COLD = [False]     # the last window came back empty


def device_spans(fn, iters: int, keep=None, tries: int = 5):
    """Durations (us) of the device activities ``torch.profiler`` saw over
    ``iters`` warm calls of ``fn``, those whose names ``keep`` accepts where
    it is given.  A window can come back with no device activity at all
    (seen right after a plain version's thousands of launches, and in the
    phi expert-FFN timing just after the deepseek paths' traces of 100 000
    to 300 000 activities): it is traced again, after a pause that doubles
    each time.  After ``tries`` empty windows, ``[]``; while the profiler
    stays blind, a later call traces two windows only."""
    import time
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    tries = 2 if _PROFILER_COLD[0] else tries
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        seen = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        spans = [e.time_range.end - e.time_range.start for e in seen
                 if keep is None or keep(e.name)]
        _PROFILER_COLD[0] = not seen
        if spans:
            return spans
        log(f"the profiler saw none of the device activity sought (window "
            f"{attempt + 1} of {tries}; {len(seen)} other activities, "
            f"{sorted({e.name[:60] for e in seen})[:3]})")
        if attempt + 1 < tries:
            time.sleep(0.5 * 2 ** attempt)
    return []


def fall_back(fn, iters: int, what: str) -> float:
    """Where the profiler saw no device activity of ``fn``: its CUDA-event
    time per call over ``iters`` calls instead (it holds every launch of
    the call and the host's issue time between them), noted in
    ``PROFILER_FALLBACKS``."""
    ms = cuda_ms(fn, iters)
    PROFILER_FALLBACKS.append({"what": what, "event_ms": ms})
    log(f"{what}: the profiler saw no device activity; timed by CUDA "
        f"events instead, {ms:.4f} ms")
    return ms


def traced(fn, iters: int = 50, what: str = "a call"):
    """Device time per call of ``fn`` in ms, the summed durations of the
    kernels and copies ``torch.profiler`` saw over ``iters`` warm calls
    (unlike ``cuda_ms``, not set by the host's issue time), and the device
    activities per call.  Where the profiler saw none, the CUDA-event time
    (``fall_back``) and ``None`` activities."""
    spans = device_spans(fn, iters)
    if not spans:
        return fall_back(fn, iters, what), None
    # the profiler may drop an event or two of a long window: count whole
    # activities per call, and time them by the mean of those it kept
    per_call = max(1, round(len(spans) / iters))
    return sum(spans) / len(spans) * per_call / 1e3, per_call


def traced_ms(fn, iters: int = 50, what: str = "a call") -> float:
    return traced(fn, iters, what)[0]


def kernel_name(name: str, full: bool = False) -> str:
    """A device kernel's name as the profiler gives it, without its
    parameter list and namespaces: with ``full`` its template arguments
    kept (which instance ran), else its base name."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = name.split("(")[0]
    return name if full else name.split("<")[0].split("::")[-1]


def kernel_device_ms(fn, prefix: str, iters: int = 10) -> float:
    """Device time per call of ``fn``'s kernels whose names start with
    ``prefix`` (one kernel of several that a call launches), from
    ``torch.profiler``; where it saw no device activity, ``fn``'s
    CUDA-event time (``fall_back``)."""
    spans = device_spans(fn, iters,
                         lambda name: kernel_name(name).startswith(prefix))
    if not spans:
        if not _PROFILER_COLD[0]:
            raise AssertionError(f"the profiler saw no {prefix} kernel")
        return fall_back(fn, iters, prefix)
    return sum(spans) / len(spans) / 1e3          # one such kernel a call


def kernel_instances(fn, prefix: str, iters: int = 3):
    """The full names (``kernel_name(..., full=True)``: which instance
    ran) of ``fn``'s device kernels whose base names start with
    ``prefix``, from one profiler window; ``None`` where the profiler saw
    no device activity at all."""
    spans = device_spans(fn, iters, keep=None, tries=2)
    if not spans:
        return None
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sorted({kernel_name(e.name, full=True) for e in prof.events()
                   if e.device_type == DeviceType.CUDA
                   and kernel_name(e.name).startswith(prefix)})


def require_instance(names, pattern: str, what: str):
    """Fail unless the instances the profiler saw (``kernel_instances``)
    are all of ``pattern``: the route a call was meant to take.  A blind
    profiler (``None``) is noted in ``PROFILER_FALLBACKS``."""
    if names is None:
        PROFILER_FALLBACKS.append({"what": f"instance of {what}",
                                   "event_ms": None})
        return
    if not names or not all(re.search(pattern, n) for n in names):
        raise AssertionError(f"{what} ran {names}, not {pattern}")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_phase(dev, d: int, f: int, gelu: bool = False, k: int = K_TOP,
                 pool: int = S_POOL, prefill_slots: int = 8, seed: int = 0,
                 timed=(BLOCK_T, CONC_PROMPT),
                 dtypes=("bfloat16", "float32")):
    """The expert-FFN stages against their plain versions at T 1 / 5 / 64 /
    512, in each of ``dtypes``, with a batch-invariance check: swiglu
    experts (gate_up, then down), or with ``gelu`` the gelu experts' route
    (up_gelu, then down).  Each token takes ``k`` slots of a ``pool``-slot
    pool; the T 512 call (a prefill block) routes into its first
    ``prefill_slots``.  The bf16 calls at the row counts ``timed`` are
    timed."""
    import torch
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import ref as R
    stage1 = "cache_moe_up_gelu" if gelu else "cache_moe_gate_up"
    experts = "gelu" if gelu else "swiglu"
    gen = torch.Generator(dev).manual_seed(seed)
    rows, main = [], {}
    for dt_name in dtypes:
        dt = getattr(torch, dt_name)

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
        out[name] = {"instances": kernel_instances(kern, "slot_ffn")
                     if (d, f) in FFN_ANY else None,
                     "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain),
                     "library_ms": cuda_ms(lib),
                     "device_ms": kernel_device_ms(kern, "slot_ffn"),
                     "library_device_ms": traced_ms(
                         lib, iters=10, what=f"bmm for {name} T{x.shape[0]}"),
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
    D 192, granite's 48 : 1, whisper-medium's 16 / 16 x 64, also at its
    served prefill's S 128), and at every head dim of ANY_HEAD_DIMS (bf16:
    the narrow copies and the wide instance; f32: the CUDA-core instance)
    with each of ANY_REPS q heads per kv head, causal and windowed, bf16
    and f32, and on unaligned views (the narrow copies against the TMA
    route, bit for bit); timed (bf16) at S 512 and 2048 (32 heads),
    S 512 (24 heads), S 512 of each FA_SHAPES model and of each
    ANY_HEAD_DIMS width (32 / 8 heads) and S 128 of whisper-medium: event
    time, and device time from the profiler for the kernel, the plain
    version and SDPA.  Head dim 0 must raise."""
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
              for m, h, hkv, d in FA_SHAPES + FA_EXTRA),
            (128, None, both, FA_WHISPER[1:] + FA_WHISPER[:1]),
            (384, 100, both, FA_SHAPES[1][1:] + (None,)),
            *((512, None, ("bfloat16",), (*ANY_TIMED, D, f"D{D}"))
              for D in ANY_HEAD_DIMS),
            *((ANY_S, w, both, (8, 8 // r, D, None))
              for D in ANY_HEAD_DIMS for r in ANY_REPS
              for w in (None, ANY_WINDOW))):
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
            if dt_name == "bfloat16" and window is None and (
                    S in (512, 2048) or model == FA_WHISPER[0]):
                bound, by = flash_bound(S, window, 2, H, Hkv, D)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                kern = lambda: FA.flash_attention(q, k, v)  # noqa: E731
                plain = lambda: R.flash_attention_ref(q, k, v)  # noqa: E731
                F = torch.nn.functional
                sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, is_causal=True, enable_gqa=True)
                sdpa()                  # the yardstick at this head dim
                dev_ms, per_call = traced(kern, what=f"flash S{S} D{D}")
                if per_call not in (None, 1):
                    raise AssertionError(f"flash_attention S={S}: {per_call} "
                                         f"device kernels per call, not 1")
                key = S if (H, D) == (FA_HEADS, FA_DIM) else \
                    f"{S}_{model}" if model else f"{S}_h{H}"
                # at ANY_HEAD_DIMS the plain version takes event times only
                # (the script's time)
                served = D not in ANY_HEAD_DIMS
                timing[key] = {
                    "H": H, "Hkv": Hkv, "D": D,
                    "instances": kernel_instances(kern, "flash_fwd"),
                    "ms": cuda_ms(kern),
                    "plain_ms": cuda_ms(plain, iters=2),
                    "library_ms": cuda_ms(sdpa),
                    "device_ms": dev_ms,
                    "plain_device_ms": traced_ms(plain, iters=2)
                    if served else None,
                    "library_device_ms": traced_ms(sdpa),
                    "bound_ms": bound, "bound_by": by, "max_abs_err": err}
            del q, k, v, got, want
    # unaligned views (bf16, 32 / 8 heads, S 512, causal): q, k and v one
    # element into wider rows (strides and pointers off 16 bytes) take the
    # narrow copies of the TMA instance at D 64 and 128, and give the
    # aligned call's bits
    for D in (64, 128):
        q, k, v = [torch.randn((1, 512, h, D + 1), generator=gen,
                               device=dev).bfloat16()[..., 1:]
                   for h in (FA_HEADS, FA_KV_HEADS, FA_KV_HEADS)]
        got = FA.flash_attention(q, k, v)
        same = torch.equal(got, FA.flash_attention(
            *(t.contiguous() for t in (q, k, v))))
        names = kernel_instances(lambda: FA.flash_attention(q, k, v),
                                 "flash_fwd")
        require_instance(names, rf"^flash_fwd_wgmma<{D}, true>$",
                         f"flash on unaligned views at D {D}")
        rows.append({"kernel": "flash_attention", "check": "unaligned_views",
                     "route": FA.route(q, k, v), "instances": names,
                     "dtype": "bfloat16", "S": 512, "D": D,
                     "equal_to_aligned": same, "ok": same})
        if not same:
            raise AssertionError(f"flash on unaligned views at D {D} differs "
                                 f"from the aligned call")
        del q, k, v, got
    q = torch.zeros((1, 128, 4, 0), dtype=torch.bfloat16, device=dev)
    try:
        FA.flash_attention(q, q, q)
    except ValueError as e:
        rows.append({"kernel": "flash_attention", "D": 0,
                     "refused": str(e), "ok": True})
    else:
        raise AssertionError("flash_attention took head dim 0")
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


def decode_instance(dt_name: str, D: int) -> str:
    """The instance flash-decode must run a head dim no TMA instance takes
    in (a pattern for ``require_instance``): bf16 the narrow copies of the
    tensor-core kernel to D 256, the wide instance past it; f32 the
    CUDA-core instance."""
    if dt_name == "float32":
        return r"^attn_any::attention_any<float, true>$"
    return r"^decode_mma<\d+, \d+, true>$" if D <= 256 else \
        r"^decode_wide<\d+>$"


def decode_phase(dev):
    """The flash-decode kernel against its plain version at the llama3.2-3b
    and mixtral-draft widths and the head shapes of FA_SHAPES, and in the
    576-key cache at the head dims no TMA instance takes (``DECODE_ANY``),
    bf16 and f32: one row at each length that fits the cache, and three
    rows of mixed lengths whose every row must equal its own one-row call
    bit for bit; at DECODE_ANY each dtype's instance, as the profiler names
    it (bf16: the narrow copies of ``decode_mma`` to D 256, ``decode_wide``
    past it; f32: ``attention_any``).  Unaligned views (bf16, k and v one
    element into wider rows) at D 64 and 128 take the narrow copies and
    give the aligned call's bits.  Timed (bf16, one row) at length 543 of
    576 (llama3.2-3b, zamba2-7b, the dense targets, ANY_HEAD_DIMS at 32 / 8
    heads), 4096 of 4112 (mixtral draft) and 192 of 192 (whisper-medium's
    last served step).  Head dim 0 must raise."""
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

    any_models = {w[0] for w in DECODE_ANY}
    for (model, H, Hkv, D), caches in (
            *((w, DECODE_CACHES) for w in DECODE_WIDTHS),
            *((w, DECODE_CACHES[:1]) for w in DECODE_ANY)):
        for S, mixed, timed in caches:
            for dt_name in ("bfloat16", "float32"):
                dt = getattr(torch, dt_name)
                q = torch.randn((3, H, D), generator=gen, device=dev).to(dt)
                k, v = [torch.randn((3, S, Hkv, D), generator=gen,
                                    device=dev).to(dt) for _ in range(2)]
                errs = {}
                # the timed length is checked alone too
                for n in sorted(set(DECODE_LENGTHS) | {mixed[0]}):
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
                instances = None
                if model in any_models:
                    instances = kernel_instances(
                        lambda: DA.decode_attention(q, k, v, lens),
                        ("decode_", "attention_any"))
                    require_instance(instances, decode_instance(dt_name, D),
                                     f"decode_attention {model} {dt_name}")
                    rows.append({"check": "instance",
                                 "kernel": "decode_attention",
                                 "model": model, "dtype": dt_name,
                                 "route": DA.route(q, k, v),
                                 "instances": instances, "ok": True})
                if dt_name == "bfloat16" and model in timed:
                    n = mixed[0]
                    q1, k1, v1, l1 = q[:1], k[:1], v[:1], lens[:1]
                    bound, by, nbytes = decode_bound(1, H, Hkv, D, [n], 2)
                    qs = q1[:, :, None, :]
                    ks, vs = (t[:, :n].transpose(1, 2) for t in (k1, v1))
                    timing[model] = {
                        "S": S, "length": n, "H": H, "Hkv": Hkv, "D": D,
                        "instances": instances,
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
                        q1, k1, v1, l1), what=f"decode {model}")
                    if per_call not in (None, 1):
                        raise AssertionError(f"decode_attention: {per_call} "
                                             f"device kernels per call")
                    served = D not in ANY_HEAD_DIMS
                    timing[model].update(
                        device_ms=dev_ms, kernels_per_call=per_call,
                        plain_device_ms=traced_ms(
                            lambda: R.decode_attention_ref(q1, k1, v1, l1))
                        if served else None,
                        library_device_ms=traced_ms(
                            lambda: F.scaled_dot_product_attention(
                                qs, ks, vs, enable_gqa=True)))
                del q, k, v, got
    # unaligned views (bf16, llama3.2-3b's 24 / 8 heads, three rows of 543,
    # 1 and 77 of 576 keys): k and v one element into wider rows (strides
    # and pointers off 16 bytes) take the narrow copies of the TMA
    # instance's width at D 64 and 128, and give the aligned call's bits
    for D in (64, 128):
        q = torch.randn((3, 24, D), generator=gen, device=dev).bfloat16()
        k, v = [torch.randn((3, 576, 8, D + 1), generator=gen,
                            device=dev).bfloat16()[..., 1:] for _ in range(2)]
        lens = torch.tensor((543, 1, 77), dtype=torch.int32, device=dev)
        got = DA.decode_attention(q, k, v, lens)
        same = torch.equal(got, DA.decode_attention(q, k.contiguous(),
                                                    v.contiguous(), lens))
        names = kernel_instances(lambda: DA.decode_attention(q, k, v, lens),
                                 "decode_")
        require_instance(names, rf"^decode_mma<{D}, \d+, true>$",
                         f"flash-decode on unaligned views at D {D}")
        rows.append({"kernel": "decode_attention", "check": "unaligned_views",
                     "route": DA.route(q, k, v), "instances": names,
                     "dtype": "bfloat16", "S": 576, "D": D,
                     "equal_to_aligned": same, "ok": same})
        if not same:
            raise AssertionError(f"flash-decode on unaligned views at D {D} "
                                 f"differs from the aligned call")
        del q, k, v, got
    lens = torch.ones(1, dtype=torch.int32, device=dev)
    q = torch.zeros((1, 4, 0), dtype=torch.bfloat16, device=dev)
    kv = torch.zeros((1, 64, 2, 0), dtype=torch.bfloat16, device=dev)
    try:
        DA.decode_attention(q, kv, kv, lens)
    except ValueError as e:
        rows.append({"kernel": "decode_attention", "D": 0,
                     "refused": str(e), "ok": True})
    else:
        raise AssertionError("decode_attention took head dim 0")
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
    algorithm's operations, 2 (q^2 n + q^2 p + 2 q n p) per head and tile
    of q rows (the kernel's tiles: the chunk Q up to 128 rows, else 128
    with a ragged last one; the result does not depend on the chunk), at
    the bf16 tensor rate, against x, y, B and C (``el`` bytes each), dt, A
    and the f32 final state moved once at the memory rate."""
    tile = min(Q, 128)
    tiles = [tile] * (S // tile) + ([S % tile] if S % tile else [])
    flops = h * sum(2 * (q * q * n + q * q * p + 2 * q * n * p)
                    for q in tiles)
    nbytes = (2 * S * h * p + 2 * S * n) * el + (S * h + h + h * p * n) * 4
    t_ops, t_bytes = flops / BF16_FLOPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops, nbytes


def ssd_phase(dev):
    """The SSD-scan kernel against its plain version at ``SSD_SHAPES`` (the
    mamba2 and zamba2 widths, chunk 256, 160 and 131, n 160 and 256), bf16
    and f32, y and final state; a padded length also against the plain
    version of the unpadded sequence (its state must not move over the
    pad); from a given state (``SSD_INIT``).  Timed (bf16) at
    ``SSD_TIMED``: event time, device time and kernels per call from the
    profiler."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as SSD
    gen = torch.Generator(dev).manual_seed(3)
    rows, timing = [], {}

    def held(model, dt_name, S, Q, padded, what, got, want, tol):
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        ok = torch.isfinite(got).all().item() and \
            err <= tol * max(scale, 1e-6)
        rows.append({"kernel": "ssd_scan", "model": model,
                     "dtype": dt_name, "S": S, "chunk": Q,
                     "padded_to": padded, "output": what,
                     "max_abs_err": err,
                     "max_rel_err": err / max(scale, 1e-30),
                     "tol_rel": tol, "ok": bool(ok)})
        if not ok:
            raise AssertionError(f"ssd_scan {model} {dt_name} S={S} "
                                 f"chunk={Q} {what}: max abs err {err} vs "
                                 f"scale {scale}")
        return err

    for model, h, p, n, chunk, lengths in SSD_SHAPES:
        for S in lengths:
            Q = min(chunk, S)
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
                if (model, S) in SSD_INIT:
                    # from a state: the whole against the plain version
                    # from the same state, and two halves against the whole
                    init = torch.randn((1, h, p, n), generator=gen,
                                       device=dev)
                    yi, si = SSD.ssd_scan(x, dt, A, B, C, Q, init)
                    yi_ref, si_ref = R.ssd_ref(x, dt, A, B, C, Q, init)
                    half = (S + pad) // 2
                    Qh = Q if half % Q == 0 else half
                    parts = [[t[:, a:b].contiguous() for t in (x, dt, B, C)]
                             for a, b in ((0, half), (half, S + pad))]
                    y1, s1 = SSD.ssd_scan(parts[0][0], parts[0][1], A,
                                          parts[0][2], parts[0][3], Qh)
                    y2, s2 = SSD.ssd_scan(parts[1][0], parts[1][1], A,
                                          parts[1][2], parts[1][3], Qh, s1)
                    checks += [("y_from_state", yi, yi_ref,
                                SSD_TOL[dt_name]),
                               ("state_from_state", si, si_ref,
                                SSD_STATE_TOL),
                               ("y_two_halves", torch.cat([y1, y2], 1), y,
                                SSD_TOL[dt_name]),
                               ("state_two_halves", s2, st, SSD_STATE_TOL)]
                for what, got, want, tol in checks:
                    err = held(model, dt_name, S, Q, S + pad, what, got,
                               want, tol)
                    if what == "y":
                        y_err = err
                if dt_name == "bfloat16" and (model, S) in SSD_TIMED:
                    bound, by, flops, nbytes = ssd_bound(S + pad, Q, h, p, n,
                                                         2)
                    dev_ms, per_call = traced(
                        lambda: SSD.ssd_scan(x, dt, A, B, C, Q),
                        what=f"ssd_scan {model} S{S}")
                    if per_call not in (None, SSD_KERNELS_PER_CALL):
                        raise AssertionError(f"ssd_scan: {per_call} device "
                                             f"kernels per call")
                    timing[f"{model}_S{S}"] = {
                        "h": h, "p": p, "n": n, "chunk": Q, "S": S + pad,
                        "ms": cuda_ms(lambda: SSD.ssd_scan(x, dt, A, B, C,
                                                           Q)),
                        "device_ms": dev_ms, "kernels_per_call": per_call,
                        "plain_ms": cuda_ms(
                            lambda: R.ssd_ref(x, dt, A, B, C, Q), iters=3),
                        "library_ms": None, "bound_ms": bound,
                        "bound_by": by, "flops": flops, "bytes": nbytes,
                        "max_abs_err": y_err}
                del x, dt, A, B, C, raw, y, st, y_ref, st_ref, checks
    # what still raises: a chunk that does not divide s, chunk 0
    x, dt, A, B, C = ssd_inputs(gen, dev, 262, 2, 64, 64, torch.bfloat16)
    for bad in (128, 0):
        try:
            SSD.ssd_scan(x, dt, A, B, C, bad)
        except ValueError as e:
            rows.append({"kernel": "ssd_scan", "S": 262, "chunk": bad,
                         "refused": str(e), "ok": True})
        else:
            raise AssertionError(f"ssd_scan took chunk {bad} at S 262")
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
# the attention wrappers' launches by head shape over every main path of
# this run, its children's included: "<wrapper> H/Hkv/D" -> launches; the
# expert-FFN stages' by width, "cache_moe_<stage> d<d>/f<f>", and the SSD
# scan's by chunk and state width, "ssd_scan chunk<Q>/n<n>"
SHAPE_LAUNCHES = collections.Counter()


def fold_shape_launches():
    """Just after a main path: add the attention wrappers' launches by
    head shape (``flash_attention.shapes``, ``decode_attention.shapes``),
    the expert-FFN stages' by width (``gate_up.shapes`` ...) and the SSD
    scan's by chunk and state width (``ssd_scan.shapes``), all set to 0 by
    ``reset_launches``, to ``SHAPE_LAUNCHES``."""
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ssd_scan as SSD
    for w in (FA.flash_attention, DA.decode_attention):
        for (H, Hkv, D), n in w.shapes.items():
            SHAPE_LAUNCHES[f"{w.__name__} {H}/{Hkv}/{D}"] += n
    for w in (K.gate_up, K.up_gelu, K.down):
        for (d, f), n in w.shapes.items():
            SHAPE_LAUNCHES[f"cache_moe_{w.__name__} d{d}/f{f}"] += n
    for (chunk, n), c in SSD.ssd_scan.shapes.items():
        SHAPE_LAUNCHES[f"ssd_scan chunk{chunk}/n{n}"] += c


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
    FA.flash_attention.shapes.clear()
    DA.decode_attention.shapes.clear()
    for w in (K.gate_up, K.up_gelu, K.down, SSD.ssd_scan):
        w.shapes.clear()
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
    the markers seen under ``"draft_marks"`` and, per pair of markers, the
    kernels inside, how many of the port's, and the device ns from one
    marker to the next under ``"_windows"`` (``check_draft_launches``
    takes it).  Each of ``kernels`` must have launched through its wrapper
    and run on the device, and every launch a wrapper counted must have
    run."""
    import torch
    from torch.autograd import DeviceType
    torch.cuda.synchronize()
    prof = _PATH.pop("prof")
    host = host_launches()
    fold_shape_launches()
    ran = dict(host)
    draft = dict.fromkeys(KERNEL_NAMES, 0)
    marks, seen, names = 0, 0, set()
    windows = []              # per pair of markers: the kernels inside
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
        opened = None             # the open window's first marker's start
        for start, name in ours:
            if MARK.search(name):
                marks += 1
                if opened is None:
                    opened = start
                    windows.append({**dict.fromkeys(KERNEL_NAMES, 0),
                                    "port": 0})
                else:
                    windows[-1]["gap_ns"] = start - opened
                    opened = None
                continue
            if opened is not None:
                windows[-1]["port"] += 1
            for k, (pattern, _) in KERNEL_NAMES.items():
                if pattern.search(name):
                    ran[k] += 1
                    if opened is not None:
                        draft[k] += 1
                        windows[-1][k] += 1
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
    out = {**ran, "host": host, "draft": draft, "draft_marks": marks}
    if windows:
        out["_windows"] = windows
    return out


def mark_draft_steps(rt, calls: list):
    """Put a marker kernel (``torch.cuda._sleep``, ``MARK``) on the stream
    before and after each of the runtime's draft steps, so that a path's
    trace tells the draft's kernels apart (``read_launches``), and append
    to ``calls``, per step, the expert-FFN calls the host made the device
    run in it: the wrappers' own launches (a build's eager warm-up) plus,
    for each captured step replayed, the calls its capture recorded (the
    wrappers' ``captured``, counted per key as ``rt.graphs`` builds it).
    A replayed step built before the marking counts 0.  ``del
    rt._draft_step`` takes the markers away."""
    import torch
    from repro_torch.kernels import cache_moe as K
    step, graphs = rt._draft_step, rt.graphs
    wrappers = {"gate_up": K.gate_up, "down": K.down}
    in_graph = {}                 # step key -> the calls its capture holds
    build = graphs.build

    def recorded(key, body, inputs):
        before = {k: w.captured for k, w in wrappers.items()}
        g = build(key, body, inputs)
        in_graph[key] = {k: w.captured - before[k]
                         for k, w in wrappers.items()}
        return g

    def marked(*a):
        launched = {k: w.launches for k, w in wrappers.items()}
        runs = dict(graphs.key_runs)
        torch.cuda._sleep(1)
        out = step(*a)
        torch.cuda._sleep(1)
        calls.append({k: w.launches - launched[k] + sum(
            (n - runs.get(key, 0)) * in_graph.get(key, {}).get(k, 0)
            for key, n in graphs.key_runs.items())
            for k, w in wrappers.items()})
        return out
    graphs.build = recorded
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


def staging_check(store, dev, slots: int = 12, per_batch: int = 2):
    """The staging race, on the card: back-to-back ``fetch`` + ``insert``
    on this thread into a fresh cache of ``slots`` slots, in batches of
    ``per_batch`` experts (more batches than the store's staging buffers,
    so batch i + 2 refills batch i's pinned buffer while its copies may
    still be queued on the copy stream), with no sync between them; then
    every slot must equal its store row."""
    import torch
    from repro_torch.core import offload
    from repro_torch.core.cache import ExpertCache
    keys = [(l, e) for l in range(store.num_layers)
            for e in range(store.num_experts)][:slots]
    batches = [keys[i:i + per_batch] for i in range(0, len(keys), per_batch)]
    if len(batches) <= offload._NUM_STAGING:
        raise AssertionError("the staging check needs more batches than "
                             "staging buffers")
    cache = ExpertCache(slots, store.buffer_shapes(), torch.bfloat16,
                        table_shape=(store.num_layers, store.num_experts),
                        device=dev)
    t0 = time.perf_counter()
    for b in batches:
        cache.insert(b, store.fetch(b))
    issue_s = time.perf_counter() - t0
    cache.wait()
    total_s = time.perf_counter() - t0
    if not cache.check_invariants():
        raise AssertionError("staging check: cache invariants violated")
    for (l, e), slot in cache.table.items():
        for n in store.names:
            if not torch.equal(cache.bufs[n][slot].cpu(),
                               store.expert(n, l, e)):
                raise AssertionError(f"staging check: slot {slot} holds "
                                     f"another {n} than expert ({l}, {e})")
    nbytes = sum(cache.bufs[n][0].numel() * cache.bufs[n].element_size()
                 for n in store.names) * len(keys)
    del cache
    torch.cuda.empty_cache()
    return {"batches": len(batches), "experts": len(keys),
            "staging_buffers": offload._NUM_STAGING, "bytes": nbytes,
            "issue_s": issue_s, "landed_s": total_s, "rows_equal": True}


def checksum_timing(store, reps: int = 3):
    """Host ms to checksum one staged expert as ``fetch_verified`` does (a
    CRC32 of each 16 MiB piece, the pieces on a thread pool) against one
    CRC32 pass over the same bytes on this thread; best of ``reps``."""
    import zlib

    from repro_torch.core import offload
    arrays = store.fetch([(0, 0)])
    row = [arrays[n][0] for n in store.names]

    def serial():
        c = 0
        for t in row:
            c = zlib.crc32(offload._bytes(t), c)
        return c

    out = {}
    for name, fn in (("pieces_on_a_pool", lambda: offload._checksum(row)),
                     ("one_pass_one_thread", serial)):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        out[name] = best * 1e3
    out["bytes"] = sum(t.numel() * t.element_size() for t in row)
    return out


def chaos_phase(target, draft, cfg, dcfg, prompts, dev):
    """Phase 5b: the tight engine (12 slots, sd x spmoe) under seeded
    faults (``CHAOS``): first the staging check on its store (faults
    suppressed), then two requests served one after another with the
    launch counts from 0 (retries and checksum quarantine must have
    absorbed faults, none ending a request), then one concurrent round of
    a warm request (prompt 0 again) and a cold one whose own
    ``store.fetch`` raises: its prefill must miss, it ends ``io_error``,
    and the warm one ends ``length`` with its full stream (held to the
    teacher-forced model in phase 6: in bf16 it may part from its solo
    stream at a near tie, as the slow path sums hit and loaded experts in
    an order that depends on the cache).  Returns the
    (prompt, result) pairs for the lossless check and the phase's
    measures."""
    import threading

    import torch
    from repro_torch.core.chaos import ChaosConfig
    from repro_torch.core.engine import Engine, EngineConfig, Request
    t_phase = time.perf_counter()
    config = EngineConfig(model=cfg, draft=dcfg, decode="sd",
                          offload="spmoe", cache_slots=CHAOS_SLOTS,
                          draft_len=4, max_seq=256,
                          chaos=ChaosConfig(**CHAOS))
    eng = Engine(config, target, draft)
    rt = eng.runtime
    with rt.chaos.calm():
        staging = staging_check(rt.store, dev)
        checksum_ms = checksum_timing(rt.store)
    log(f"[5b] staging check: {staging}; one expert's checksum "
        f"{checksum_ms}")
    reset_launches()
    results = []
    for i, p in enumerate(prompts):
        res = eng.submit(Request(prompt=p, max_new_tokens=CHAOS_NEW,
                                 request_id=f"chaos-{i}"))
        torch.cuda.synchronize()
        if len(res.tokens) != CHAOS_NEW or res.finish_reason != "length":
            raise AssertionError(f"chaos: request {i} ended "
                                 f"{res.finish_reason} after "
                                 f"{len(res.tokens)} tokens")
        results.append(res)
    launches = read_launches("chaos serving")
    tot = {k: sum(r.metrics[k] for r in results)
           for k in ("prefetch_retries", "prefetch_errors",
                     "checksum_failures", "worker_restarts",
                     "degraded_rounds", "io_errors", "on_demand_loads",
                     "prefetched")}
    if tot["prefetch_retries"] <= 0 or tot["checksum_failures"] <= 0 \
            or tot["io_errors"]:
        raise AssertionError(f"chaos: the requests' metrics {tot}")
    injected = dict(rt.chaos.injected)
    counters = rt.counters()
    # the io_error round: only the cold session's own loads fail
    cold_prompt = torch.randint(0, cfg.vocab_size, prompts[0].shape,
                                generator=torch.Generator().manual_seed(30))
    decode_thread = threading.get_ident()
    orig_fetch, orig_start = rt.store.fetch, rt.start_session
    cold = {"on": False}
    failed = []

    def start(prompt, n):
        cold["on"] = torch.equal(prompt.cpu(), cold_prompt)
        try:
            return orig_start(prompt, n)
        finally:
            cold["on"] = False

    def down(keys):
        if cold["on"] and threading.get_ident() == decode_thread:
            failed.append(not any(rt.cache.contains(k) for k in keys))
            raise OSError("host store unreachable")
        return orig_fetch(keys)

    rt.start_session, rt.store.fetch = start, down
    try:
        pair = eng.serve_all([Request(prompt=prompts[0],
                                      max_new_tokens=CHAOS_IO_NEW,
                                      request_id="chaos-warm"),
                              Request(prompt=cold_prompt,
                                      max_new_tokens=CHAOS_IO_NEW,
                                      request_id="chaos-cold")],
                             concurrency=2)
    finally:
        rt.store.fetch = orig_fetch
        del rt.start_session
    torch.cuda.synchronize()
    warm, cold_res = pair
    if not failed or not all(failed):
        raise AssertionError(f"chaos: the cold session's failing fetches "
                             f"{failed} were not all misses")
    if cold_res.finish_reason != "io_error":
        raise AssertionError(f"chaos: the cold session ended "
                             f"{cold_res.finish_reason}")
    if warm.finish_reason != "length" or len(warm.tokens) != CHAOS_IO_NEW:
        raise AssertionError(f"chaos: the warm batchmate ended "
                             f"{warm.finish_reason} after "
                             f"{len(warm.tokens)} tokens")
    if not rt.cache.check_invariants():
        raise AssertionError("chaos: cache invariants violated")
    eng.close()
    del eng, rt
    gc.collect()
    torch.cuda.empty_cache()
    info = {"slots": CHAOS_SLOTS, "chaos": CHAOS, "requests_metrics": tot,
            "tpot_wall_s": [r.metrics.tpot_wall for r in results],
            "injected": injected, "runtime_counters": counters,
            "launches": launches, "staging": staging,
            "io_error_round": {"cold_failed_fetches": len(failed),
                               "cold_finish": cold_res.finish_reason,
                               "cold_tokens": len(cold_res.tokens),
                               "warm_finish": warm.finish_reason,
                               "warm_tokens": len(warm.tokens),
                               "warm_is_a_prefix_of_its_solo_stream":
                                   warm.tokens == results[0].tokens[
                                       :CHAOS_IO_NEW]},
            "checksum_ms": checksum_ms,
            "phase_s": time.perf_counter() - t_phase}
    return [(p, r) for p, r in zip(prompts, results)] + \
        [(prompts[0], warm)], info


def preload_every_expert(rt):
    """Insert every expert into the runtime's cache, layer by layer (a warm
    ample cache)."""
    for l in range(rt.store.num_layers):
        keys = [(l, e) for e in range(rt.store.num_experts)]
        rt.cache.insert(keys, rt.store.fetch(keys))
    rt.cache.wait()


def teacher_force(target, seq):
    """Logits of one causal full-sequence pass over seq [1, S], every MoE
    layer drop-free as the engine routes it (``DecoderLM.score``).  Under
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
    return target.score(seq)[:, :S]


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
    back empty is taken again, after a pause that doubles each time, before
    failing."""
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
        time.sleep(0.5 * 2 ** attempt)
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
              kernels=("ssd_scan",), profile: bool = True, check=None):
    """Greedy x none serving of an ssm / hybrid model through
    ``Engine.submit``, with the launch counts set to 0 just before and read
    just after (each of ``kernels`` must have run; the SSD scan once per
    mamba layer per prefill); then the model's prefill and one decode step
    timed alone (and traced, with ``profile``), and every emitted token
    teacher-forced (``teacher_force``: ``score``, whose mamba layers run
    the SSD kernel as the prefill does, over the sequence padded for flash
    attention).  ``check(target, results) -> dict``, where given, runs last
    on the served model; its result is the info's ``check``."""
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
    prefill_prof = step_prof = None
    if profile:
        prefill_prof = device_profile(lambda: target.prefill(p0, max_seq),
                                      prefill_ms)
        # the profiler's focus must see every kernel of every SSD call
        want_traced = mamba_layers(cfg) * SSD_KERNELS_PER_CALL
        if prefill_prof["ssd_kernels"] != want_traced:
            raise AssertionError(f"{name}: the traced prefill holds "
                                 f"{prefill_prof['ssd_kernels']} SSD "
                                 f"kernels, expected {want_traced}")
        step_prof = device_profile(
            lambda: target.decode_step(cache, tok, p0.shape[1]), step_ms)
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts, results)], dev,
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
            "attn_impl": cfg.attn_impl, "ssm_chunk": cfg.ssm_chunk,
            "kernel_launches": {k: launches[k] for k in kernels},
            "lossless": loss}
    if check is not None:
        info["check"] = check(target, results)
    info["_tokens"] = [r.tokens for r in results]     # popped by main
    requests = [{"id": r.request_id, "prompt": p.shape[1],
                 "tokens": len(r.tokens), "tpot_wall_s": r.metrics.tpot_wall,
                 "finish_reason": r.finish_reason}
                for p, r in zip(prompts, results)]
    del eng, target, cache
    gc.collect()
    torch.cuda.empty_cache()
    return requests, info


def chunk_check(prompts, reference, dev):
    """The chunk-256 run's check (phase 8b), for ``ssm_phase(check=)``:
    each request's teacher-forced logits through the SSD kernel (``score``)
    against the plain scan's (``forward``, the train route: ``ssd_ref`` at
    the config's chunk) over the same stream, within SSM_C256_TOL; and its
    tokens against ``reference`` (the chunk-128 run's, one list a request)
    up to the first that differs, which must be a near tie."""
    import torch

    def check(target, results):
        worst, same, clear = 0.0, 0, 0
        for prompt, res, ref in zip(prompts, results, reference):
            seq = torch.cat([prompt[0].to(dev),
                             torch.tensor(res.tokens[:-1], device=dev)])[None]
            S = seq.shape[1]
            kern = teacher_force(target, seq)[0, prompt.shape[1] - 1:]
            with torch.no_grad():
                plain = target.forward(seq)[0][0, prompt.shape[1] - 1:S]
            diff = (kern.float() - plain.float()).abs().max().item()
            worst = max(worst, diff)
            if not diff <= SSM_C256_TOL:
                raise AssertionError(f"chunk {SSM_CHUNK}: teacher-forced "
                                     f"logits {diff} from the plain scan's")
            top2 = kern.float().topk(2, dim=-1).values
            margin = (top2[:, 0] - top2[:, 1]).tolist()
            for t, (a, b) in enumerate(zip(res.tokens, ref)):
                if a != b:
                    if margin[t] > SSM_MARGIN:
                        raise AssertionError(
                            f"chunk {SSM_CHUNK}: token {t} is {a}, the "
                            f"chunk-128 run's {b}, at a top-2 margin of "
                            f"{margin[t]}")
                    break
                same += 1
                clear += margin[t] > SSM_MARGIN
        # the prefill of the first prompt at this chunk and at 128 on the
        # same model, in turns (the phases' own prefill times are taken
        # minutes apart, where the host's issue time moves them)
        p0 = prompts[0].to(dev)
        base = target.cfg
        turns = {SSM_CHUNK: [], 128: []}
        for chunk in (SSM_CHUNK, 128, 128, SSM_CHUNK) * 2:
            target.cfg = dataclasses.replace(base, ssm_chunk=chunk)
            turns[chunk].append(cuda_ms(
                lambda: target.prefill(p0, p0.shape[1] + 8), iters=3))
        target.cfg = base
        return {"max_abs_logit_diff_vs_plain_scan": worst,
                "tol_abs": SSM_C256_TOL,
                "tokens_equal_to_chunk128_run": same,
                "of_which_top2_margin_clear": clear,
                "tokens": sum(len(r.tokens) for r in results),
                "prefill_ms_in_turns": {f"chunk{c}": t
                                        for c, t in turns.items()}}
    return check


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


def traced_request(eng, kind: str, prompt, new: int, path: str, kernels,
                   check, tries: int = 3):
    """Serve one request of ``new`` tokens on ``eng`` under a trace and
    count its kernels (``read_launches``); ``check(res, launches, builds)``
    raises where the counts are wrong, ``builds`` being the graphs of key
    ``kind`` captured meanwhile.  The profiler's trace of a long path can
    lose records (PERF.md §7: one of six granite-20b sd traces held 34 642
    of its 418 369 device activities), so a request whose count fails is
    served and traced again, at most ``tries`` times in all, and must give
    the same tokens; its last failure raises.  Returns the result, the
    counts and the traced wall seconds."""
    import torch
    from repro_torch.core.engine import Request
    first = None
    for attempt in range(1, tries + 1):
        builds = eng.graphs.builds[kind]
        reset_launches()
        t0 = time.perf_counter()
        res = eng.submit(Request(prompt=prompt, max_new_tokens=new,
                                 request_id=path.replace(" ", "-")))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if first is not None and res.tokens != first:
            raise AssertionError(f"{path}: traced again, {res.tokens} and "
                                 f"not {first}")
        first = res.tokens
        try:
            launches = read_launches(path, kernels)
            check(res, launches, eng.graphs.builds[kind] - builds)
            return res, launches, wall
        except AssertionError as e:
            if attempt == tries:
                raise
            log(f"{path}: {e} (trace {attempt} of {tries}); serving and "
                f"tracing the request again")


@contextlib.contextmanager
def attention_shapes():
    """Record the (kernel, q heads, kv heads, head dim) of every call of
    the attention wrappers through ``ops`` (the models' route to them):
    a served request's eager calls and its captured steps' warm-ups, whose
    kernels the replays run again."""
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    seen = set()

    def flash(q, k, v, **kw):
        seen.add(("flash_attention", q.shape[2], k.shape[2], q.shape[3]))
        return FA.flash_attention(q, k, v, **kw)

    def decode(q, k, v, lengths):
        seen.add(("decode_attention", q.shape[1], k.shape[2], q.shape[2]))
        return DA.decode_attention(q, k, v, lengths)
    ops.flash_attention, ops.decode_attention = flash, decode
    try:
        yield seen
    finally:
        ops.flash_attention = FA.flash_attention
        ops.decode_attention = DA.decode_attention


def dense_phase(dev, arch: str = "llama3.2-3b", layers=None,
                seed: int = 60):
    """A dense target at full width (``layers`` cuts its depth; llama3.2-3b
    at full depth: 28 layers, d 3072, 24 / 8 heads x 128, d_ff 8192, vocab
    128256, tied embeddings), bf16, ``attn_impl="kernel"``, random weights
    from seeds 0 / 1 on the card: one 512-token request greedy x none
    (every target step through flash-decode) and one sd x none with the
    derived half-depth draft (every draft step through it), through
    ``Engine.submit``, the launch counts set to 0 just before and read just
    after, every attention call at the model's head shape, and both served
    again untraced (the TPOT as served; the same tokens); then one warm
    greedy decode step timed alone and traced, the greedy step and the sd
    iteration replayed against their eager bodies, and every token
    teacher-forced.  Returns the phase's seconds and its own peak of
    device memory with the rest."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                         derive_draft_config)
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config(arch), attn_impl="kernel")
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    dcfg = derive_draft_config(cfg)
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    at_start = torch.cuda.memory_allocated()
    t_phase = t0 = time.perf_counter()
    target = build_model(cfg, dev, seed=0)
    draft = build_model(dcfg, dev, seed=1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    gen = torch.Generator().manual_seed(seed)
    prompts = [torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT),
                             generator=gen) for _ in range(2)]
    greedy = Engine(EngineConfig(model=cfg, decode="greedy",
                                 max_seq=DENSE_MAX_SEQ), target)
    sd = Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             draft_len=4, max_seq=DENSE_MAX_SEQ),
                target, draft)
    # one kernel per layer per one-token step, as the traces count them:
    # the target's steps (greedy) and the draft's (sd; a step after a draft
    # block accepted whole skips a position and takes the masked route).
    # Every step is a replay of a captured step, which runs the kernels
    # without their wrappers; each build's eager warm-up runs them once
    # more, through the wrappers.  Flash: one prefill of the target (and
    # in sd of the draft) a request
    def greedy_counts(res, n, builds):
        dec = n["decode_attention"]
        if dec != cfg.num_layers * (DENSE_NEW - 1 + builds):
            raise AssertionError(f"{arch} greedy: {dec} flash-decode "
                                 f"launches, expected {cfg.num_layers} × "
                                 f"{DENSE_NEW - 1 + builds}")
        if dec - n["host"]["decode_attention"] != \
                cfg.num_layers * (DENSE_NEW - 1):
            raise AssertionError(f"{arch} greedy: the replays ran "
                                 f"{dec - n['host']['decode_attention']} "
                                 f"flash-decode kernels, not one per layer "
                                 f"per step")
        if n["flash_attention"] != cfg.num_layers:
            raise AssertionError(f"{arch} greedy: {n['flash_attention']} "
                                 f"flash launches, not {cfg.num_layers}")

    def sd_counts(res, n, builds):
        dec, drafted = n["decode_attention"], res.metrics.drafted
        steps = drafted + 4 * builds
        if not 0 < dec <= dcfg.num_layers * steps or dec % dcfg.num_layers:
            raise AssertionError(f"{arch} sd: {dec} flash-decode launches "
                                 f"for {drafted} draft steps of "
                                 f"{dcfg.num_layers} layers")
        if n["flash_attention"] != cfg.num_layers + dcfg.num_layers:
            raise AssertionError(f"{arch} sd: {n['flash_attention']} flash "
                                 f"launches, not {cfg.num_layers} + "
                                 f"{dcfg.num_layers} (the two prefills)")

    with attention_shapes() as shapes:
        res_g, g_launches, g_wall = traced_request(
            greedy, "greedy", prompts[0], DENSE_NEW, f"{arch} greedy",
            ("flash_attention", "decode_attention"), greedy_counts)
        res_s, s_launches, s_wall = traced_request(
            sd, "sd", prompts[1], DENSE_NEW, f"{arch} sd",
            ("flash_attention", "decode_attention"), sd_counts)
    # the same two requests again, untraced: TPOT as served (traced, a
    # replay runs 1.8-4.9x slower), and the same tokens
    again = [eng.submit(Request(prompt=p, max_new_tokens=DENSE_NEW))
             for eng, p in ((greedy, prompts[0]), (sd, prompts[1]))]
    torch.cuda.synchronize()
    for res, rerun in zip((res_g, res_s), again):
        if rerun.tokens != res.tokens:
            raise AssertionError(f"{res.request_id}: served again, "
                                 f"{rerun.tokens} and not {res.tokens}")
    want_shapes = {(k, *heads) for k in ("flash_attention",
                                         "decode_attention")}
    if shapes != want_shapes:
        raise AssertionError(f"{arch}: attention ran at {sorted(shapes)}, "
                             f"not {sorted(want_shapes)}")
    launches = {k: g_launches[k] + s_launches[k] for k in KERNEL_NAMES}
    launches["host"] = {k: g_launches["host"][k] + s_launches["host"][k]
                        for k in KERNEL_NAMES}
    for res in (res_g, res_s):
        if len(res.tokens) != DENSE_NEW or res.finish_reason != "length":
            raise AssertionError(f"{res.request_id}: ended "
                                 f"{res.finish_reason} after "
                                 f"{len(res.tokens)} tokens")
    g_dec = g_launches["decode_attention"]
    s_dec = s_launches["decode_attention"]
    g_replayed = g_dec - g_launches["host"]["decode_attention"]
    drafted = res_s.metrics.drafted
    p0 = prompts[0].to(dev)
    _, cache = target.prefill(p0, DENSE_MAX_SEQ)
    tok = p0[:, -1:]
    step_ms = cuda_ms(lambda: target.decode_step(cache, tok, DENSE_PROMPT))
    step_prof = device_profile(
        lambda: target.decode_step(cache, tok, DENSE_PROMPT), step_ms,
        FOCUS_DECODE)
    del cache
    graphs = dense_replay_ab(target, draft, greedy, sd, prompts)
    greedy.close()
    sd.close()
    loss = lossless_phase(target, [(p, r.tokens) for p, r in
                                   zip(prompts, (res_g, res_s))], dev,
                          margin=DENSE_MARGIN)
    if loss["exact"] < DENSE_MIN_EXACT * 2 * DENSE_NEW:
        raise AssertionError(f"{arch}: only {loss['exact']} of "
                             f"{2 * DENSE_NEW} tokens are the teacher-forced "
                             f"argmax")
    torch.cuda.synchronize()
    info = {"model": cfg.name, "layers": cfg.num_layers,
            "draft_layers": dcfg.num_layers,
            "heads": {"H": heads[0], "Hkv": heads[1], "D": heads[2]},
            "attention_calls": sorted(shapes),
            "params": sum(t.numel() for t in target.parameters()),
            "draft_params": sum(t.numel() for t in draft.parameters()),
            "model_init_s": init_s,
            "greedy": {"wall_s": g_wall, "tpot_wall_s":
                       res_g.metrics.tpot_wall,
                       "tpot_wall_s_untraced": again[0].metrics.tpot_wall,
                       "decode_attention_launches": g_dec,
                       "decode_attention_replayed": g_replayed,
                       "host_launches": g_launches["host"]},
            "sd": {"wall_s": s_wall, "tpot_wall_s": res_s.metrics.tpot_wall,
                   "tpot_wall_s_untraced": again[1].metrics.tpot_wall,
                   "iterations": res_s.metrics.iterations,
                   "drafted": drafted, "accepted": res_s.metrics.accepted,
                   "decode_attention_launches": s_dec,
                   "host_launches": s_launches["host"]},
            "launches": launches, "decode_step_ms": step_ms,
            "decode_step_profile": step_prof, "graphs": graphs,
            "lossless": loss,
            "device_allocated_at_start_bytes": at_start,
            "device_max_allocated_bytes": torch.cuda.max_memory_allocated(),
            "phase_s": time.perf_counter() - t_phase}
    del greedy, sd, target, draft
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


def check_draft_launches(name, results, launches, dcfg, steps: list):
    """Every drafted token ran the draft's MoE layers through the kernel:
    at least the drafted tokens times the draft's MoE layers expert-FFN
    calls, by two counts that must both reach that bound.  The host's
    (``mark_draft_steps``: the wrappers' launches and each replayed
    capture's recorded calls), and the device's: the calls the trace holds
    between the steps' markers, plus the host's calls of each step whose
    window the trace lost whole (no kernel of the port between its
    markers, which lie at least a quarter of the full windows' median gap
    apart: a replay's time).  That loss, and only it, is forgiven: the
    profiler's trace of a long path is not exact (36 reruns of this path
    lost one such window twice)."""
    drafted = sum(r.metrics.drafted for r in results)
    bound = drafted * dcfg.num_moe_layers
    keys = ("gate_up", "down")
    host = {k: sum(st[k] for st in steps) for k in keys}
    trace = {k: launches["draft"][f"cache_moe_{k}"] for k in keys}
    windows = launches.pop("_windows", [])
    aligned = len(windows) == len(steps) and \
        all("gap_ns" in w for w in windows)
    full = sorted(w["gap_ns"] for w, st in zip(windows, steps) if all(
        w[f"cache_moe_{k}"] >= st[k] for k in keys)) if aligned else []
    lost = [i for i, w in enumerate(windows) if full and not w["port"]
            and w["gap_ns"] >= full[len(full) // 2] / 4]
    device = {k: trace[k] + sum(steps[i][k] for i in lost) for k in keys}
    out = {"drafted": drafted, "bound": bound, "draft_steps": len(steps),
           "draft_calls_host": host["gate_up"],
           "draft_down_calls_host": host["down"],
           "draft_calls_trace": trace["gate_up"],
           "draft_down_calls_trace": trace["down"],
           "draft_marks": launches["draft_marks"], "aligned": aligned,
           "lost_windows": len(lost),
           "lost_window_gaps_ns": [windows[i]["gap_ns"] for i in lost[:4]],
           "full_window_median_gap_ns":
               full[len(full) // 2] if full else None,
           "draft_calls_device": min(device.values())}
    if drafted <= 0 or min(host.values()) < bound:
        raise AssertionError(f"{name}: the host's record holds "
                             f"{min(host.values())} MoE draft layer calls "
                             f"for {drafted} drafted tokens: {out}")
    if min(device.values()) < bound:
        raise AssertionError(f"{name}: the device trace holds "
                             f"{min(device.values())} MoE draft layer "
                             f"calls for {drafted} drafted tokens: {out}")
    return out


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
    info = {**check_draft_launches(name, [res], launches, dcfg, steps),
            "launches": launches,
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


def phi_configs():
    """phi-3.5-moe and its MoE draft phi-mini-moe at full width, cut to
    ``PHI_LAYERS`` layers, under ``attn_impl="kernel"``."""
    from repro_torch.configs.registry import get_config, get_draft_config
    cfg = dataclasses.replace(get_config("phi-3.5-moe"),
                              num_layers=PHI_LAYERS, attn_impl="kernel")
    dcfg = dataclasses.replace(get_draft_config("phi-3.5-moe"),
                               num_layers=PHI_LAYERS, attn_impl="kernel")
    widths = (cfg.d_model, cfg.moe_d_ff, dcfg.moe_d_ff, cfg.num_experts,
              dcfg.num_experts, cfg.num_experts_per_tok, dcfg.family)
    if widths != (PHI_D, PHI_F, PHI_DRAFT_F, PHI_E, PHI_E, PHI_K, "moe"):
        raise AssertionError(f"phi widths: {widths}")
    return cfg, dcfg


def phi_models(cfg, dcfg, dev):
    """The target (seed 0, routed experts on the host), the draft (seed 1,
    on the card) and the four prompts."""
    import torch
    from repro_torch.models.registry import build_model
    target = build_model(cfg, dev, seed=0, expert_device="cpu")
    draft = build_model(dcfg, dev, seed=1)
    torch.cuda.synchronize()
    prompts = [torch.randint(0, cfg.vocab_size, (1, PHI_PROMPT),
                             generator=torch.Generator().manual_seed(100 + i))
               for i in range(4)]
    return target, draft, prompts


def phi_solo_serving(cfg, dcfg, target, draft, prompts):
    """Phase 13's solo path: sd x spmoe, a tight cache (two requests) then
    an ample one (two more), the launch counts set to 0 just before and
    read just after, every draft step marked; -> the ample engine (open)
    and what each part gave, the path's launches and the draft check."""
    import torch
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
    try:
        launches = read_launches("phi solo serving")
        ample_tot = check_ample(ample, ample_info)
        drafts = check_draft_launches("phi solo serving", tight + ample,
                                      launches, dcfg, steps)
    except BaseException:
        eng.close()
        raise
    log(f"[13] phi ample cache ok: {ample_tot}; steady "
        f"{ample_info['steady']}; launches {launches}; {drafts}")
    return (eng, tight, tight_info, tight_tot, ample, ample_info, ample_tot,
            launches, drafts)


def phi_draft_child(dev, reps: int) -> dict:
    """Phase 13's solo path ``reps`` times on one pair of models (``--phase
    phi-draft <reps>``): each run's draft check (``check_draft_launches``)
    with its host and device counts and the whole path's trace and wrapper
    counts.  Then twice with a launch really missing
    (``skip_a_draft_layer``): the draft's last MoE layer's kernels skipped
    with their wrappers' counts (the host's count must fail the check),
    then skipped with the counts made as if they ran (the device's must).
    Fails if any of the ``reps`` runs failed its check."""
    import torch
    from repro_torch.models import moe as MOE
    cfg, dcfg = phi_configs()
    target, draft, prompts = phi_models(cfg, dcfg, dev)
    runs = []
    for i in range(reps):
        t0 = time.perf_counter()
        try:
            out = phi_solo_serving(cfg, dcfg, target, draft, prompts)
        except AssertionError as e:
            runs.append({"run": i, "error": str(e)[:3000]})
            log(f"[13] phi draft run {i} failed: {e}")
            _PATH.clear()
            gc.collect()
            continue
        out[0].close()
        launches, drafts = out[7], out[8]
        runs.append({"run": i, "s": time.perf_counter() - t0, **drafts,
                     "trace_gate_up": launches["cache_moe_gate_up"],
                     "host_gate_up": launches["host"]["cache_moe_gate_up"]})
        log(f"[13] phi draft run {i}: {runs[-1]}")
        del out
        gc.collect()
    failed = [r for r in runs if "error" in r]
    missing = {}
    kernels, skip = MOE.K, draft.layers[-1].moe
    for counted, source in ((False, "host's record"),
                            (True, "device trace")):
        MOE.K = skip_a_draft_layer(kernels, skip, counted)
        try:
            phi_solo_serving(cfg, dcfg, target, draft, prompts)[0].close()
            missing[source] = None
        except AssertionError as e:
            missing[source] = str(e)[:300]
        finally:
            MOE.K = kernels
            _PATH.clear()
        log(f"[13] phi draft with a launch missing "
            f"({'counted' if counted else 'uncounted'}): "
            f"{missing[source] or 'the check passed'}")
    info = {"phi_draft_runs": runs, "launch_missing_checks": missing}
    caught = all(m and f"the {source} holds" in m
                 for source, m in missing.items())
    if failed or not caught:
        log(json.dumps(info))
        raise AssertionError(f"{len(failed)} of {reps} runs failed the "
                             f"draft check; with a launch missing: "
                             f"{missing}")
    torch.cuda.empty_cache()
    return info


def skip_a_draft_layer(kernels, layer, counted: bool):
    """``kernels`` (the expert-FFN module as ``models/moe.py`` calls it)
    with the calls on ``layer``'s experts answered by zeros, no kernel;
    ``counted``: each such call still counted by its wrapper, as a launch
    or (inside a capture) a captured call."""
    import types

    import torch

    def count(w):
        if not counted:
            return
        if torch.cuda.is_current_stream_capturing():
            w.captured += 1
        else:
            w.launches += 1

    def gate_up(x, g, wg, wu):
        if wg is layer.wg:
            count(kernels.gate_up)
            return torch.zeros((g.row_tok.shape[0], wg.shape[2]),
                               dtype=x.dtype, device=x.device)
        return kernels.gate_up(x, g, wg, wu)

    def down(h, g, wd):
        if wd is layer.wd:
            count(kernels.down)
            return torch.zeros((h.shape[0], wd.shape[2]), dtype=h.dtype,
                               device=h.device)
        return kernels.down(h, g, wd)
    return types.SimpleNamespace(**{**vars(kernels), "gate_up": gate_up,
                                    "down": down})


def phi_phase(dev):
    """phi-3.5-moe at full width with its MoE draft phi-mini-moe, both cut
    to ``PHI_LAYERS`` layers, bf16, ``attn_impl="kernel"``, target seed 0
    with its routed experts on the host, draft seed 1 with its experts on the card: the
    expert FFN against its plain version at the target's widths (f 6400,
    16-slot pool, timed at T 5) and the draft's (f 960, its 16 experts,
    timed at T 1 and T 512); sd x spmoe with a tight cache (8 slots, two
    64-token requests, 32 new tokens each) and an ample one (32 slots:
    <= 2 host syncs per fast block; counters reset after the first
    request), the launch counts set to 0 just before and read just after,
    every drafted token through the draft's MoE layers on the kernel; one
    MoE draft step against the derived dense draft's (no more syncs); then
    every token teacher-forced through the resident experts."""
    import torch
    from repro_torch.core.engine import derive_draft_config
    from repro_torch.models.registry import build_model
    cfg, dcfg = phi_configs()
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
    target, draft, prompts = phi_models(cfg, dcfg, dev)
    init_s = time.perf_counter() - t0
    (eng, tight, tight_info, tight_tot, ample, ample_info, ample_tot,
     launches, drafts) = phi_solo_serving(cfg, dcfg, target, draft, prompts)
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


# ---------------------------------------------------------------------------
# phase 17: training (launch/train.py) on the card, in a child process
# ---------------------------------------------------------------------------

def train_matmul_flops(cfg, B: int, S: int, C: int) -> dict:
    """Matmul FLOPs of one train step of the MoE ``cfg`` on B x S tokens,
    from the
    shapes: per block the q/k/v/o projections, the attention scores and
    their values over all S x S pairs (``mha`` computes every pair, then
    masks), the gate and the experts' products over their E x C capacity
    rows (``moe_grouped``); the head outside the blocks.  ``model``: the
    forward and its backward (twice the forward); ``executed``: also the
    blocks' forward again, recomputed by remat."""
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    tok = B * S
    proj = 2 * tok * d * hd * (2 * H + 2 * Hkv)
    attn = 2 * 2 * B * S * S * H * hd
    ffn = 2 * tok * d * cfg.num_experts + \
        2 * 3 * B * cfg.num_experts * C * d * cfg.moe_d_ff
    blocks = cfg.num_layers * (proj + attn + ffn)
    head = 2 * tok * d * cfg.vocab_size
    return {"model": 3 * (blocks + head),
            "executed": 4 * blocks + 3 * head}


def moe_gemm_check(dev) -> dict:
    """``ops.moe_gemm``, the dense-layout entry point (the expert-FFN
    kernel's two stages, expert e as slot e, its C rows one group), against
    its plain version at mixtral's widths, 8 experts x C 64, bf16 and f32;
    bf16 timed against the plain version (``ref.moe_gemm_ref``, three
    ``einsum``s)."""
    import torch
    from repro_torch.kernels import cache_moe as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    E, C, d, f = 8, MOE_GEMM_C, 4096, 14336
    gen = torch.Generator(dev).manual_seed(11)
    out = {"E": E, "C": C, "d": d, "f": f}
    for dt_name, dt in (("bfloat16", torch.bfloat16),
                        ("float32", torch.float32)):
        def w(shape, fan):
            return (torch.randn(shape, generator=gen, device=dev)
                    * fan ** -0.5).to(dt)
        xg = w((E, C, d), 1)
        wg, wu, wd = w((E, d, f), d), w((E, d, f), d), w((E, f, d), f)
        valid = torch.rand((E, C), generator=gen, device=dev) < 0.75
        n0 = (ops.moe_gemm.launches, K.gate_up.launches, K.down.launches)
        got = ops.moe_gemm(xg, wg, wu, wd, valid)
        n1 = (ops.moe_gemm.launches, K.gate_up.launches, K.down.launches)
        if n1 != tuple(n + 1 for n in n0):
            raise AssertionError(f"moe_gemm launches {n0} -> {n1}")
        want = R.moe_gemm_ref(xg, wg, wu, wd, valid)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if not (torch.isfinite(got).all().item()
                and err <= TOL[dt_name] * scale
                and not got[~valid].any().item()):
            raise AssertionError(f"moe_gemm {dt_name}: max abs err {err} "
                                 f"vs scale {scale}")
        row = {"max_abs_err": err, "max_rel_err": err / scale,
               "tol_rel": TOL[dt_name]}
        if dt == torch.bfloat16:
            row["ms"] = cuda_ms(lambda: ops.moe_gemm(xg, wg, wu, wd, valid))
            row["plain_ms"] = cuda_ms(
                lambda: R.moe_gemm_ref(xg, wg, wu, wd, valid))
        out[dt_name] = row
        del xg, wg, wu, wd, got, want
        torch.cuda.empty_cache()
    return out


def full_grad_check(tr, batch) -> dict:
    """One forward and backward of the trainer's loss on one microbatch:
    every parameter's gradient finite and nonzero (the step reads every
    parameter; a kernel that cut a gradient would leave zeros).  Reports
    the routed experts whose gradient is 0 (an expert no token of the
    microbatch chose is read by no product that counts)."""
    import torch
    from repro_torch.models.train import make_loss_fn
    params = dict(tr.model.named_parameters())
    loss, _ = make_loss_fn(tr.model, tr.cfg)(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    bad, zero, idle = [], [], []
    for (n, p), g in zip(params.items(), grads):
        if not torch.isfinite(g).all().item():
            bad.append(n)
        elif not g.any().item():
            zero.append(n)
        elif n.endswith(("moe.wg", "moe.wu", "moe.wd")):
            idle += [f"{n}[{e}]" for e in range(g.shape[0])
                     if not g[e].any().item()]
    if bad or zero:
        raise AssertionError(f"gradients: non-finite {bad}, zero {zero}")
    return {"params": len(params), "loss": float(loss.detach()),
            "finite_nonzero": True, "experts_without_gradient": idle}


def count_grouped(fn):
    """Run ``fn()`` with a spy on ``moe.moe_grouped``: -> (fn's result,
    its calls by the id of the MoE layer it ran)."""
    from repro_torch.models import moe as MOE
    orig, seen = MOE.moe_grouped, {}

    def spy(p, x, cfg):
        seen[id(p)] = seen.get(id(p), 0) + 1
        return orig(p, x, cfg)
    MOE.moe_grouped = spy
    try:
        out = fn()
    finally:
        MOE.moe_grouped = orig
    return out, seen


def train_run(tr, steps: int, check_layers: bool = False) -> dict:
    """``tr.train(steps)`` with the device memory peak reset just before:
    losses, grad_norm and lr per step (read after the run), the median
    step time after step 1 (CUDA events), tokens/s and the peak."""
    import statistics
    import torch
    torch.cuda.synchronize()
    reset_peak()
    t0 = time.perf_counter()
    if check_layers:       # train() builds the model the calls ran in
        (_, losses), seen = count_grouped(
            lambda: tr.train(steps, log_every=0))
        calls = [seen.get(id(blk.moe), 0) for blk in tr.model.layers]
    else:
        _, losses = tr.train(steps, log_every=0)
        calls = None
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(tr.step_ms[1:])
    tokens = tr.shape.global_batch * tr.shape.seq_len
    out = {"losses": losses,
           "grad_norm": [float(m["grad_norm"]) for m in tr.metrics],
           "lr": [m["lr"] for m in tr.metrics],
           "step_ms": tr.step_ms, "median_step_ms_after_first": med,
           "tokens_per_step": tokens,
           "tokens_per_s": tokens / (med / 1e3),
           "device_max_allocated_bytes": peak, "wall_s": wall}
    if calls is not None:
        out["moe_grouped_calls_per_layer"] = calls
    if not all(math.isfinite(x) for x in losses + out["grad_norm"]):
        raise AssertionError(f"non-finite loss or grad norm: {out}")
    return out


MATMUL_NAMES = re.compile(r"gemm|nvjet|cutlass|xmma|wgmma", re.I)


def traced_step(step) -> dict:
    """One warm call of ``step`` traced with ``torch.profiler``: its span
    between CUDA events, the device's busy ms and idle share, the matmul
    kernels' ms (cuBLAS / CUTLASS names) and the rest's, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ev[0].record()
        step()
        ev[1].record()
        torch.cuda.synchronize()
    span = ev[0].elapsed_time(ev[1])
    kern = [(e.name, (e.time_range.end - e.time_range.start) / 1e3)
            for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(t for _, t in kern)
    mm = sum(t for n, t in kern if MATMUL_NAMES.search(n))
    other = {}
    for n, t in kern:
        if not MATMUL_NAMES.search(n):
            key = n.split("<")[0].split("(")[0][:80]
            other[key] = other.get(key, 0.0) + t
    return {"traced_span_ms": span, "busy_ms": busy,
            "idle_share": 1 - busy / span, "matmul_ms": mm,
            "other_ms": busy - mm, "kernels": len(kern),
            "other_top": dict(sorted(other.items(), key=lambda kv: -kv[1])
                              [:8])}


def train_breakdown(tr, batch, rows: int = TRAIN_B // TRAIN_MICRO) -> dict:
    """Where a train step's time goes, on a fresh state of ``tr``: one
    warm step traced (``traced_step``); and, untraced, one forward and
    backward over the batch's first ``rows`` rows (a microbatch), and one
    optimizer update."""
    import torch
    from repro_torch.models.train import make_loss_fn
    state = tr.init_state()
    params = state["params"]
    out = traced_step(lambda: tr.step_fn(params, state["opt"], batch))
    mb = {k: v[:rows] for k, v in batch.items()}
    loss_fn = make_loss_fn(tr.model, tr.cfg)

    def fb():
        loss, _ = loss_fn(mb)
        return torch.autograd.grad(loss, list(params.values()))
    fb_ms = cuda_ms(fb, iters=3)
    grads = {n: g.to(torch.bfloat16) for n, g in zip(params, fb())}
    opt_ms = cuda_ms(lambda: tr.opt.update(dict(grads), state["opt"],
                                           params), iters=3)
    return {**out, "microbatch_rows": rows,
            "microbatch_forward_backward_ms": fb_ms,
            "optimizer_update_ms": opt_ms}


def train_restart_drill(dev) -> dict:
    """The restart drill on the card: ``examples/train_lm_torch.py``'s
    ``main`` at its tiny default (200 steps, a failure at step 100, a
    restart from the step-100 checkpoint); then a tiny trainer's 10 steps
    straight against 5 + restart + 5 under
    ``torch.use_deterministic_algorithms(True)``: the parameters and the
    moments bit for bit."""
    import importlib.util
    import tempfile
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import Trainer
    spec = importlib.util.spec_from_file_location(
        "train_lm_torch", ROOT / "examples" / "train_lm_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        ex = example.main(["--device", str(dev)])
    if ex["resumed_from"] != 100 or len(ex["losses"]) != 100 or \
            not all(math.isfinite(x) for x in ex["losses"]):
        raise AssertionError(f"train_lm_torch restart: {ex}")
    example_s = time.perf_counter() - t0
    cfg = get_config("mixtral-8x7b").reduced(sliding_window=None)
    shape, run = ShapeConfig("drill", 64, 8, "train"), RunConfig(
        microbatch=2, learning_rate=1e-3, warmup_steps=2, total_steps=10)
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory() as d:
            straight, la = Trainer(cfg, shape, run, device=dev).train(
                10, log_every=0)
            Trainer(cfg, shape, run, device=dev, ckpt_dir=d).train(
                5, ckpt_every=5, log_every=0)
            resumed, lb = Trainer(cfg, shape, run, device=dev,
                                  ckpt_dir=d).train(10, log_every=0)
    finally:
        torch.use_deterministic_algorithms(False)
    same = lb == la[5:] and all(
        torch.equal(p, resumed["params"][n])
        for n, p in straight["params"].items()) and all(
        torch.equal(m, resumed["opt"].m[n])
        for n, m in straight["opt"].m.items())
    if not same:
        raise AssertionError("10 steps straight differ from 5 + restart + "
                             "5 under deterministic algorithms")
    return {"example": {"failed_at": ex["failed_at"],
                        "resumed_from": ex["resumed_from"],
                        "final_loss": ex["losses"][-1],
                        "first_resumed_loss": ex["losses"][0],
                        "seconds": example_s},
            "straight_vs_restart": {"steps": 10, "restart_at": 5,
                                    "deterministic_algorithms": True,
                                    "bit_equal": True,
                                    "final_loss": la[-1]}}


@contextlib.contextmanager
def one_rank_group():
    """A 1-rank NCCL process group (over a ``FileStore`` in a temp dir),
    destroyed on exit: what ``Trainer(mesh=single_device_mesh())`` runs
    over on the card."""
    import tempfile
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", store=dist.FileStore(
            os.path.join(d, "store"), 1), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


def mesh_train(dev, cfg, shape, run, plain: dict) -> dict:
    """The MoE train route on a mesh: ``cfg`` (mixtral, phase 17's cut)
    through ``Trainer(mesh=single_device_mesh())`` for MESH_STEPS steps on
    a 1-rank NCCL group, its losses against the plain run's of the same
    seed and data (``plain``, ``train_run``'s record) within
    MESH_LOSS_RTOL relative (bit-equality reported: every placement is
    trivial); the untraced step ms beside the plain run's, the peak, and
    ``reshard_mode_ab`` on the trained state."""
    import torch
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.launch.train import Trainer
    from repro_torch.models import placement as P
    with one_rank_group():
        tr = Trainer(cfg, shape, run, mesh=single_device_mesh())
        out = train_run(tr, MESH_STEPS)
        # where a step's time goes: one warm step traced on a fresh state
        state = tr.init_state()
        pipe = make_pipeline(cfg, shape)
        try:
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
        finally:
            pipe.close()
        batch = P.distribute_microbatches(batch, tr.mesh, run.microbatch)
        out["breakdown"] = traced_step(lambda: tr._step(state, batch))
        out["reshard_mode_ab"] = reshard_mode_ab(tr, state, batch)
        del tr, state, batch
        gc.collect()
    want = plain["losses"][:MESH_STEPS]
    rel = max(abs(a - b) / abs(b) for a, b in zip(out["losses"], want))
    out.update({"steps": MESH_STEPS, "plain_losses": want,
                "max_rel_loss_err": rel, "tol_rel": MESH_LOSS_RTOL,
                "bit_equal": out["losses"] == want,
                "plain_median_step_ms_after_first":
                    plain["median_step_ms_after_first"]})
    if rel > MESH_LOSS_RTOL:
        raise AssertionError(f"mixtral on a 1-rank mesh: losses "
                             f"{out['losses']} vs plain {want}")
    torch.cuda.empty_cache()
    return out


def reshard_mode_ab(tr, state, batch, pairs: int = MODE_AB_PAIRS) -> dict:
    """What the dry-run's reshard fallback would cost a mesh step: steps of
    ``tr`` (a ``Trainer`` on a mesh) on ``state`` and ``batch`` without and
    with ``placement.Reshard`` entered, alternated ``pairs`` times, each
    timed with CUDA events -> medians, and the ops the mode ran on
    gathered inputs (none: every op of the step places as laid out)."""
    import statistics
    import torch
    from repro_torch.models import placement as P
    ms = {"without": [], "with": []}
    resharded: dict = {}
    for _ in range(pairs):
        for kind in ("without", "with"):
            mode = P.Reshard() if kind == "with" else contextlib.nullcontext()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            with mode:
                state, metrics = tr._step(state, batch)
            ev[1].record()
            float(metrics["loss"])
            ms[kind].append(ev[0].elapsed_time(ev[1]))
            if kind == "with":
                for op, n in mode.resharded.items():
                    resharded[op] = resharded.get(op, 0) + n
    out = {f"median_ms_{k}_mode": statistics.median(v)
           for k, v in ms.items()}
    out.update({"ms": ms, "resharded_ops_under_mode": resharded})
    return out


def mesh_checkpoint_drill(dev) -> dict:
    """A checkpoint across meshes: llama3.2-3b at full width, 2 layers, B 4
    x S 1024, 3 AdamW steps on a 1-rank mesh, saved at step 3 into a temp
    dir; restored once into a plain ``Trainer`` and once onto a fresh
    1-rank mesh (every tensor bit-equal to the saved one), 2 more steps in
    each, both runs' losses equal to 5 uninterrupted plain steps (under
    ``torch.use_deterministic_algorithms(True)``); then
    ``reshard_mode_ab`` on the mesh run's state."""
    import tempfile
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import single_device_mesh
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.train import Trainer
    from repro_torch.models import placement as P
    cfg = dataclasses.replace(get_config("llama3.2-3b"),
                              num_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    run = RunConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                    total_steps=5)

    def local(t):
        return t.to_local() if hasattr(t, "to_local") else t

    def same(a, b) -> bool:
        la = [(k, local(v)) for k, v in sorted(_flat_state(a).items())]
        lb = [(k, local(v)) for k, v in sorted(_flat_state(b).items())]
        return [k for k, _ in la] == [k for k, _ in lb] and all(
            torch.equal(x, y) for (_, x), (_, y) in zip(la, lb))
    t0 = time.perf_counter()
    torch.use_deterministic_algorithms(True)
    try:
        _, straight = Trainer(cfg, shape, run, device=dev).train(
            5, log_every=0)
        gc.collect()
        with one_rank_group(), tempfile.TemporaryDirectory() as d:
            mesh = single_device_mesh()
            first = Trainer(cfg, shape, run, mesh=mesh, ckpt_dir=d)
            saved_state, head = first.train(3, ckpt_every=3, log_every=0)
            del first
            t_save = time.perf_counter()
            restored = {}
            for name, tr in (("plain", Trainer(cfg, shape, run, device=dev,
                                               ckpt_dir=d)),
                             ("mesh", Trainer(cfg, shape, run, mesh=mesh,
                                              ckpt_dir=d))):
                t1 = time.perf_counter()
                got = tr.ckpt.restore(3, tr.init_state())
                restore_s = time.perf_counter() - t1
                bit = same(got, saved_state)
                del got
                gc.collect()
                state, tail = tr.train(5, log_every=0)
                restored[name] = {"bit_equal_to_saved": bit,
                                  "restore_s": restore_s,
                                  "losses": tail,
                                  "equal_to_straight": tail == straight[3:]}
                if name == "mesh":
                    pipe = make_pipeline(cfg, shape)
                    try:
                        batch = {k: torch.from_numpy(v).to(dev)
                                 for k, v in next(pipe).items()}
                    finally:
                        pipe.close()
                    batch = P.distribute_microbatches(batch, mesh,
                                                      run.microbatch)
                    ab = reshard_mode_ab(tr, state, batch)
                    del batch
                del tr, state
                gc.collect()
                torch.cuda.empty_cache()
            disk = sum(f.stat().st_size for f in Path(d).rglob("*")
                       if f.is_file())
            del saved_state
    finally:
        torch.use_deterministic_algorithms(False)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"arch": "llama3.2-3b", "layers": TRAIN_LAYERS, "batch": TRAIN_B,
           "seq": TRAIN_S, "straight_losses": straight,
           "first_losses": head, "checkpoint_bytes": disk,
           "restored": restored, "reshard_mode_ab": ab,
           "seconds": time.perf_counter() - t0,
           "after_save_s": time.perf_counter() - t_save}
    if head != straight[:3] or not all(
            r["bit_equal_to_saved"] and r["equal_to_straight"]
            for r in restored.values()):
        raise AssertionError(f"checkpoint across meshes: {out}")
    return out


def _flat_state(state) -> dict:
    """{path: tensor} of a Trainer state (params, opt's fields)."""
    out = {}
    for name, tree in state.items():
        if isinstance(tree, dict):
            items = tree.items()
        else:
            items = [(f, getattr(tree, f)) for f in tree._fields]
        for k, v in items:
            if isinstance(v, dict):
                out.update({f"{name}/{k}/{n}": t for n, t in v.items()})
            else:
                out[f"{name}/{k}"] = v
    return out


def card_vs_cpu(dev, arch: str = "mixtral-8x7b") -> dict:
    """One train step's loss and gradients (``arch`` reduced, f32, B 4 x S
    32: mixtral's capacity route, the SSD families' plain scan, whisper
    with frames) on the card against the CPU's, from the same weights and
    batch: the largest relative error of the loss and of each gradient (to
    the CPU gradient's largest magnitude)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.models.train import make_loss_fn
    cfg = get_config(arch).reduced(dtype="float32")
    gen = torch.Generator().manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    frames = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen) \
        if cfg.family == "encdec" else None
    res = {}
    for where in ("cpu", dev):
        m = build_model(cfg, "cpu", seed=0).to(where)
        for p in m.parameters():
            p.requires_grad_(True)
        batch = {"tokens": toks[:, :-1].to(where),
                 "labels": toks[:, 1:].to(where)}
        if frames is not None:
            batch["frames"] = frames.to(where)
        loss, _ = make_loss_fn(m, cfg)(batch)
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, list(m.parameters()))
        res[str(where)] = (float(loss.detach()), {n: g.cpu() for n, g in
                                         zip(names, grads)})
    (lc, gc_), (lg, gg) = res["cpu"], res[str(dev)]
    errs = {n: float((gg[n] - g).abs().max()) / max(float(g.abs().max()),
                                                    1e-30)
            for n, g in gc_.items()}
    out = {"arch": arch, "loss_rel_err": abs(lg - lc) / abs(lc),
           "grad_max_rel_err": max(errs.values()),
           "grad_worst": max(errs, key=errs.get),
           "grad_rel_err": errs, "tol_rel": TRAIN_CPU_RTOL}
    if out["loss_rel_err"] > TRAIN_CPU_RTOL or \
            out["grad_max_rel_err"] > TRAIN_CPU_RTOL:
        raise AssertionError(f"the card's train step differs from the "
                             f"CPU's: {out}")
    return out


def guard_on_card(dev) -> dict:
    """A train step under ``attn_impl="kernel"`` raises naming flash
    attention (the kernel has no backward), and leaves the weights as they
    were."""
    import dataclasses
    import torch
    from repro_torch.configs.base import RunConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.models.train import make_train_step
    from repro_torch.optim.optimizer import make_optimizer, warmup_cosine
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="bfloat16"), attn_impl="kernel")
    m = build_model(cfg, dev, seed=0)
    for p in m.parameters():
        p.requires_grad_(True)
    opt = make_optimizer("adamw", warmup_cosine(1e-3, 1, 10))
    params = dict(m.named_parameters())
    before = {n: p.detach().clone() for n, p in params.items()}
    toks = torch.randint(0, cfg.vocab_size, (2, 129), device=dev)
    step = make_train_step(m, cfg, RunConfig(), opt)
    try:
        step(params, opt.init(params), {"tokens": toks[:, :-1],
                                        "labels": toks[:, 1:]})
    except RuntimeError as e:
        if "flash_attention" not in str(e):
            raise
        msg = str(e)
    else:
        raise AssertionError("a train step under attn_impl='kernel' ran")
    if not all(torch.equal(p.detach(), before[n]) for n, p in params.items()):
        raise AssertionError("the refused step changed the weights")
    return {"raised": True, "message": msg}


def train_child(dev) -> dict:
    """Phase 17 on its own (see the module docstring)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.train import Trainer
    from repro_torch.models.moe import capacity
    t0 = time.perf_counter()
    info = {"moe_gemm": moe_gemm_check(dev)}
    log(f"[17] moe_gemm ok: {info['moe_gemm']}")

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=TRAIN_LAYERS)
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    run = RunConfig(microbatch=TRAIN_MICRO, learning_rate=TRAIN_LR,
                    warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    flops = train_matmul_flops(cfg, TRAIN_B, TRAIN_S,
                               capacity(cfg, TRAIN_S))
    tr = Trainer(cfg, shape, run, device=dev)
    tr.init_state()
    pipe = make_pipeline(cfg, shape)
    try:
        first = next(pipe)
    finally:
        pipe.close()
    mb = {k: torch.from_numpy(v[:TRAIN_B // TRAIN_MICRO]).to(dev)
          for k, v in first.items()}
    grads = full_grad_check(tr, mb)
    del mb
    log(f"[17] every gradient finite and nonzero: {grads}")
    adamw = train_run(tr, TRAIN_STEPS, check_layers=True)
    per_call = TRAIN_STEPS * TRAIN_MICRO * 2     # forward + remat recompute
    if adamw["moe_grouped_calls_per_layer"] != [per_call] * TRAIN_LAYERS:
        raise AssertionError(f"moe_grouped per layer: "
                             f"{adamw['moe_grouped_calls_per_layer']}, "
                             f"expected {per_call} each")
    if not sum(adamw["losses"][-3:]) / 3 < adamw["losses"][0]:
        raise AssertionError(f"AdamW losses did not fall: {adamw['losses']}")
    batch = {k: torch.from_numpy(v).to(dev) for k, v in first.items()}
    adamw["breakdown"] = train_breakdown(tr, batch)
    del batch
    log(f"[17] a step's breakdown: {adamw['breakdown']}")
    sec = adamw["median_step_ms_after_first"] / 1e3
    adamw["matmul_tflop_per_step"] = {k: v / 1e12 for k, v in flops.items()}
    adamw["matmul_share_of_989_tflops"] = {
        k: v / sec / PEAK_BF16_FLOPS for k, v in flops.items()}
    log(f"[17] mixtral-8x7b AdamW: losses {adamw['losses']}, median step "
        f"{adamw['median_step_ms_after_first']:.1f} ms, "
        f"{adamw['tokens_per_s']:.0f} tokens/s, peak "
        f"{adamw['device_max_allocated_bytes'] / 2**30:.1f} GiB")
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    mesh = {"mixtral-8x7b": mesh_train(dev, cfg, shape, run, adamw)}
    log(f"[17] mixtral-8x7b on a 1-rank mesh: losses "
        f"{mesh['mixtral-8x7b']['losses']} (bit-equal to the plain run's: "
        f"{mesh['mixtral-8x7b']['bit_equal']}), median step "
        f"{mesh['mixtral-8x7b']['median_step_ms_after_first']:.1f} ms, "
        f"with the reshard mode / without: "
        f"{mesh['mixtral-8x7b']['reshard_mode_ab']}")
    mesh["llama3.2-3b_checkpoint"] = mesh_checkpoint_drill(dev)
    log(f"[17] llama3.2-3b checkpoint across meshes: "
        f"{mesh['llama3.2-3b_checkpoint']}")
    mesh["card"] = smi_line()

    tr8 = Trainer(cfg, shape, dataclasses.replace(run, optimizer="adamw8bit"),
                  device=dev, grad_compress=True)
    adamw8 = train_run(tr8, TRAIN_8BIT_STEPS)
    log(f"[17] mixtral-8x7b AdamW8bit + grad_compress: losses "
        f"{adamw8['losses']}, peak "
        f"{adamw8['device_max_allocated_bytes'] / 2**30:.1f} GiB")
    del tr8
    gc.collect()
    torch.cuda.empty_cache()

    vcfg = dataclasses.replace(get_config("llava-next-mistral-7b"),
                               num_layers=TRAIN_LAYERS)
    vshape = ShapeConfig("train", VLM_S, VLM_B, "train")
    vtr = Trainer(vcfg, vshape, dataclasses.replace(
        run, microbatch=0, total_steps=VLM_STEPS), device=dev)
    vlm = train_run(vtr, VLM_STEPS)
    pipe = make_pipeline(vcfg, vshape)
    try:
        vb = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    finally:
        pipe.close()
    with torch.no_grad():
        logits, _ = vtr.model.forward(vb["tokens"],
                                      patch_embeds=vb["patch_embeds"])
    text = VLM_S - vcfg.num_patches
    if tuple(logits.shape) != (VLM_B, text, vcfg.vocab_size) or \
            tuple(vb["patch_embeds"].shape[1:2]) != (vcfg.num_patches,):
        raise AssertionError(f"vlm logits {tuple(logits.shape)}")
    vlm.update({"patches": vcfg.num_patches, "text_tokens": text,
                "logits_shape": list(logits.shape)})
    log(f"[17] llava-next-mistral-7b: losses {vlm['losses']}")
    del vtr, logits, vb
    gc.collect()
    torch.cuda.empty_cache()

    ssd = {arch: ssd_train(dev, arch, layers) for arch, layers in SSD_TRAIN}
    ssd["mamba2-780m"]["adamw8bit_grad_compress"] = ssd_train_8bit(
        dev, ssd["mamba2-780m"]["median_step_ms_after_first"])

    info.update({
        "mixtral-8x7b": {"layers": TRAIN_LAYERS, "batch": TRAIN_B,
                         "seq": TRAIN_S, "microbatch": TRAIN_MICRO,
                         "remat": cfg.remat_policy, "dtype": cfg.dtype,
                         "learning_rate": TRAIN_LR,
                         "warmup_steps": TRAIN_WARMUP,
                         "capacity": capacity(cfg, TRAIN_S),
                         "first_backward": grads,
                         "adamw": adamw, "adamw8bit_grad_compress": adamw8},
        "llava-next-mistral-7b": {"layers": TRAIN_LAYERS, **vlm},
        **ssd,
        "card_vs_cpu": card_vs_cpu(dev),
        "card_vs_cpu_ssd": {arch: card_vs_cpu(dev, arch)
                            for arch, _ in SSD_TRAIN},
        "mesh": mesh,
        "guard": guard_on_card(dev),
        "restart": train_restart_drill(dev)})
    log(f"[17] card vs CPU {info['card_vs_cpu']}; restart "
        f"{info['restart']}")
    info["phase_s"] = time.perf_counter() - t0
    return info


def ssd_train(dev, arch: str, layers) -> dict:
    """``arch`` (an SSD family) at full width, ``layers`` deep (None: full
    depth), through ``Trainer.train``: SSD_TRAIN_STEPS AdamW steps whose
    losses are finite and whose last 3 average below the first, with the
    scan kernel launched 0 times (the train route scans with the plain
    ``ssd_ref``); then one served prefill of the trained model (no grad)
    launching it once per mamba layer; then one step's breakdown on a
    fresh state (``train_breakdown``)."""
    import dataclasses
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch.train import Trainer
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    shape = ShapeConfig("train", SSD_TRAIN_S, SSD_TRAIN_B, "train")
    run = RunConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                    total_steps=SSD_TRAIN_STEPS)
    tr = Trainer(cfg, shape, run, device=dev)
    reset_launches(trace=False)
    out = train_run(tr, SSD_TRAIN_STEPS)
    trained = read_launches(f"{arch} training", kernels=())["ssd_scan"]
    if trained != 0:
        raise AssertionError(f"{arch}: the SSD kernel launched {trained} "
                             f"times in training")
    if not sum(out["losses"][-3:]) / 3 < out["losses"][0]:
        raise AssertionError(f"{arch} losses did not fall: {out['losses']}")
    toks = torch.randint(0, cfg.vocab_size, (1, 512), device=dev,
                         generator=torch.Generator(dev).manual_seed(73))
    reset_launches(trace=False)
    with torch.no_grad():
        tr.model.prefill(toks, 512)
    served = read_launches(f"{arch} prefill after training",
                           ("ssd_scan",))["ssd_scan"]
    if served != mamba_layers(cfg):
        raise AssertionError(f"{arch}: {served} SSD launches in a prefill, "
                             f"expected {mamba_layers(cfg)}")
    pipe = make_pipeline(cfg, shape)
    try:
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(pipe).items()}
    finally:
        pipe.close()
    out["breakdown"] = train_breakdown(tr, batch, rows=SSD_TRAIN_B)
    del batch
    out.update({"layers": cfg.num_layers, "mamba_layers": mamba_layers(cfg),
                "batch": SSD_TRAIN_B, "seq": SSD_TRAIN_S,
                "params": sum(p.numel() for p in tr.model.parameters()),
                "ssd_launches_training": trained,
                "ssd_launches_prefill_after": served})
    log(f"[17] {arch} ({cfg.num_layers} layers): losses {out['losses']}, "
        f"median step {out['median_step_ms_after_first']:.1f} ms, peak "
        f"{out['device_max_allocated_bytes'] / 2**30:.1f} GiB")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return out


def ssd_train_8bit(dev, adamw_ms: float) -> dict:
    """mamba2-780m at full width and depth through ``Trainer.train`` under
    AdamW8bit with int8 gradient compression, TRAIN_8BIT_STEPS steps at
    the AdamW run's batch: the losses of the first two finite (the third
    comes after AdamW8bit's own blow-up), and the reference's stacked
    leaves whose 256-blocks straddle the layers (``A_log``, ``D``,
    ``dt_bias``: 48 a layer) quantized as stacks, ``[ceil(48 * 48 / 256),
    256]`` = [9, 256] each; the median step beside the AdamW run's
    (``adamw_ms``); then, on the trained state, the parts a step differs
    in (``eight_bit_parts``)."""
    import statistics
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import Trainer
    from repro_torch.optim.optimizer import QBLOCK
    cfg = get_config("mamba2-780m")
    run = RunConfig(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                    total_steps=SSD_TRAIN_STEPS, optimizer="adamw8bit")
    tr = Trainer(cfg, ShapeConfig("train", SSD_TRAIN_S, SSD_TRAIN_B,
                                  "train"), run, device=dev,
                 grad_compress=True)
    torch.cuda.synchronize()
    reset_peak()
    state, losses = tr.train(TRAIN_8BIT_STEPS, log_every=0)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses[:2]):
        raise AssertionError(f"mamba2-780m AdamW8bit losses {losses}")
    params = state["params"]
    groups = tr.opt.groups
    shapes = {k: list(state["opt"].m_q[k].shape) for k in groups}
    for leaf in ("A_log", "D", "dt_bias"):
        key = f"layers.*.mamba.{leaf}"
        names = groups.get(key, [])
        want = [-(-sum(params[n].numel() for n in names) // QBLOCK), QBLOCK]
        if len(names) != cfg.num_layers or shapes[key] != want:
            raise AssertionError(f"mamba2-780m: {key} over {len(names)} "
                                 f"layers, state {shapes.get(key)}, "
                                 f"expected {want}")
    med = statistics.median(tr.step_ms[1:])
    out = {"losses": losses, "step_ms": tr.step_ms,
           "median_step_ms_after_first": med,
           "adamw_median_step_ms_same_run": adamw_ms,
           "groups": {k: {"layers": len(groups[k]), "m_q_shape": v}
                      for k, v in shapes.items()},
           "device_max_allocated_bytes": peak,
           "parts": eight_bit_parts(tr, state)}
    log(f"[17] mamba2-780m AdamW8bit + grad_compress: losses {losses}, "
        f"median step {med:.1f} ms (AdamW {adamw_ms:.1f}); groups "
        f"{out['groups']}; parts {out['parts']}")
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def eight_bit_parts(tr, state) -> dict:
    """Where an AdamW8bit + compression step differs from an AdamW step,
    on ``tr``'s trained state and one set of seeded bf16 gradients (event
    ms, 3 calls each after one): the 8-bit update, the compression, an
    AdamW update on f32 moments of its own, and the moment update alone
    over every parameter as AdamW8bit makes it (``b m`` and ``(1 - b) g``
    each rounded, two f32 temporaries a parameter) against the fused form
    (``add_(g, alpha=)``, ``addcmul_``), on f32 moments."""
    import torch
    from repro_torch.optim.grad_compress import compress_with_error_feedback
    from repro_torch.optim.optimizer import AdamW
    params, opt = state["params"], tr.opt
    gen = torch.Generator(tr.device).manual_seed(29)
    grads = {n: (torch.randn(p.shape, generator=gen, device=tr.device)
                 * 1e-3).to(torch.bfloat16) for n, p in params.items()}
    out = {"update_8bit_ms": cuda_ms(lambda: opt.update(
        dict(grads), state["opt"], params), iters=3),
        "compress_ms": cuda_ms(lambda: compress_with_error_feedback(
            grads, state["ef"], opt.groups), iters=3)}
    adamw = AdamW(opt.lr_fn)
    moments = adamw.init(params)
    out["update_adamw_ms"] = cuda_ms(lambda: adamw.update(
        dict(grads), moments, params), iters=3)
    m, v = moments.m, moments.v
    b1, b2 = opt.b1, opt.b2

    def update(fused: bool):
        with torch.no_grad():
            for n, g in grads.items():
                gf = g.float()
                if fused:
                    m[n].mul_(b1).add_(gf, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(gf, gf, value=1 - b2)
                else:
                    m[n].mul_(b1).add_(gf * (1 - b1))
                    v[n].mul_(b2).add_((gf * (1 - b2)).mul_(gf))
    out["moments_rounded_ms"] = cuda_ms(lambda: update(False), iters=3)
    out["moments_fused_ms"] = cuda_ms(lambda: update(True), iters=3)
    return out


# ---------------------------------------------------------------------------
# phase 18: whisper-medium (encdec) served and trained, in a child process
# ---------------------------------------------------------------------------

def whisper_teacher_force(model, seq, frames):
    """Logits of one train-mode pass over seq [1, S] (no grad), padded at
    its end to a multiple of 128 past 128 (flash's precondition): causal
    self-attention and per-query cross-attention keep the padding out of
    every earlier position."""
    import torch
    S = seq.shape[1]
    pad = (-S) % 128 if S > 128 else 0
    if pad:
        seq = torch.cat([seq, torch.zeros((1, pad), dtype=seq.dtype,
                                          device=seq.device)], dim=1)
    with torch.no_grad():
        return model.forward(seq, frames)[0][:, :S]


def whisper_serve(dev) -> dict:
    """whisper-medium served under ``attn_impl="kernel"``: encode + prefill
    of a WHISPER_PROMPT-token prompt, then WHISPER_NEW greedy one-token
    steps, the launch counts set to 0 just before and read just after
    (flash once per decoder layer in the prefill, flash-decode once per
    decoder layer per step; every call at 16 / 16 x 64; the encoder and the
    cross-attention run ``mha``); served again for its times (the same
    tokens); one step timed and traced; every token teacher-forced."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config("whisper-medium"),
                              attn_impl="kernel")
    heads = (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    reset_peak()
    t0 = time.perf_counter()
    model = build_model(cfg, dev, seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    frames = torch.randn((1, cfg.encoder_seq, cfg.d_model), device=dev,
                         generator=torch.Generator(dev).manual_seed(70)
                         ).to(model.dtype)
    prompt = torch.randint(0, cfg.vocab_size, (1, WHISPER_PROMPT),
                           generator=torch.Generator().manual_seed(71))
    p = prompt.to(dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def serve():
        """-> (tokens [1 + WHISPER_NEW] on the device, cache)"""
        ev[0].record()
        logits, cache = model.prefill(p, WHISPER_MAX_SEQ, frames)
        ev[1].record()
        tok = logits.argmax(-1)
        out = [tok]
        for i in range(WHISPER_NEW):
            logits, cache, _ = model.decode_step(cache, tok[:, None],
                                                 WHISPER_PROMPT + i)
            tok = logits[:, -1].argmax(-1)
            out.append(tok)
        ev[2].record()
        return torch.cat(out), cache

    with torch.no_grad(), attention_shapes() as shapes:
        reset_launches(trace=False)
        t0 = time.perf_counter()
        tokens, cache = serve()
        torch.cuda.synchronize()
        first_wall = time.perf_counter() - t0
        launches = read_launches("whisper-medium serving",
                                 ("flash_attention", "decode_attention"))
    want = {"flash_attention": cfg.num_layers,
            "decode_attention": cfg.num_layers * WHISPER_NEW}
    if any(launches[k] != n for k, n in want.items()):
        raise AssertionError(f"whisper-medium: launches {launches}, "
                             f"expected {want}")
    want_shapes = {(k, *heads) for k in want}
    if shapes != want_shapes:
        raise AssertionError(f"whisper-medium: attention ran at "
                             f"{sorted(shapes)}, not {sorted(want_shapes)}")
    with torch.no_grad():
        t0 = time.perf_counter()
        again, cache = serve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not torch.equal(again, tokens):
            raise AssertionError("whisper-medium: served again, other "
                                 "tokens")
        prefill_ms = ev[0].elapsed_time(ev[1])
        steps_ms = ev[1].elapsed_time(ev[2])
        encode_ms = cuda_ms(lambda: model.encode(frames), iters=3)
        tok = tokens[-1:][:, None]
        step_ms = cuda_ms(lambda: model.decode_step(cache, tok,
                                                    WHISPER_PROMPT))
        step_prof = device_profile(
            lambda: model.decode_step(cache, tok, WHISPER_PROMPT), step_ms,
            FOCUS_DECODE)
    del cache
    emitted = tokens.tolist()
    loss = lossless_phase(
        model, [(prompt, emitted)], dev,
        forward=lambda m, seq: whisper_teacher_force(m, seq, frames),
        margin=WHISPER_MARGIN)
    if loss["exact"] < WHISPER_MIN_EXACT * len(emitted):
        raise AssertionError(f"whisper-medium: only {loss['exact']} of "
                             f"{len(emitted)} tokens are the teacher-forced "
                             f"argmax")
    info = {"model": cfg.name, "encoder_layers": cfg.encoder_layers,
            "decoder_layers": cfg.num_layers,
            "encoder_seq": cfg.encoder_seq, "prompt": WHISPER_PROMPT,
            "new_tokens": WHISPER_NEW, "max_seq": WHISPER_MAX_SEQ,
            "heads": {"H": heads[0], "Hkv": heads[1], "D": heads[2]},
            "attention_calls": sorted(shapes),
            "params": sum(t.numel() for t in model.parameters()),
            "model_init_s": init_s, "first_wall_s": first_wall,
            "wall_s": wall, "encode_ms": encode_ms,
            "prefill_ms": prefill_ms,
            "tpot_ms": steps_ms / WHISPER_NEW,
            "tpot_wall_s": (wall - prefill_ms / 1e3) / WHISPER_NEW,
            "decode_step_ms": step_ms, "decode_step_profile": step_prof,
            "launches": {k: launches[k] for k in want},
            "launches_host": {k: launches["host"][k] for k in want},
            "lossless": loss,
            "device_max_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(f"[18] whisper-medium served: encode {encode_ms:.2f} ms, prefill "
        f"{prefill_ms:.2f} ms, TPOT {info['tpot_ms']:.2f} ms, launches "
        f"{info['launches']}, lossless {loss}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return info


def whisper_train(dev) -> dict:
    """whisper-medium trained through ``make_train_step`` (the Trainer's
    pipeline gives no frames, as the reference's gives none) under
    ``attn_impl="xla"``: WHISPER_TRAIN_STEPS AdamW steps on the port's
    pipeline's tokens with a seeded frames batch each step; losses finite,
    the last 3 below the first; step ms (CUDA events), tokens/s, peak."""
    import statistics
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.models.registry import build_model
    from repro_torch.models.train import make_train_step
    from repro_torch.optim.optimizer import make_optimizer, warmup_cosine
    cfg = get_config("whisper-medium")
    gc.collect()
    torch.cuda.empty_cache()
    reset_peak()
    model = build_model(cfg, dev, seed=0)
    for prm in model.parameters():
        prm.requires_grad_(True)
    opt = make_optimizer("adamw", warmup_cosine(
        WHISPER_TRAIN_LR, TRAIN_WARMUP, WHISPER_TRAIN_STEPS))
    step = make_train_step(model, cfg, RunConfig(), opt)
    params = dict(model.named_parameters())
    state = opt.init(params)
    shape = ShapeConfig("train", WHISPER_TRAIN_S, WHISPER_TRAIN_B, "train")
    gen = torch.Generator(dev).manual_seed(72)
    pipe = make_pipeline(cfg, shape)
    losses, norms, ms = [], [], []
    try:
        for _ in range(WHISPER_TRAIN_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in next(pipe).items()}
            batch["frames"] = torch.randn(
                (WHISPER_TRAIN_B, cfg.encoder_seq, cfg.d_model), device=dev,
                generator=gen).to(model.dtype)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            params, state, metrics = step(params, state, batch)
            ev[1].record()
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            ms.append(ev[0].elapsed_time(ev[1]))
    finally:
        pipe.close()
    if not all(math.isfinite(x) for x in losses + norms):
        raise AssertionError(f"whisper-medium: losses {losses}, grad norms "
                             f"{norms}")
    if not sum(losses[-3:]) / 3 < losses[0]:
        raise AssertionError(f"whisper-medium losses did not fall: "
                             f"{losses}")
    breakdown = traced_step(lambda: step(params, state, batch))
    med = statistics.median(ms[1:])
    tokens = WHISPER_TRAIN_B * WHISPER_TRAIN_S
    out = {"batch": WHISPER_TRAIN_B, "seq": WHISPER_TRAIN_S,
           "frames": [WHISPER_TRAIN_B, cfg.encoder_seq, cfg.d_model],
           "attn_impl": cfg.attn_impl, "remat": cfg.remat_policy,
           "learning_rate": WHISPER_TRAIN_LR, "losses": losses,
           "grad_norm": norms,
           "step_ms": ms, "median_step_ms_after_first": med,
           "tokens_per_s": tokens / (med / 1e3), "breakdown": breakdown,
           "params": sum(prm.numel() for prm in params.values()),
           "device_max_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(f"[18] whisper-medium trained: losses {losses}, median step "
        f"{med:.1f} ms, peak {out['device_max_allocated_bytes'] / 2**30:.1f}"
        f" GiB")
    del model, params, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_child(dev) -> dict:
    """Phase 18 on its own (see the module docstring)."""
    t0 = time.perf_counter()
    info = {"serve": whisper_serve(dev), "train": whisper_train(dev),
            "card_vs_cpu": card_vs_cpu(dev, "whisper-medium")}
    log(f"[18] whisper-medium card vs CPU: gradients within "
        f"{info['card_vs_cpu']['grad_max_rel_err']}")
    info["phase_s"] = time.perf_counter() - t0
    return info


def mixtral_pair(dev):
    """mixtral-8x7b at full width cut to 4 layers (its experts on the
    host) and its dense mistral-7b draft, 4 layers, both under
    ``attn_impl="kernel"``, random weights from seeds 0 / 1."""
    from repro_torch.configs.registry import get_config, get_draft_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), num_layers=4,
                              attn_impl="kernel")
    dcfg = dataclasses.replace(get_draft_config("mixtral-8x7b"),
                               num_layers=4, attn_impl="kernel")
    target = build_model(cfg, dev, seed=0, expert_device="cpu")
    draft = build_model(dcfg, dev, seed=1)
    return cfg, dcfg, target, draft


def chaos_child(dev) -> dict:
    """Phase 5b on its own: the mixtral pair, ``chaos_phase``, then every
    token it emitted teacher-forced with the target's experts on the card
    (the rule of phase 6)."""
    import torch
    cfg, dcfg, target, draft = mixtral_pair(dev)
    prompts = [torch.randint(0, cfg.vocab_size, (1, 64),
                             generator=torch.Generator().manual_seed(31 + i))
               for i in range(2)]
    pairs, info = chaos_phase(target, draft, cfg, dcfg, prompts, dev)
    for blk in target.layers:
        for n in ("wg", "wu", "wd"):
            w = getattr(blk.moe, n)
            setattr(blk.moe, n, torch.nn.Parameter(w.to(dev),
                                                   requires_grad=False))
    info["lossless"] = lossless_phase(
        target, [(p, r.tokens) for p, r in pairs], dev)
    return info


def seqpar_model(dev, dtype: str = "bfloat16", layers=None):
    """mamba2-780m at full width (``layers`` deep, default all 48), random
    weights from seed 0, and the phase's tokens [1, SEQPAR_S] (a CPU
    generator: the same in every process)."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    cfg = dataclasses.replace(get_config("mamba2-780m"), dtype=dtype,
                              **({"num_layers": layers} if layers else {}))
    model = build_model(cfg, dev, seed=0)
    tokens = torch.randint(0, cfg.vocab_size, (1, SEQPAR_S),
                           generator=torch.Generator().manual_seed(
                               SEQPAR_SEED))
    return model, tokens


def seqpar_rank(backend: str, n: int, rank: int, store: str, out: str
                ) -> dict:
    """One rank of a sequence-parallel prefill: its shard of the bf16
    full-depth model's sequence (the SSD launches counted from 0 around
    the first call, a second call timed, the rank's device memory peak)
    and, in the f32 run's group, its shard of the reduced model's; rank 0
    saves the logits to ``out``."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.mamba_sp import seq_parallel_forward
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=dist.FileStore(store, n),
                            rank=rank, world_size=n)
    try:
        model, tokens = seqpar_model(dev)
        s = SEQPAR_S // n
        shard = tokens[:, rank * s:(rank + 1) * s].to(dev)
        torch.cuda.synchronize()
        reset_peak()
        SSD.ssd_scan.launches = 0
        logits = seq_parallel_forward(model, shard)
        torch.cuda.synchronize()
        launches = SSD.ssd_scan.launches
        ms = cuda_ms(lambda: seq_parallel_forward(model, shard), iters=2)
        info = {"rank": rank, "shard": [rank * s, (rank + 1) * s],
                "ssd_launches": launches, "forward_ms": ms,
                "device_max_allocated_bytes":
                    torch.cuda.max_memory_allocated()}
        saved = {"logits": logits.float().cpu()}
        del model
        if backend == "gloo" and n == SEQPAR_F32_RANKS:
            m32, _ = seqpar_model(dev, "float32", SEQPAR_F32_LAYERS)
            s32 = SEQPAR_F32_S // n
            saved["logits_f32"] = seq_parallel_forward(
                m32, tokens[:, rank * s32:(rank + 1) * s32].to(dev)).cpu()
        if rank == 0:
            torch.save(saved, out)
        return info
    finally:
        dist.destroy_process_group()


def seqpar_group(backend: str, n: int, tmp: Path) -> dict:
    """A group of ``n`` rank processes of this script (``--phase
    seqpar-rank``) started together on the one card and joined within
    SEQPAR_RANK_TIMEOUT_S (all killed on a hang); -> each rank's line and
    rank 0's logits."""
    import torch
    run = tmp / f"{backend}{n}"
    run.mkdir()
    out = run / "logits.pt"
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--phase",
         "seqpar-rank", backend, str(n), str(r), str(run / "store"),
         str(out)], stdout=subprocess.PIPE, text=True) for r in range(n)]
    lines = []
    try:
        for p in procs:
            lines.append(p.communicate(timeout=SEQPAR_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError(f"seqpar {backend} x {n}: ranks exited "
                             f"{[p.returncode for p in procs]}")
    ranks = [json.loads(o.strip().splitlines()[-1]) for o in lines]
    return {"ranks": ranks, "saved": torch.load(out)}


def seqpar_child(dev) -> dict:
    """Phase 19 on its own (see the module docstring); its stores, saved
    logits and the dry-run's record in a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="seqpar") as tmp:
        return seqpar_phase(dev, Path(tmp))


def seqpar_phase(dev, tmp: Path) -> dict:
    import torch
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models import mamba as M
    t0 = time.perf_counter()
    arch, shape = SEQPAR_DRYRUN
    dry_out, dry_log = tmp / "dryrun.json", tmp / "dryrun.log"
    with open(dry_log, "w") as log_file:
        dry = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--multi-pod", "no", "--out",
             str(dry_out)],
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
            stdout=log_file, stderr=subprocess.STDOUT)
    try:
        # the single-process references: the plain scan over the whole
        # sequence (forward, no kernel)
        model, tokens = seqpar_model(dev)
        cfg = model.cfg
        with torch.no_grad():
            ref = model(tokens.to(dev))[0][:, -1].float().cpu()
            ref_ms = cuda_ms(lambda: model(tokens.to(dev)), iters=1)
        del model
        m32, _ = seqpar_model(dev, "float32", SEQPAR_F32_LAYERS)
        with torch.no_grad():
            ref32 = m32(tokens[:, :SEQPAR_F32_S].to(dev))[0][:, -1].cpu()
        del m32
        gc.collect()
        torch.cuda.empty_cache()
        runs = {}
        for backend, n in SEQPAR_RUNS:
            if backend == "nccl":       # this process's one rank
                (tmp / "nccl1").mkdir()
                out = tmp / "nccl1" / "logits.pt"
                r = {"ranks": [seqpar_rank(backend, n, 0,
                                           str(tmp / "nccl1" / "store"),
                                           str(out))],
                     "saved": torch.load(out)}
                gc.collect()
                torch.cuda.empty_cache()
            else:
                r = seqpar_group(backend, n, tmp)
            got = r["saved"]["logits"]
            err = (got - ref).abs().max().item()
            scale = ref.abs().max().item()
            row = {"backend": backend, "ranks": n, "shard_len": SEQPAR_S // n,
                   "max_abs_err": err, "ref_max_abs": scale,
                   "tol_abs": SEQPAR_TOL,
                   "argmax": got.argmax(-1).tolist(),
                   "ref_argmax": ref.argmax(-1).tolist(),
                   "ssd_launches_per_rank": [x["ssd_launches"]
                                             for x in r["ranks"]],
                   "forward_ms_per_rank": [x["forward_ms"]
                                           for x in r["ranks"]],
                   "device_peak_bytes_per_rank": [
                       x["device_max_allocated_bytes"] for x in r["ranks"]]}
            if not (torch.isfinite(got).all() and got.shape == ref.shape):
                raise AssertionError(f"seqpar {backend} x {n}: logits "
                                     f"{tuple(got.shape)} not finite")
            if "logits_f32" in r["saved"]:
                got32 = r["saved"]["logits_f32"]
                e32 = (got32 - ref32).abs().max().item()
                row["f32"] = {"layers": SEQPAR_F32_LAYERS,
                              "S": SEQPAR_F32_S, "max_abs_err": e32,
                              "tol_abs": SEQPAR_F32_TOL,
                              "argmax": got32.argmax(-1).tolist(),
                              "ref_argmax": ref32.argmax(-1).tolist()}
                if not (e32 <= SEQPAR_F32_TOL and row["f32"]["argmax"] ==
                        row["f32"]["ref_argmax"]):
                    raise AssertionError(f"seqpar f32: {row['f32']}")
            # the deep stacks' rule for the token: the reference's argmax,
            # or one the reference ranks within SSM_MARGIN of its top (a
            # near tie under bf16); the f32 run above matched exactly
            gap = (ref.max(-1).values - ref.gather(
                -1, got.argmax(-1, keepdim=True))[:, 0]).max().item()
            row["ref_gap_of_argmax"] = gap
            row["ref_top2"] = ref.topk(2, -1).values.tolist()
            if gap > SSM_MARGIN or err > SEQPAR_TOL:
                raise AssertionError(f"seqpar {backend} x {n}: {row}")
            if row["ssd_launches_per_rank"] != [mamba_layers(cfg)] * n:
                raise AssertionError(f"seqpar {backend} x {n}: SSD launches "
                                     f"{row['ssd_launches_per_rank']}")
            runs[f"{backend}{n}"] = row
            log(f"[19] seqpar {backend} x {n}: max abs err {err:.4f} of "
                f"{scale:.2f}, argmax {row['argmax']} (reference "
                f"{row['ref_argmax']}, {gap:.4f} below its top), forward "
                f"{max(row['forward_ms_per_rank']):.1f} ms")
        # the SSD kernel at each run's shard shape, against ssd_ref
        d_in, h, N, conv_ch = M.dims(cfg)
        p, Q = cfg.ssm_head_dim, cfg.ssm_chunk
        gen = torch.Generator(dev).manual_seed(5)
        kernel = {}
        for _, n in SEQPAR_RUNS:
            S = SEQPAR_S // n
            x, dt, A, B, C = ssd_inputs(gen, dev, S, h, p, N, torch.bfloat16)
            y, st = SSD.ssd_scan(x, dt, A, B, C, Q)
            y_ref, st_ref = R.ssd_ref(x, dt, A, B, C, Q)
            err = (y.float() - y_ref.float()).abs().max().item()
            scale = y_ref.float().abs().max().item()
            serr = (st - st_ref).abs().max().item()
            sscale = st_ref.abs().max().item()
            if not (err <= SSD_TOL["bfloat16"] * scale and
                    serr <= SSD_STATE_TOL * max(sscale, 1e-6)):
                raise AssertionError(f"ssd_scan at S {S}: y err {err} of "
                                     f"{scale}, state err {serr}")
            bound, by, flops, nbytes = ssd_bound(S, Q, h, p, N, 2)
            kernel[S] = {
                "h": h, "p": p, "n": N, "chunk": Q, "max_abs_err": err,
                "max_rel_err": err / scale, "state_max_abs_err": serr,
                "ms": cuda_ms(lambda: SSD.ssd_scan(x, dt, A, B, C, Q)),
                "plain_ms": cuda_ms(lambda: R.ssd_ref(x, dt, A, B, C, Q),
                                    iters=2),
                "library_ms": None, "bound_ms": bound, "bound_by": by,
                "flops": flops, "bytes": nbytes}
            del x, dt, A, B, C, y, st, y_ref, st_ref
        torch.cuda.empty_cache()
        dry.wait(timeout=CHILD_TIMEOUT_S)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    cells = json.loads(dry_out.read_text()) if dry_out.exists() else []
    if dry.returncode != 0 or len(cells) != 1 or cells[0]["status"] != "ok":
        raise AssertionError(f"dry-run {arch} x {shape}: exit "
                             f"{dry.returncode}, {cells}, "
                             f"{dry_log.read_text()[-2000:]}")
    cell = cells[0]
    # collective bytes per layer and rank: the all-gathered halos [B, W-1,
    # conv_ch], end states [B, H, P, N] f32 and decays [B, H] f32, n of
    # each; against the layer's activations [B, S_loc, d] (what a tensor-
    # parallel all-reduce would move)
    W, el = cfg.ssm_conv_width, 2
    coll = {f"ranks{n}": {
        "all_gather_bytes": n * ((W - 1) * conv_ch * el + h * p * N * 4
                                 + h * 4),
        "activation_bytes": (SEQPAR_S // n) * cfg.d_model * el}
        for _, n in SEQPAR_RUNS}
    return {"model": {"arch": "mamba2-780m", "layers": cfg.num_layers,
                      "d_model": cfg.d_model, "dtype": cfg.dtype, "B": 1,
                      "S": SEQPAR_S},
            "single_forward_ms": ref_ms, "runs": runs,
            "collective_bytes_per_layer": coll,
            "ssd_kernel_at_shard": {f"S{S}": k for S, k in kernel.items()},
            "dryrun": {k: cell[k] for k in (
                "arch", "shape", "status", "fn", "mesh", "memory",
                "xla_cost", "hlo_collectives", "resharded_ops",
                "compile_s")},
            "phase_s": time.perf_counter() - t0}


def run_child(phase: str, *args) -> dict:
    """Run one phase in a child process of this script (``--phase``): its
    log lines go to this stderr, its result is the last line of its
    stdout.  Fails when the child fails."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                          "--phase", phase, *args], stdout=subprocess.PIPE,
                         text=True, timeout=CHILD_TIMEOUT_S)
    if out.returncode != 0:
        raise AssertionError(f"phase {phase} {args} failed (exit "
                             f"{out.returncode})")
    info = json.loads(out.stdout.strip().splitlines()[-1])
    info["process_s"] = time.perf_counter() - t0
    SHAPE_LAUNCHES.update(info.pop("shape_launches", {}))
    return info


def child_main(phase: str, *args) -> int:
    """A phase in a process of its own: the chaos phase, one dense target
    (``dense <arch>``), training, whisper-medium, sequence-parallel Mamba2
    or one of its ranks (``seqpar-rank <backend> <n> <rank> <store>
    <out>``), or phase 13's solo path n times (``phi-draft <n>``); prints
    its result as one JSON line."""
    if phase == "train":   # cuBLAS's workspace for deterministic algorithms
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    if phase == "chaos":
        info = chaos_child(dev)
    elif phase == "dense":
        arch, layers, seed = next(t for t in DENSE_TARGETS
                                  if t[0] == args[0])
        info = dense_phase(dev, arch, layers, seed)
    elif phase == "train":
        info = train_child(dev)
    elif phase == "phi-draft":
        info = phi_draft_child(dev, int(args[0]))
    elif phase == "whisper":
        info = whisper_child(dev)
    elif phase == "seqpar":
        info = seqpar_child(dev)
    elif phase == "seqpar-rank":
        backend, n, rank, store, out = args
        info = seqpar_rank(backend, int(n), int(rank), store, out)
    else:
        raise ValueError(f"no phase {phase!r}")
    info["shape_launches"] = dict(SHAPE_LAUNCHES)
    info["process_peaks"] = {
        "device_max_allocated_bytes": script_peak(),
        "host_max_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024}
    print(json.dumps(info))
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 2
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build

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

    # phases 5b and 14-16 first, each in a child process of its own (this
    # one has made no CUDA context yet): the card's whole memory for
    # nemotron-4-340b, and a profiler of their own for their traces
    chaos_info = run_child("chaos")
    log(f"[5b] chaos serving ok in {chaos_info['phase_s']:.1f} s")
    dense_targets = {}
    for i, (arch, _, _) in enumerate(DENSE_TARGETS):
        d = dense_targets[arch] = run_child("dense", arch)
        log(f"[{14 + i}] {arch} ({d['layers']} / {d['draft_layers']} "
            f"layers) serving ok in {d['phase_s']:.1f} s: TPOT greedy "
            f"{d['greedy']['tpot_wall_s_untraced'] * 1e3:.2f} / sd "
            f"{d['sd']['tpot_wall_s_untraced'] * 1e3:.2f} ms (untraced), "
            f"decode step "
            f"{d['decode_step_ms']:.3f} ms, peak "
            f"{d['device_max_allocated_bytes'] / 2**30:.1f} GiB")
    train_info = run_child("train")
    log(f"[17] training ok in {train_info['phase_s']:.1f} s")
    whisper_info = run_child("whisper")
    log(f"[18] whisper-medium served and trained in "
        f"{whisper_info['phase_s']:.1f} s")
    seqpar_info = run_child("seqpar")
    log(f"[19] sequence-parallel mamba2-780m ok in "
        f"{seqpar_info['phase_s']:.1f} s")

    mixtral = get_config("mixtral-8x7b")
    rows, main_k = kernel_phase(dev, mixtral.d_model, mixtral.moe_d_ff)
    gelu_rows, gelu_k = kernel_phase(dev, mixtral.d_model, mixtral.moe_d_ff,
                                     gelu=True, seed=4)
    log("[2] expert FFN checked")
    fa_rows, fa_timing = flash_phase(dev)
    log("[2] flash checked")
    dec_rows, dec_timing = decode_phase(dev)
    log("[2] flash-decode checked")
    ssd_rows, ssd_timing = ssd_phase(dev)
    rows += gelu_rows + fa_rows + dec_rows + ssd_rows
    log("[2] SSD scan checked")
    ffn_any = {}
    for i, (d, f) in enumerate(FFN_ANY):
        # f32 at the small width only: mixtral's widths less 4 hold 8.4 GB
        # of f32 weights, and f32 is served by no model
        any_rows, ffn_any[(d, f)] = kernel_phase(
            dev, d, f, seed=6 + i,
            dtypes=("bfloat16",) if d > 1024 else ("bfloat16", "float32"))
        rows += any_rows
        log(f"[2] expert FFN at d {d} / f {f} checked")
    any_rows, gelu_any = kernel_phase(dev, *FFN_ANY[0], gelu=True, seed=8)
    rows += any_rows
    log(f"[2] kernels match their plain versions ({len(rows)} checks); "
        f"flash {fa_timing}; decode {dec_timing}; ssd {ssd_timing}")

    t0 = time.perf_counter()
    cfg, dcfg, target, draft = mixtral_pair(dev)
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
    # phase 8b: the same model and prompts at Mamba2's published chunk 256
    c256_reqs, c256_info = ssm_phase(
        "mamba2-c256", dataclasses.replace(mcfg, ssm_chunk=SSM_CHUNK), dev,
        ssm_prompts, SSM_NEW, profile=False,
        check=chunk_check(ssm_prompts, mamba_info.pop("_tokens"), dev))
    c256_info.pop("_tokens")
    log(f"[8b] mamba2-780m at chunk {SSM_CHUNK} ok: prefill "
        f"{c256_info['prefill_ms']:.3f} ms (chunk 128: "
        f"{mamba_info['prefill_ms']:.3f} ms), {c256_info['check']}")
    # zamba2-7b's shared attention block (32 / 32 heads x 112) through the
    # flash kernel in every prefill and flash-decode in every greedy step
    zcfg = dataclasses.replace(get_config("zamba2-7b"),
                               num_layers=ZAMBA_LAYERS, attn_impl="kernel")
    zamba_reqs, zamba_info = ssm_phase(
        "zamba2", zcfg, dev, [torch.randint(0, zcfg.vocab_size, (1, 512),
                                            generator=gen)], SSM_NEW,
        kernels=("ssd_scan", "flash_attention", "decode_attention"))
    zamba_info.pop("_tokens")
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
    graphs_targets = {a: d.pop("graphs") for a, d in dense_targets.items()}

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
        "launches_dense_paths": {a: d["launches"]["flash_attention"]
                                 for a, d in dense_targets.items()},
        "launches_whisper_path": whisper_info["serve"]["launches"][
            "flash_attention"],
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
        "launches_dense_paths": {a: d["launches"]["decode_attention"]
                                 for a, d in dense_targets.items()},
        "launches_whisper_path": whisper_info["serve"]["launches"][
            "decode_attention"],
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
                    "draft_calls_trace" if name == "cache_moe_gate_up"
                    else "draft_down_calls_trace"],
                "launches_draft_host": phi_info["draft_launches"][
                    "draft_calls_host" if name == "cache_moe_gate_up"
                    else "draft_down_calls_host"],
                "row": "draft" if draft_row else "target",
                "T": T, "k": PHI_K, "pool": PHI_E,
                "f": PHI_DRAFT_F if draft_row else PHI_F,
                "max_abs_err": tm[T]["err"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    # flash and flash-decode at whisper-medium's 16 / 16 x 64 (phase 18):
    # the served prefill's S 128 and the last served step's 192 keys
    wserve = whisper_info["serve"]
    for name, t, source, line in (
            ("flash_attention", fa_timing[f"{WHISPER_PROMPT}_whisper-medium"],
             "flash_attention.cu", "flash_attention.py:27"),
            ("decode_attention", dec_timing["whisper-medium"],
             "decode_attention.cu", "decode_attention.py:26")):
        kernels.append({
            "name": f"{name}_whisper", "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": f"src/repro/kernels/{line}",
            "launches": wserve["launches"][name],
            "launches_host": wserve["launches_host"][name],
            "H": t["H"], "Hkv": t["Hkv"], "D": t["D"],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "library_device_ms": t["library_device_ms"]})
    # flash and flash-decode at head shapes no model has (EXTRA_SHAPES),
    # flash at S 512 and flash-decode at 543 of 576 keys; launches: the
    # wrapper's at that head shape over every main path of this run
    for m, H, Hkv, D in EXTRA_SHAPES:
        for name, t, source, line in (
                ("flash_attention", fa_timing.get(f"512_{m}"),
                 "flash_attention.cu", "flash_attention.py:27"),
                ("decode_attention", dec_timing[m],
                 "decode_attention.cu", "decode_attention.py:26")):
            if t is None:
                continue
            kernels.append({
                "name": f"{name}_{m}", "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "replaces": f"src/repro/kernels/{line}",
                "launches": SHAPE_LAUNCHES[f"{name} {H}/{Hkv}/{D}"],
                "launches_note": "the wrapper's launches at this head "
                "shape over every main path of this run (no model of the "
                "run has it)", "H": H, "Hkv": Hkv, "D": D,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    # attention at ANY_HEAD_DIMS (32 / 8 heads, bf16; flash at S 512 on
    # wgmma, flash-decode at 543 of 576 keys on mma.sync: the narrow copies
    # or the wide instance); launches: the wrapper's at that head shape over
    # every main path of this run
    H, Hkv = ANY_TIMED
    for D in ANY_HEAD_DIMS:
        for name, t, source, line in (
                ("flash_attention", fa_timing[f"512_D{D}"],
                 "flash_attention.cu", "flash_attention.py:27"),
                ("decode_attention", dec_timing[f"D{D}"],
                 "decode_attention.cu", "decode_attention.py:26")):
            if name == "flash_attention":
                # bf16: the wgmma instance with narrow copies (D up to 256)
                # or the wide instance (past 256), never attention_any
                require_instance(
                    t["instances"], r"^flash_fwd_wgmma<\d+, true>$"
                    if D <= 256 else r"^flash_fwd_wide$", f"flash at D {D}")
            else:
                require_instance(t["instances"],
                                 decode_instance("bfloat16", D),
                                 f"flash-decode at D {D}")
            kernels.append({
                "name": f"{name}_D{D}", "route": "cuda",
                "source": f"src/repro_torch/csrc/{source}",
                "instance": t["instances"],
                "replaces": f"src/repro/kernels/{line}",
                "launches": SHAPE_LAUNCHES[f"{name} {H}/{Hkv}/{D}"],
                "launches_note": "the wrapper's launches at this head "
                "shape over every main path of this run (no model of the "
                "run has it)", "H": H, "Hkv": Hkv, "D": D,
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"], "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    # the expert FFN at FFN_ANY's widths (the tensor-core body's narrow
    # copies, slot_ffn_tc<..., true>), T 5 and T 512; launches: the stage's
    # at that width over every main path
    any_ffn = [(d, f, name, line, tm)
               for (d, f), tm in ffn_any.items()
               for name, line in (("cache_moe_gate_up", 28),
                                  ("cache_moe_down", 47))]
    any_ffn.append((*FFN_ANY[0], "cache_moe_up_gelu", 120, gelu_any))
    for d, f, name, line, tm in any_ffn:
        for T, suffix in ((BLOCK_T, ""), (CONC_PROMPT, f"_t{CONC_PROMPT}")):
            t = tm[T]["timing"][name]
            require_instance(t["instances"], r"^slot_ffn_tc<\d, \d+, \d, \d, "
                             r"true>$", f"{name} at d {d} / f {f}, T {T}")
            file = "cache_moe" if name.endswith("gelu") else "moe_gemm"
            kernels.append({
                "name": f"{name}_d{d}_f{f}{suffix}", "route": "cuda",
                "source": "src/repro_torch/csrc/cache_moe.cu",
                "instance": t["instances"],
                "replaces": f"src/repro/kernels/{file}.py:{line}",
                "launches": SHAPE_LAUNCHES[f"{name} d{d}/f{f}"],
                "launches_note": "the stage's launches at this width over "
                "every main path of this run (no model of the run has "
                "it)", "d": d, "f": f, "T": T,
                "max_abs_err": tm[T]["err"][name],
                "ms": t["ms"], "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "device_ms": t["device_ms"],
                "library_device_ms": t["library_device_ms"]})
    # the SSD scan past the served widths (chunk 256: phase 8b's path;
    # chunks 160 and 131, n 160 and 256: no model path); launches: the
    # wrapper's at that chunk and state width over every main path
    for model, h, p, n, chunk, lengths in SSD_SHAPES[2:]:
        S = lengths[0]
        t = ssd_timing[f"{model}_S{S}"]
        kernels.append({
            "name": f"ssd_scan_{model}_S{S}", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:26",
            "launches": SHAPE_LAUNCHES[f"ssd_scan chunk{chunk}/n{n}"],
            "launches_note": "the wrapper's launches at this chunk and "
            "state width over every main path of this run",
            "h": h, "p": p, "n": n, "chunk": chunk, "S": S,
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"], "device_ms": t["device_ms"],
            "kernels_per_call": t["kernels_per_call"]})
    # the SSD kernel at the shard shapes of phase 19 (one rank's sequence
    # of 32768 over 2 and 4 ranks); launches: each rank's, all equal
    for backend, n in SEQPAR_RUNS[1:]:
        S = SEQPAR_S // n
        t = seqpar_info["ssd_kernel_at_shard"][f"S{S}"]
        run = seqpar_info["runs"][f"{backend}{n}"]
        kernels.append({
            "name": f"ssd_scan_seqpar_S{S}", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:26",
            "launches": run["ssd_launches_per_rank"][0],
            "launches_per_rank": run["ssd_launches_per_rank"],
            "ranks": n, "S": S, "max_abs_err": t["max_abs_err"],
            "ms": t["ms"], "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
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
    print(json.dumps({"ssm_requests": mamba_reqs + c256_reqs + zamba_reqs,
                      "mamba2": mamba_info,
                      f"mamba2_chunk{SSM_CHUNK}": {
                          **c256_info, "prefill_ms_chunk128":
                          mamba_info["prefill_ms"]},
                      "zamba2": zamba_info}))
    print(json.dumps({"gelu_requests": gelu_info}))
    print(json.dumps({"dense_requests": dense_info}))
    print(json.dumps({"dense_targets": dense_targets}))
    print(json.dumps({"chaos_requests": chaos_info}))
    print(json.dumps({"train": train_info}))
    print(json.dumps({"whisper": whisper_info}))
    print(json.dumps({"seqpar": seqpar_info}))
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
        "phi-3.5-moe": graphs_phi, "llama3.2-3b": graphs_dense,
        **graphs_targets}}))
    print(json.dumps({"memory": {
        "device_max_allocated_bytes": script_peak(),
        "child_processes": {
            name: info["process_peaks"] for name, info in (
                ("chaos", chaos_info), *dense_targets.items(),
                ("train", train_info), ("whisper", whisper_info),
                ("seqpar", seqpar_info))},
        "pinned_staging_bytes": {"tight": tight_info["pinned_staging_bytes"],
                                 "ample": ample_info["pinned_staging_bytes"]},
        "host_max_rss_bytes":
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024},
        "seconds": {"build": build_s, "model_init": init_s,
                    "engine_setup_tight": tight_info["setup_s"],
                    "engine_setup_ample": ample_info["setup_s"],
                    "total": time.perf_counter() - t_start}}))
    print(json.dumps({"profiler_fallbacks": PROFILER_FALLBACKS}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--phase"]:
        sys.exit(child_main(*sys.argv[2:]))
    sys.exit(main())
