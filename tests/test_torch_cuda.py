"""PyTorch port on a card: the hand-written CUDA kernels (expert FFN with
swiglu and gelu experts, also at deepseek-v2-lite-16b's widths and top-6
and at phi-3.5-moe's and phi-mini-moe's, flash attention, flash-decode, SSD
scan) against their plain versions, ``moe_global`` through the expert-FFN
kernel with no host sync, the offload engine serving through them (mixtral,
deepseek, and phi with its MoE draft), solo and in
fused cross-session rounds, a dense target served greedy and speculatively
through flash-decode, the SSD families' models on the card against
themselves on the CPU, and captured steps (a replay's kernels in a trace, a
capture that fails).  Every test is
marked ``cuda`` and skips without a card (the kernels have no CPU mode).
This file imports nothing of JAX, so it also runs where JAX is not
installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math
import re
import sys
import time

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models.registry import build_model

pytestmark = pytest.mark.cuda


def _traced(fn, pattern: str):
    """``fn()`` under a ``torch.profiler`` trace of the device: (its result,
    the device kernels whose names match ``pattern``).  A replayed CUDA
    graph runs its kernels without calling their wrappers, so a trace is
    where they are counted.  The window is padded on the host at both ends:
    the profiler drops a kernel that lies at its very edge."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    return out, sum(1 for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and re.search(pattern, e.name))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_kernel_matches_plain_and_is_batch_invariant(cuda, dtype, tol):
    """The kernel against its plain version (tolerance relative to the
    output's scale: f32 differs only in summation order, bf16 in where it
    rounds), and each row of a 5-token call bit-identical to the same row
    alone."""
    gen = torch.Generator(cuda).manual_seed(0)
    S, d, f = 12, 512, 1024
    wg, wu = [(torch.randn((S, d, f), generator=gen, device=cuda)
               * d ** -0.5).to(dtype) for _ in range(2)]
    wd = (torch.randn((S, f, d), generator=gen, device=cuda)
          * f ** -0.5).to(dtype)
    x = torch.randn((5, d), generator=gen, device=cuda).to(dtype)
    si = torch.randint(-1, S, (5, 2), generator=gen, device=cuda
                       ).to(torch.int32)
    w = torch.rand((5, 2), generator=gen, device=cuda).to(dtype)
    before = K.gate_up.launches
    got = K.cache_moe(x, si, w, wu, wd, wg)
    assert K.gate_up.launches == before + 1
    want = R.cache_moe_ref(x, si, w, wu, wd, wg)
    scale = want.float().abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    for t in range(5):
        one = K.cache_moe(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd, wg)
        assert torch.equal(one, got[t:t + 1])


def test_kernel_refuses_what_it_does_not_take(cuda):
    g = K.slot_groups(torch.zeros((2, 2), dtype=torch.int32, device=cuda), 4)
    x = torch.zeros((2, 64), dtype=torch.float16, device=cuda)
    w = torch.zeros((4, 64, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        K.gate_up(x, g, w, w)
    with pytest.raises(TypeError):
        K.up_gelu(x, g, w)
    with pytest.raises(ValueError):
        K.up_gelu(x.float(), g, w.float()[:, :32])   # wu's d is not x's


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_gelu_route_matches_plain_and_is_batch_invariant(cuda, dtype, tol):
    """Gelu experts (``wg=None``): the up-gelu and down kernels against
    their plain versions, stage by stage and through ``cache_moe``
    (tolerance relative to the output's scale, as the swiglu route), and
    each row of a 5-token call bit-identical to the same row alone."""
    gen = torch.Generator(cuda).manual_seed(1)
    S, d, f = 12, 512, 1024
    wu = (torch.randn((S, d, f), generator=gen, device=cuda)
          * d ** -0.5).to(dtype)
    wd = (torch.randn((S, f, d), generator=gen, device=cuda)
          * f ** -0.5).to(dtype)
    x = torch.randn((5, d), generator=gen, device=cuda).to(dtype)
    si = torch.randint(-1, S, (5, 2), generator=gen, device=cuda
                       ).to(torch.int32)
    w = torch.rand((5, 2), generator=gen, device=cuda).to(dtype)
    g = K.slot_groups(si, S)
    before = K.up_gelu.launches, K.gate_up.launches
    h = K.up_gelu(x, g, wu)
    h_ref = R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot, g.grp_start,
                               g.grp_count)
    got = K.cache_moe(x, si, w, wu, wd, None)
    assert (K.up_gelu.launches, K.gate_up.launches) == \
        (before[0] + 2, before[1])
    want = R.cache_moe_ref(x, si, w, wu, wd, None)
    for a, b in ((h, h_ref), (got, want)):
        assert torch.isfinite(a).all()
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
    for t in range(5):
        one = K.cache_moe(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd, None)
        assert torch.equal(one, got[t:t + 1])


ROWS_PER_SLOT = (1, 7, 8, 9, 64, 127, 128, 129, 255, 256, 257, 512)


@pytest.mark.parametrize("rows", ROWS_PER_SLOT)
@pytest.mark.parametrize("S,d,f", [(12, 200, 328), (32, 136, 72)])
@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ffn_bodies_match_plain_and_are_batch_invariant(cuda, rows, S, d, f,
                                                        gelu, dtype, tol):
    """Both stages at ``rows`` rows on one slot (the tensor-core body's
    warpgroup and pass edges: 128 rows a warpgroup, 256 a pass), every
    token's second choice a miss or another slot, token 1's a repeat of
    its first (one row more), pools of 12 and 32, and d, f that are not
    multiples of the 64-wide tiles: each stage against its plain version
    (tolerance relative to the output's scale, as the routes above), and
    each row of the call through ``cache_moe`` bit-identical to the same
    token alone."""
    gen = torch.Generator(cuda).manual_seed(rows)
    wg = None if gelu else (torch.randn((S, d, f), generator=gen,
                                        device=cuda) * d ** -0.5).to(dtype)
    wu = (torch.randn((S, d, f), generator=gen, device=cuda)
          * d ** -0.5).to(dtype)
    wd = (torch.randn((S, f, d), generator=gen, device=cuda)
          * f ** -0.5).to(dtype)
    x = torch.randn((rows, d), generator=gen, device=cuda).to(dtype)
    si = torch.full((rows, 2), 3, dtype=torch.int32, device=cuda)
    other = torch.randint(-1, S - 1, (rows,), generator=gen, device=cuda)
    si[:, 1] = torch.where(other >= 3, other + 1, other).to(torch.int32)
    if rows > 1:
        si[1, 1] = 3
    w = torch.rand((rows, 2), generator=gen, device=cuda).to(dtype)
    g = K.slot_groups(si, S)
    h = K.up_gelu(x, g, wu) if gelu else K.gate_up(x, g, wg, wu)
    h_ref = R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot, g.grp_start,
                               g.grp_count) if gelu else \
        R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot, g.grp_start,
                           g.grp_count)
    y = K.down(h, g, wd)
    y_ref = R.slot_down_ref(h, wd, g.grp_slot, g.grp_start, g.grp_count)
    for a, b in ((h, h_ref), (y, y_ref)):
        assert torch.isfinite(a).all()
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
    full = K.cache_moe(x, si, w, wu, wd, wg)
    for t in range(rows):
        one = K.cache_moe(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd, wg)
        assert torch.equal(one, full[t:t + 1])


@pytest.mark.parametrize("T", [1, 5, 64, 512])
@pytest.mark.parametrize("S", [48, 192])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ffn_at_deepseek_widths_top6(cuda, T, S, dtype, tol):
    """deepseek-v2-lite-16b's experts (d 2048, f 1408: 22 tiles of 64
    columns) at top-6 over pools of 48 and 192 slots: T 5 is a verify block
    (30 rows, the small block shape), T 64 and 512 take the large one.
    Each token routes to 6 distinct slots, token 0's first choice a miss.
    Both stages and ``cache_moe`` against their plain versions (tolerance
    relative to the output's scale, as above), and each row of the call
    bit-identical to the same token alone (batch invariance)."""
    d, f, k = 2048, 1408, 6
    gen = torch.Generator(cuda).manual_seed(T + S)
    wg, wu = [(torch.randn((S, d, f), generator=gen, device=cuda)
               * d ** -0.5).to(dtype) for _ in range(2)]
    wd = (torch.randn((S, f, d), generator=gen, device=cuda)
          * f ** -0.5).to(dtype)
    x = torch.randn((T, d), generator=gen, device=cuda).to(dtype)
    si = torch.rand((T, S), generator=gen, device=cuda).argsort(dim=1)[
        :, :k].to(torch.int32).contiguous()
    si[0, 0] = -1
    w = torch.rand((T, k), generator=gen, device=cuda).to(dtype)
    g = K.slot_groups(si, S)
    h = K.gate_up(x, g, wg, wu)
    h_ref = R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot,
                               g.grp_start, g.grp_count)
    y = K.down(h, g, wd)
    y_ref = R.slot_down_ref(h, wd, g.grp_slot, g.grp_start, g.grp_count)
    full = K.cache_moe(x, si, w, wu, wd, wg)
    want = R.cache_moe_ref(x, si, w, wu, wd, wg)
    for a, b in ((h, h_ref), (y, y_ref), (full, want)):
        assert torch.isfinite(a).all()
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
    for t in range(T):
        one = K.cache_moe(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd, wg)
        assert torch.equal(one, full[t:t + 1])


@pytest.mark.parametrize("T", [1, 5, 512])
@pytest.mark.parametrize("f", [6400, 960])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ffn_at_phi_widths(cuda, T, f, dtype, tol):
    """phi-3.5-moe's experts (d 4096, f 6400) and phi-mini-moe's (f 960:
    15 tiles of 64 columns, 7.5 of 128) at top-2 over a 16-slot pool: T 1
    is a draft step, T 5 a verify block (the small block shape), T 512 a
    prefill block (the large one).  Both stages and ``cache_moe`` against
    their plain versions (tolerance relative to the output's scale, as
    above), and each row of the call bit-identical to the same token alone
    (batch invariance)."""
    S, d, k = 16, 4096, 2
    gen = torch.Generator(cuda).manual_seed(T + f)
    wg, wu = [(torch.randn((S, d, f), generator=gen, device=cuda)
               * d ** -0.5).to(dtype) for _ in range(2)]
    wd = (torch.randn((S, f, d), generator=gen, device=cuda)
          * f ** -0.5).to(dtype)
    x = torch.randn((T, d), generator=gen, device=cuda).to(dtype)
    si = torch.rand((T, S), generator=gen, device=cuda).argsort(dim=1)[
        :, :k].to(torch.int32).contiguous()
    if T > 1:
        si[0, 0] = -1
    w = torch.rand((T, k), generator=gen, device=cuda).to(dtype)
    g = K.slot_groups(si, S)
    h = K.gate_up(x, g, wg, wu)
    h_ref = R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot,
                               g.grp_start, g.grp_count)
    y = K.down(h, g, wd)
    y_ref = R.slot_down_ref(h, wd, g.grp_slot, g.grp_start, g.grp_count)
    full = K.cache_moe(x, si, w, wu, wd, wg)
    want = R.cache_moe_ref(x, si, w, wu, wd, wg)
    for a, b in ((h, h_ref), (y, y_ref), (full, want)):
        assert torch.isfinite(a).all()
        scale = b.float().abs().max().item()
        assert (a.float() - b.float()).abs().max().item() <= tol * scale
    for t in range(T):
        one = K.cache_moe(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd, wg)
        assert torch.equal(one, full[t:t + 1])


@pytest.mark.parametrize("T", [1, 5])
def test_moe_global_on_the_card_makes_no_host_sync(cuda, T):
    """An MoE layer at phi-mini-moe's widths (d 4096, 16 experts top-2 of
    width 960), bf16: ``moe_global`` over T tokens (a draft step, a verify
    block) runs with CUDA sync debugging set to raise, so any device->host
    readback fails the test; each stage launches once, and the result holds
    ``moe_ref`` (relative to its scale: 2e-2, the bf16 tolerance above)."""
    from repro_torch.configs.registry import get_draft_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer import MoE
    cfg = get_draft_config("phi-3.5-moe")
    gen = torch.Generator(cuda).manual_seed(3)
    p = MoE(cfg, torch.bfloat16, cuda, gen, cuda)
    x = torch.randn((1, T, cfg.d_model), generator=gen, device=cuda
                    ).to(torch.bfloat16)
    MOE.moe_global(p, x, cfg)                  # builds and loads the kernels
    torch.cuda.synchronize()
    before = (K.gate_up.launches, K.down.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = MOE.moe_global(p, x, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert (K.gate_up.launches, K.down.launches) == \
        (before[0] + 1, before[1] + 1)
    want = MOE.moe_ref(p, x, cfg)
    scale = want.float().abs().max().item()
    assert torch.isfinite(y).all()
    assert (y.float() - want.float()).abs().max().item() <= 2e-2 * scale


@pytest.mark.parametrize("slots", [6, 32])
def test_phi_engine_on_the_card_matches_its_greedy(cuda, slots):
    """Reduced phi-3.5-moe in f32 with its MoE draft (the launcher's
    ``reduced_pair``), ``attn_impl="kernel"``, served sd x spmoe with a
    tight and an ample cache: the port's greedy tokens; every draft step
    runs the draft's MoE layers through the expert-FFN kernel (at least one
    gate_up kernel per draft layer per drafted token, counted in a trace of
    the device, since the draft steps are replays) and its attention
    through flash-decode."""
    from repro_torch.launch.serve import reduced_pair
    cfg, dcfg = (dataclasses.replace(c, attn_impl="kernel")
                 for c in reduced_pair("phi-3.5-moe"))
    target = build_model(cfg, cuda, seed=0)
    draft = build_model(dcfg, cuda, seed=1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 6),
                           generator=torch.Generator().manual_seed(2))
    ref = greedy_generate(target, prompt.to(cuda), 16, 64).tolist()
    before = DA.decode_attention.launches
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=slots,
                             draft_len=3, max_seq=64),
                target, draft) as eng:
        res, gate_ups = _traced(
            lambda: eng.submit(Request(prompt=prompt, max_new_tokens=16)),
            r"\bslot_ffn(<[^,<>]+, 1>|_tc<1,)")
        assert eng.runtime.cache.check_invariants()
    assert res.tokens == ref
    assert res.metrics.drafted > 0
    assert gate_ups >= res.metrics.drafted * dcfg.num_layers
    assert DA.decode_attention.launches > before


def test_ffn_refuses_bf16_rows_it_cannot_copy(cuda):
    """The tensor-core body copies 16-byte pieces of each row: bf16 rows of
    d or f elements need d and f to be multiples of 8."""
    g = K.slot_groups(torch.zeros((2, 2), dtype=torch.int32, device=cuda), 4)
    x = torch.zeros((2, 60), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((4, 60, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        K.gate_up(x, g, w, w)
    h = torch.zeros((4, 60), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        K.down(h, g, torch.zeros((4, 60, 64), dtype=torch.bfloat16,
                                 device=cuda))


@pytest.mark.parametrize("H,Hkv,D,S,lengths,splits", [
    (24, 8, 128, 576, (1, 77, 543), 9),        # llama3.2-3b widths
    (32, 8, 128, 4112, (4096, 64, 65), 13),    # mixtral draft, long cache
    (32, 8, 128, 4096, (4096, 1, 4095), 16),   # the most splits
    (8, 2, 128, 64, (64, 1, 33), 1),           # one split
    (8, 2, 64, 100, (100, 3, 64), 2),          # S not a multiple of a split
    (4, 4, 16, 40, (40, 1, 17), 1),            # reduced widths
    (16, 1, 32, 200, (200, 1, 129), 4),        # 16 q heads per kv head
    (32, 1, 32, 130, (129, 130, 2), 3),        # MQA, 32 q heads per kv head
    (32, 32, 112, 576, (543, 1, 77), 9),       # zamba2-7b's shared block
    (40, 2, 112, 100, (100, 3, 64), 2),        # D 112, 20 q heads per kv
    (96, 8, 192, 300, (300, 1, 129), 5),       # nemotron-4-340b's heads
    (48, 1, 128, 4112, (4096, 64, 65), 13),    # granite-20b's 48 : 1
    (48, 1, 192, 200, (200, 1, 129), 4),       # 48 : 1 at D 192
])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
def test_decode_kernel_matches_plain_and_is_batch_invariant(
        cuda, H, Hkv, D, S, lengths, splits, dtype, atol):
    """The flash-decode kernel against ``ref.decode_attention_ref`` with
    the reference's own tolerances (tests/test_kernels.py: f32 2e-5, bf16
    2e-2, rtol 1e-2): f32 differs in summation order, bf16 also in that the
    plain version rounds the scores and p to bf16 before the softmax's max
    and the kernel rounds p only.  Each row of a 3-row call equals the same
    row alone, bit for bit; keys past a row's length are never read; the
    cache splits into as many cluster blocks as S alone sets."""
    assert DA._lib().decode_attention_splits(S) == splits
    gen = torch.Generator(cuda).manual_seed(2)
    q = torch.randn((3, H, D), generator=gen, device=cuda).to(dtype)
    k, v = [torch.randn((3, S, Hkv, D), generator=gen, device=cuda
                        ).to(dtype) for _ in range(2)]
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = DA.decode_attention.launches
    got = ops.decode_attention(q, k, v, lens)
    assert DA.decode_attention.launches == before + 1
    want = R.decode_attention_ref(q, k, v, lens)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=1e-2)
    for b in range(3):
        one = ops.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                   lens[b:b + 1])
        assert torch.equal(one, got[b:b + 1])
    # what lies past the lengths does not matter
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:] = float("nan")
        v2[b, n:] = float("nan")
    assert torch.equal(ops.decode_attention(q, k2, v2, lens), got)


@pytest.mark.parametrize("H,Hkv,D", [(24, 8, 128),
                                     (32, 32, 112)])   # zamba2-7b's
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_kernel_replays_in_a_cuda_graph(cuda, dtype, H, Hkv, D):
    """One flash-decode call captured in a CUDA graph: its launch shape is
    fixed by S, so a replay after ``lengths`` changed in place equals the
    eager call at the new lengths, bit for bit, and allocates nothing."""
    gen = torch.Generator(cuda).manual_seed(3)
    q = torch.randn((2, H, D), generator=gen, device=cuda).to(dtype)
    k, v = [torch.randn((2, 576, Hkv, D), generator=gen, device=cuda
                        ).to(dtype) for _ in range(2)]
    lens = torch.tensor([100, 7], dtype=torch.int32, device=cuda)
    DA.decode_attention(q, k, v, lens)          # build, encode, set up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DA.decode_attention(q, k, v, lens)
    for new in ((1, 576), (543, 64), (576, 1), (65, 300)):
        lens.copy_(torch.tensor(new, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = DA.decode_attention(q, k, v, lens.clone())
        assert torch.equal(out, want)


def test_decode_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros((1, 4, 16), device=cuda)
    k = torch.zeros((1, 8, 2, 16), device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        DA.decode_attention(q.half(), k.half(), k.half(), lens)
    with pytest.raises(TypeError):
        DA.decode_attention(q, k.bfloat16(), k, lens)
    with pytest.raises(ValueError):                  # head dim 24
        DA.decode_attention(torch.zeros((1, 4, 24), device=cuda),
                            torch.zeros((1, 8, 2, 24), device=cuda),
                            torch.zeros((1, 8, 2, 24), device=cuda), lens)
    with pytest.raises(ValueError):                  # 3 heads over 2
        DA.decode_attention(torch.zeros((1, 3, 16), device=cuda), k, k,
                            lens)
    with pytest.raises(ValueError):                  # 64 q heads per kv
        DA.decode_attention(torch.zeros((1, 64, 16), device=cuda),
                            k[:, :, :1], k[:, :, :1], lens)
    with pytest.raises(ValueError):                  # int64 lengths
        DA.decode_attention(q, k, k, lens.long())
    with pytest.raises(ValueError):                  # one length per row
        DA.decode_attention(q, k, k, torch.ones(2, dtype=torch.int32,
                                                device=cuda))
    with pytest.raises(ValueError):                  # D not unit stride
        DA.decode_attention(q, k.transpose(2, 3).contiguous()
                            .transpose(2, 3), k, lens)


@pytest.mark.parametrize("decode", ["greedy", "sd"])
def test_dense_engine_on_the_card_matches_its_greedy(cuda, decode):
    """Reduced llama3.2-3b in f32 under ``attn_impl="kernel"``, served
    through ``Engine`` (greedy x none, and sd x none with the derived
    half-depth draft): the port's greedy tokens, with every one-token step
    of the target (greedy) or the draft (sd) through flash-decode, one
    launch per layer."""
    cfg = dataclasses.replace(
        get_config("llama3.2-3b").reduced(dtype="float32"),
        attn_impl="kernel")
    target = build_model(cfg, cuda, seed=0)
    prompt = torch.randint(0, cfg.vocab_size, (1, 12),
                           generator=torch.Generator().manual_seed(2))
    ref = greedy_generate(target, prompt.to(cuda), 16, 64).tolist()
    before = DA.decode_attention.launches
    with Engine(EngineConfig(model=cfg, decode=decode, draft_len=3,
                             max_seq=64), target, seed=0, draft_seed=1,
                device=cuda) as eng:
        res = eng.submit(Request(prompt=prompt, max_new_tokens=16))
        layers = (eng.draft or target).cfg.num_layers
    assert res.tokens == ref
    launches = DA.decode_attention.launches - before
    assert launches > 0 and launches % layers == 0


@pytest.mark.parametrize("slots", [6, 32])
def test_engine_on_the_card_matches_its_greedy(cuda, slots):
    """sd x spmoe through the CUDA kernel (tight and ample cache) emits the
    port's greedy tokens; reduced mixtral in f32 with a window longer than
    the prompt."""
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, cuda, seed=0)
    draft = build_model(dcfg, cuda, seed=1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 6),
                           generator=torch.Generator().manual_seed(2))
    ref = greedy_generate(target, prompt.to(cuda), 16, 64).tolist()
    before = K.gate_up.launches
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=slots,
                             draft_len=3, max_seq=64),
                target, draft) as eng:
        res = eng.submit(Request(prompt=prompt, max_new_tokens=16))
        assert eng.runtime.cache.check_invariants()
    assert res.tokens == ref
    assert K.gate_up.launches > before


@pytest.mark.parametrize("slots", [6, 16])
def test_deepseek_engine_on_the_card_matches_its_greedy(cuda, slots):
    """Reduced deepseek-v2-lite-16b in f32 (a leading dense layer, MLA, a
    shared expert) served sd x spmoe through the CUDA kernel with a tight
    and an ample cache emits the port's greedy tokens; MLA launches no
    attention kernel, under ``attn_impl="kernel"`` too."""
    cfg = dataclasses.replace(
        get_config("deepseek-v2-lite-16b").reduced(dtype="float32",
                                                   num_layers=3),
        attn_impl="kernel")
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, cuda, seed=0)
    draft = build_model(dcfg, cuda, seed=1)
    prompt = torch.randint(0, cfg.vocab_size, (1, 6),
                           generator=torch.Generator().manual_seed(2))
    ref = greedy_generate(target, prompt.to(cuda), 16, 64).tolist()
    before = (K.gate_up.launches, K.down.launches,
              FA.flash_attention.launches, DA.decode_attention.launches)
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=slots,
                             draft_len=3, max_seq=64),
                target, draft) as eng:
        res = eng.submit(Request(prompt=prompt, max_new_tokens=16))
        assert eng.runtime.cache.check_invariants()
    assert res.tokens == ref
    after = (K.gate_up.launches, K.down.launches,
             FA.flash_attention.launches, DA.decode_attention.launches)
    assert after[0] > before[0] and after[1] > before[1]
    assert after[2:] == before[2:]


def test_deepseek_fused_round_equals_solo_blocks_on_the_card(cuda):
    """One all-hit fused round of reduced deepseek in bf16 (the dense layer
    and the shared expert per session) gives each session the logits of
    its solo fast block on the same cache snapshot, bit for bit."""
    cfg = get_config("deepseek-v2-lite-16b").reduced(dtype="bfloat16",
                                                     num_layers=3)
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, cuda, seed=0)
    draft = build_model(dcfg, cuda, seed=1)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen)
               for n in (6, 9)]
    slots = cfg.num_moe_layers * cfg.num_experts
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=slots,
                             draft_len=3, max_seq=64), target, draft) as eng:
        rt = eng.runtime
        every = [(l, e) for l in range(rt.store.num_layers)
                 for e in range(rt.store.num_experts)]
        rt.cache.insert(every, rt.store.fetch(every))
        sts = [rt.start_session(p.to(cuda), 8) for p in prompts]
        blocks = [torch.cat([st.cur, torch.randint(
            0, cfg.vocab_size, (1, n), generator=gen).to(cuda)], dim=1)
            for st, n in zip(sts, (4, 2))]

        def caches():
            return [{s: [{n: t.clone() for n, t in c.items()}
                         for c in st.tcache[s]]
                     for s in ("dense_layers", "layers")} for st in sts]

        solo = [[o[0] for o in rt._fast_body([b], [st.pos], [tc],
                                             [st.history_dev])]
                for b, st, tc in zip(blocks, sts, caches())]
        logits, ok, _, _ = rt._fast_body(
            blocks, [st.pos for st in sts], caches(),
            [st.history_dev for st in sts])
        torch.cuda.synchronize()
        for st in sts:
            rt.finish_session(st)
    assert bool(ok.all())
    for j, (lg, ok1, _, _) in enumerate(solo):
        assert bool(ok1)
        assert torch.equal(logits[j], lg)


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,window", [
    (1, 256, 256, 32, 8, 128, None),     # mixtral heads, causal
    (2, 96, 160, 8, 2, 64, 48),          # GQA, kv longer, window, ragged
    (1, 64, 64, 4, 4, 16, 7),            # reduced head dim, small window
    (1, 128, 512, 8, 2, 128, None),      # right-aligned queries, Sq < Skv
    (1, 256, 256, 8, 8, 64, 40),         # a window under one 128-key tile
    (1, 64, 64, 8, 8, 128, None),        # S 64: one part-filled tile
    (1, 384, 384, 8, 4, 128, None),      # S 128 + 128 k
    (1, 256, 256, 4, 2, 32, None),       # D 32
    (1, 256, 256, 24, 8, 128, None),     # llama3.2-3b heads, 24 / 8
    (1, 256, 256, 32, 32, 112, None),    # zamba2-7b's shared block, D 112
    (2, 96, 160, 8, 2, 112, 48),         # D 112, window, ragged
    (1, 384, 384, 16, 2, 192, None),     # D 192: 64-key tiles
    (1, 256, 256, 8, 8, 192, 40),        # D 192, a window
    (1, 128, 512, 8, 1, 192, None),      # D 192, Sq < Skv
    (1, 256, 256, 48, 1, 128, None),     # granite-20b's 48 : 1
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_kernel_matches_plain(cuda, B, Sq, Skv, H, Hkv, D, window,
                                    dtype, tol):
    """Tolerance relative to each query row's own max |out| (a row that
    sees many keys has a small output): f32 differs only in summation
    order, bf16 in where p is rounded and the output's one rounding (one
    bf16 step is up to 2^-7 of an element).  The plain version's blocks
    must divide the lengths."""
    gen = torch.Generator(cuda).manual_seed(0)
    q = torch.randn((B, Sq, H, D), generator=gen, device=cuda).to(dtype)
    k, v = [torch.randn((B, Skv, Hkv, D), generator=gen, device=cuda
                        ).to(dtype) for _ in range(2)]
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=True, window=window,
                             block_q=32, block_k=32)
    assert FA.flash_attention.launches == before + 1
    want = R.flash_attention_ref(q, k, v, causal=True, window=window,
                                 block_q=32, block_k=32)
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    assert torch.isfinite(got).all()
    assert bool((err <= tol * scale).all())


def test_fused_round_logits_equal_solo_fast_blocks_on_the_card(cuda):
    """One all-hit fused round (reduced mixtral in bf16, flash-attention
    draft prefill) gives each session the logits of its solo fast block on
    the same cache snapshot, bit for bit."""
    cfg = dataclasses.replace(
        get_config("mixtral-8x7b").reduced(dtype="bfloat16"),
        attn_impl="kernel")
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, cuda, seed=0)
    draft = build_model(dcfg, cuda, seed=1)
    gen = torch.Generator().manual_seed(2)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen)
               for n in (6, 9)]
    slots = cfg.num_moe_layers * cfg.num_experts
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=slots,
                             draft_len=3, max_seq=64), target, draft) as eng:
        rt = eng.runtime
        every = [(l, e) for l in range(rt.store.num_layers)
                 for e in range(rt.store.num_experts)]
        rt.cache.insert(every, rt.store.fetch(every))
        sts = [rt.start_session(p.to(cuda), 8) for p in prompts]
        blocks = [torch.cat([st.cur, torch.randint(
            0, cfg.vocab_size, (1, n), generator=gen).to(cuda)], dim=1)
            for st, n in zip(sts, (3, 2))]

        def caches():
            return [{"layers": [{n: t.clone() for n, t in c.items()}
                                for c in st.tcache["layers"]]}
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
    assert bool(ok.all())
    for j, (lg, ok1, _, _) in enumerate(solo):
        assert bool(ok1)
        assert torch.equal(logits[j], lg)


def _ssd_inputs(dev, b, s, h, p, n, dtype, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # dt log-uniform in [1e-3, 1e-1] and A = -(1..h), as a mamba layer
    # starts: slow heads carry the state across chunks, fast ones forget it
    u = torch.rand((b, s, h), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    A = -torch.arange(1, h + 1, dtype=torch.float32, device=dev)
    x = rnd(b, s, h, p).to(dtype)
    return x, dt, A, rnd(b, s, n).to(dtype), rnd(b, s, n).to(dtype)


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 8, 16, 16),               # reduced widths, p below a tile
    (1, 77, 4, 64, 128, 77),             # mamba2 widths, Q not a power of 2
    (1, 384, 5, 64, 64, 128),            # zamba2 widths, carried state
    (1, 2048, 48, 64, 128, 128),         # mamba2-780m: 16 chunks; slow
                                         # heads carry the state across all
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_ssd_kernel_matches_plain(cuda, b, s, h, p, n, chunk, dtype, tol):
    """y and the final state against ``ref.ssd_ref`` on the same inputs,
    relative to each output's max |value|.  Both compute in f32 from the
    same values; f32 differs in summation order and in how the prefix sums
    of dt·A are taken, bf16 also in y's one rounding (2^-8 of an element).
    The state is f32 in both types."""
    x, dt, A, B, C = _ssd_inputs(cuda, b, s, h, p, n, dtype)
    before = SSD.ssd_scan.launches
    y, state = SSD.ssd_scan(x, dt, A, B, C, chunk)
    assert SSD.ssd_scan.launches == before + 1
    y_ref, state_ref = R.ssd_ref(x, dt, A, B, C, chunk)
    assert y.dtype == dtype and state.dtype == torch.float32
    for got, want, t in ((y, y_ref, tol), (state, state_ref, 1e-4)):
        assert torch.isfinite(got).all()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= t * want.float().abs().max().item()


def test_ssd_kernel_is_deterministic_and_chunk_0_stands_alone(cuda):
    """Two identical calls give identical bits (no atomics in any sum), and
    the first chunk's rows of y from an S 512 call equal an S 128 call on
    the same rows bit for bit: chunk 0 reads nothing of later chunks."""
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 512, 48, 64, 128, torch.bfloat16)
    y1, s1 = SSD.ssd_scan(x, dt, A, B, C, 128)
    y2, s2 = SSD.ssd_scan(x, dt, A, B, C, 128)
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    head = [t[:, :128].contiguous() for t in (x, dt, B, C)]
    y0, _ = SSD.ssd_scan(head[0], head[1], A, head[2], head[3], 128)
    assert torch.equal(y1[:, :128], y0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_replays_in_a_cuda_graph(cuda, dtype):
    """One call captured in a CUDA graph (its launches' shapes depend on the
    shapes alone, its scratch comes from the graph's pool): replayed after
    new inputs are copied in place, it equals the eager call bit for bit."""
    shape = (1, 384, 8, 64, 128)
    ins = list(_ssd_inputs(cuda, *shape, dtype, seed=1))
    SSD.ssd_scan(*ins, 128)                      # build, set up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y, state = SSD.ssd_scan(*ins, 128)
    for seed in (2, 3):
        for dst, src in zip(ins, _ssd_inputs(cuda, *shape, dtype,
                                             seed=seed)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want_y, want_state = SSD.ssd_scan(*ins, 128)
        assert torch.equal(y, want_y) and torch.equal(state, want_state)


def test_ssd_kernel_padding_leaves_the_state_unchanged(cuda):
    """S = 300 padded to 384 with dt = 0 (as ``mamba_forward`` pads) gives
    the state of the unpadded sequence in chunks of 100."""
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 300, 4, 64, 64, torch.float32)
    pad = [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, 84))
           for t in (x, dt, B, C)]
    y, state = ops.ssd(pad[0], pad[1], A, pad[2], pad[3], 128)
    y_ref, state_ref = R.ssd_ref(x, dt, A, B, C, 100)
    for got, want in ((y[:, :300], y_ref), (state, state_ref)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item()


def test_ssd_kernel_refuses_what_it_does_not_take(cuda):
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 64, 2, 16, 16, torch.float32)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt, A, B, C, 24)              # 64 % 24
    x2, dt2, A2, B2, C2 = _ssd_inputs(cuda, 1, 256, 2, 16, 16,
                                      torch.float32)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x2, dt2, A2, B2, C2, 256)        # chunk > 128
    with pytest.raises(TypeError):
        SSD.ssd_scan(x.half(), dt, A, B.half(), C.half(), 16)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x, dt.bfloat16(), A, B, C, 16)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     B, C, 16)
    wide = torch.zeros((1, 64, 256), device=cuda)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt, A, wide, wide, 16)       # n > 128


@pytest.mark.parametrize("arch,over", [
    ("mamba2-780m", {}), ("zamba2-7b", {}),
    ("zamba2-7b", {"num_layers": 7, "attn_every": 3}),   # a tail block
    # the shared block at zamba2-7b's head dim through flash and
    # flash-decode on the card, their plain versions on the CPU
    ("zamba2-7b", {"head_dim": 112, "attn_impl": "kernel"}),
])
def test_ssd_models_on_the_card_match_the_cpu(cuda, arch, over):
    """Reduced f32 models, the same weights on both devices: the prefill
    (chunked kernel on the card, ``ssd_ref`` on the CPU; a 40-token prompt
    is padded to 48 in chunks of 16) and four recurrent decode steps give
    the same logits, and greedy serving through ``Engine`` emits the same
    tokens."""
    cfg = get_config(arch).reduced(dtype="float32", **over)
    cpu = build_model(cfg, "cpu", seed=0)
    gpu = build_model(cfg, cuda, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    prompt = torch.randint(0, cfg.vocab_size, (1, 40),
                           generator=torch.Generator().manual_seed(2))
    before = ops.ssd.launches
    lc, cc = cpu.prefill(prompt, 64)
    lg, cg = gpu.prefill(prompt.to(cuda), 64)
    assert ops.ssd.launches - before == cfg.num_layers - \
        (cfg.num_layers // cfg.attn_every if cfg.family == "hybrid" else 0)
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
    tok = torch.argmax(lc, -1)[:, None]
    for pos in range(40, 44):
        lc, cc, _ = cpu.decode_step(cc, tok, pos)
        lg, cg, _ = gpu.decode_step(cg, tok.to(cuda), pos)
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
        tok = torch.argmax(lc[:, -1], -1)[:, None]
    config = EngineConfig(model=cfg, decode="greedy", max_seq=64)
    want = Engine(config, cpu).submit(Request(prompt=prompt,
                                              max_new_tokens=8)).tokens
    got = Engine(config, gpu).submit(Request(prompt=prompt,
                                             max_new_tokens=8)).tokens
    assert got == want


def test_launcher_serves_mamba2_on_the_card(cuda, capsys, monkeypatch):
    """``launch/serve.py --arch mamba2-780m --decode greedy`` with no
    ``--device``: the reduced model on the card, one SSD launch per layer of
    the prefill."""
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "mamba2-780m", "--decode", "greedy", "--tokens",
        "4", "--prompt-len", "40", "--stream"])
    before = ops.ssd.launches
    launcher.main()
    lines = capsys.readouterr().out.splitlines()
    assert [p.split(":")[0] for p in lines[0].split()] == ["req-0"] * 4
    assert "[req-0] finish=length" in lines
    assert ops.ssd.launches - before == \
        get_config("mamba2-780m").reduced().num_layers


def test_graph_set_replays_flash_decode_on_the_card(cuda):
    """A captured step (``core/graphs.py``) replays flash-decode with its
    length input copied in: each replay equals the plain version at that
    length.  The wrapper counts the build's eager warm-up alone (a call
    inside the capture launches nothing, a replay calls no wrapper), and a
    profiler trace sees one flash-decode kernel per replay besides it."""
    from repro_torch.core.graphs import GraphSet
    gen = torch.Generator(cuda).manual_seed(5)
    q = torch.randn((1, 8, 64), generator=gen, device=cuda)
    k = torch.randn((1, 96, 2, 64), generator=gen, device=cuda)
    v = torch.randn((1, 96, 2, 64), generator=gen, device=cuda)
    gs = GraphSet(cuda)
    n0 = DA.decode_attention.launches

    def run():
        for length in (5, 77, 96):
            got = gs.run(("decode",), lambda n: ops.decode_attention(
                q, k, v, n.reshape(1)), length)
            want = R.decode_attention_ref(q, k, v, torch.tensor(
                [length], dtype=torch.int32, device=cuda))
            torch.testing.assert_close(got, want, atol=2e-5, rtol=0)
    _, traced = _traced(run, r"\bdecode_(mma|fma)<")
    assert DA.decode_attention.launches - n0 == 1
    assert traced == 1 + 3
    assert gs.builds == {"decode": 1} and gs.runs == {"decode": 3}


def test_a_capture_that_fails_raises_on_the_card(cuda):
    """A body that reads a value back to the host cannot be captured: the
    build raises, keeps no step, and nothing runs it eagerly instead."""
    from repro_torch.core.graphs import GraphSet
    gs = GraphSet(cuda)
    x = torch.ones(4, device=cuda)
    with pytest.raises(RuntimeError):
        gs.run(("sync",), lambda t: t * t.sum().item(), x)
    assert ("sync",) not in gs and not gs.builds and not gs.runs
    torch.cuda.synchronize()
    assert torch.ones(2, device=cuda).sum().item() == 2
