"""PyTorch port on a card: the hand-written CUDA kernels (expert FFN with
swiglu and gelu experts, also at deepseek-v2-lite-16b's widths and top-6
and at phi-3.5-moe's and phi-mini-moe's, flash attention, flash-decode, SSD
scan; also past the served shapes: attention at any head dim and from
unaligned rows, the expert FFN at any width, the SSD scan at any chunk and
state width and from a given state) against their plain versions, and
what they still refuse, ``moe_global`` through the expert-FFN
kernel with no host sync, the offload engine serving through them (mixtral,
deepseek, and phi with its MoE draft), solo and in
fused cross-session rounds and under seeded I/O faults, back-to-back
staging through pinned buffers, the dense targets served greedy and
speculatively through flash-decode, the SSD families' models on the card against
themselves on the CPU, captured steps (a replay's kernels in a trace, a
capture that fails), ``ops.moe_gemm`` (the dense-layout entry point), a
train step on the card against the CPU (mixtral, the SSD families' plain
scan, whisper with frames), the attention kernels at whisper-medium's 16 /
16 x 64 and reduced whisper on the card against the CPU.  Every test is
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
    where they are counted.  The window is padded on the host at both ends,
    and a throwaway kernel runs first in it: the profiler drops a kernel
    that lies at its very edge, and has dropped the first kernel of a
    window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
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
    """float16 and mismatched shapes raise; any width is taken (d 60: bf16
    rows of 120 bytes run on the tensor-core body's narrow copies)."""
    g = K.slot_groups(torch.zeros((2, 2), dtype=torch.int32, device=cuda), 4)
    x = torch.zeros((2, 64), dtype=torch.float16, device=cuda)
    w = torch.zeros((4, 64, 64), dtype=torch.float16, device=cuda)
    with pytest.raises(TypeError):
        K.gate_up(x, g, w, w)
    with pytest.raises(TypeError):
        K.up_gelu(x, g, w)
    with pytest.raises(ValueError):
        K.up_gelu(x.float(), g, w.float()[:, :32])   # wu's d is not x's
    with pytest.raises(ValueError):                   # wu's d is not x's
        K.up_gelu(x.float(), g, torch.zeros((4, 32, 64), device=cuda))
    for dt in (torch.bfloat16, torch.float32):
        h = K.up_gelu(torch.zeros((2, 60), dtype=dt, device=cuda), g,
                      torch.zeros((4, 60, 60), dtype=dt, device=cuda))
        assert h.shape == (4, 60) and not h.any()


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
            r"\bslot_ffn(<[^,<>]+, 1, (true|false)>|_tc<1,)")
        assert eng.runtime.cache.check_invariants()
    assert res.tokens == ref
    assert res.metrics.drafted > 0
    assert gate_ups >= res.metrics.drafted * dcfg.num_layers
    assert DA.decode_attention.launches > before


def test_ffn_refuses_bf16_rows_it_cannot_copy(cuda):
    """bf16 rows are taken from any pointer now: an offset input row (2
    bytes in) or an offset pool at widths the TMA route takes runs the
    narrow copies and gives the aligned call's bits; rows of 60 / 68
    elements from an offset pointer too.  What is still refused: an f32
    pool that the FMA body reads in 16-byte pieces from an unaligned
    pointer."""
    gen = torch.Generator(cuda).manual_seed(3)
    si = torch.randint(0, 4, (6, 2), generator=gen, device=cuda
                       ).to(torch.int32)
    g = K.slot_groups(si, 4)
    bf = torch.bfloat16
    x = torch.randn((6, 64), generator=gen, device=cuda).to(bf)
    w = (torch.randn((4, 64, 64), generator=gen, device=cuda) / 8).to(bf)
    xa = torch.zeros((6 * 64 + 1,), dtype=bf, device=cuda)[1:].view(6, 64)
    xa.copy_(x)
    wa = torch.zeros((w.numel() + 1,), dtype=bf, device=cuda)[1:].view(
        w.shape)
    wa.copy_(w)
    assert K._route(xa, (wa,), 64, 64)[0] == "narrow"
    h = K.gate_up(x, g, w, w)
    assert torch.equal(K.gate_up(xa, g, wa, wa), h)
    assert torch.equal(K.down(h, g, wa), K.down(h, g, w))
    xu = torch.zeros((2 * 60 + 2,), dtype=bf, device=cuda)[2:].view(2, 60)
    wu = torch.randn((4, 60, 68), device=cuda).to(bf)
    g2 = K.slot_groups(si[:2], 4)
    h = K.gate_up(xu, g2, wu, wu)
    want = R.slot_gate_up_ref(xu, g2.row_tok, wu, wu, g2.grp_slot,
                              g2.grp_start, g2.grp_count)
    assert torch.equal(h, want)                   # zeros in, zeros out
    wf = torch.zeros((4 * 64 * 64 + 1,), device=cuda)[1:].view(4, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        K.down(x.float(), g, wf)


def _ffn_inputs(dev, d, f, T, S, seed, dtype=torch.bfloat16):
    gen = torch.Generator(dev).manual_seed(seed)
    wg, wu = [(torch.randn((S, d, f), generator=gen, device=dev)
               * d ** -0.5).to(dtype) for _ in range(2)]
    wd = (torch.randn((S, f, d), generator=gen, device=dev)
          * f ** -0.5).to(dtype)
    x = torch.randn((T, d), generator=gen, device=dev).to(dtype)
    si = torch.randint(-1, S, (T, 2), generator=gen, device=dev
                       ).to(torch.int32)
    w = torch.rand((T, 2), generator=gen, device=dev).to(dtype)
    return x, si, w, wg, wu, wd


@pytest.mark.parametrize("d,f,piece", [(36, 60, 8), (34, 58, 4),
                                       (37, 61, 2), (100, 204, 8)])
@pytest.mark.parametrize("T", [5, 512])
def test_ffn_narrow_copies_at_every_piece_width(cuda, d, f, piece, T):
    """bf16 widths the TMA ring cannot read, one per piece of the narrow
    copies (8, 4 and 2 bytes), swiglu and gelu experts at a verify block
    and a prefill block: the kernel takes the tensor-core body's narrow
    copies with the pieces ``_route`` names (``kernel_route``;
    chip_smoke.py names the kernel the profiler saw), and the stages match
    their plain versions (TOL 2e-2 of the largest |value|)."""
    x, si, w, wg, wu, wd = _ffn_inputs(cuda, d, f, T, 12, d + f)
    assert K._route(x, (wg, wu), d, f) == K.kernel_route(x, (wg, wu), d, f) \
        == ("narrow", piece, piece)
    g = K.slot_groups(si, 12)
    for call, want in (
            (lambda: K.gate_up(x, g, wg, wu),
             lambda: R.slot_gate_up_ref(x, g.row_tok, wg, wu, g.grp_slot,
                                        g.grp_start, g.grp_count)),
            (lambda: K.up_gelu(x, g, wu),
             lambda: R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot,
                                        g.grp_start, g.grp_count))):
        h = call()
        ref = want().float()
        assert torch.isfinite(h).all()
        assert (h.float() - ref).abs().max().item() <= \
            2e-2 * ref.abs().max().item()
    assert K.kernel_route(h, (wd,), f, d)[0] == "narrow"
    y = K.down(h, g, wd)
    ref = R.slot_down_ref(h, wd, g.grp_slot, g.grp_start, g.grp_count
                          ).float()
    assert (y.float() - ref).abs().max().item() <= \
        2e-2 * ref.abs().max().item()


def _offset(t: torch.Tensor, nbytes: int) -> torch.Tensor:
    """A copy of ``t`` whose data starts ``nbytes`` past a 16-byte
    boundary (contiguous, the same shape)."""
    el = t.element_size()
    buf = torch.empty(t.numel() + 16 // el, dtype=t.dtype, device=t.device)
    out = buf[nbytes // el:nbytes // el + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == nbytes
    return out


@pytest.mark.parametrize("nbytes,piece", [(8, 8), (2, 2)])
@pytest.mark.parametrize("T", [5, 512])
def test_ffn_narrow_route_equals_tma_route_bit_for_bit(cuda, nbytes, piece,
                                                       T):
    """At mixtral's widths (d 4096, f 14336) a pool and an input copied to
    an 8- or a 2-byte offset take the narrow copies of that piece; each
    stage's output equals the TMA route's on the same values aligned, bit
    for bit: the two routes share their consumers and their sums."""
    d, f, S = 4096, 14336, 3
    x, si, _, wg, wu, wd = _ffn_inputs(cuda, d, f, T, S, 5)
    g = K.slot_groups(si, S)
    xo, wgo, wuo, wdo = (_offset(t, nbytes) for t in (x, wg, wu, wd))
    assert K._route(x, (wg, wu), d, f) == \
        K.kernel_route(x, (wg, wu), d, f) == ("tma", 16, 16)
    assert K._route(xo, (wgo, wuo), d, f) == \
        K.kernel_route(xo, (wgo, wuo), d, f) == ("narrow", piece, piece)
    h = K.gate_up(x, g, wg, wu)
    assert torch.equal(K.gate_up(xo, g, wgo, wuo), h)
    assert torch.equal(K.up_gelu(xo, g, wuo), K.up_gelu(x, g, wu))
    ho = _offset(h, nbytes)
    assert K.kernel_route(ho, (wdo,), f, d)[0] == "narrow"
    assert torch.equal(K.down(ho, g, wdo), K.down(h, g, wd))


@pytest.mark.parametrize("d,f", [(100, 204), (4092, 14332)])
def test_ffn_any_width_is_batch_invariant(cuda, d, f):
    """At each of chip_smoke.py's FFN_ANY widths (the narrow copies), the
    first 1, 5 and 64 rows of a 512-token call give that call's rows bit
    for bit, through both stages and the combine, swiglu and gelu."""
    x, si, w, wg, wu, wd = _ffn_inputs(cuda, d, f, 512, 8, 6)
    for gate in (wg, None):
        full = K.cache_moe(x, si, w, wu, wd, gate)
        for T in (1, 5, 64):
            part = K.cache_moe(x[:T], si[:T], w[:T], wu, wd, gate)
            assert torch.equal(part, full[:T])


@pytest.mark.parametrize("d,f", [(100, 204), (36, 60), (4092, 14332)])
@pytest.mark.parametrize("T", [5, 512])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ffn_kernel_matches_plain_at_any_width(cuda, d, f, T, dtype, tol):
    """bf16 rows that are no whole number of 16 bytes (d 100 / f 204, and
    mixtral's widths less 4) and f32 rows of odd widths, swiglu through
    ``cache_moe`` and gelu's up stage, against their plain versions (the
    served widths' tolerances), and each row of the T-token call equal to
    the same row alone, bit for bit."""
    gen = torch.Generator(cuda).manual_seed(4)
    S = 4 if d > 1024 else 12
    wg, wu = [(torch.randn((S, d, f), generator=gen, device=cuda)
               * d ** -0.5).to(dtype) for _ in range(2)]
    wd = (torch.randn((S, f, d), generator=gen, device=cuda)
          * f ** -0.5).to(dtype)
    x = torch.randn((T, d), generator=gen, device=cuda).to(dtype)
    si = torch.randint(-1, S, (T, 2), generator=gen, device=cuda
                       ).to(torch.int32)
    w = torch.rand((T, 2), generator=gen, device=cuda).to(dtype)
    before = K.gate_up.launches, K.down.launches
    got = K.cache_moe(x, si, w, wu, wd, wg)
    assert (K.gate_up.launches, K.down.launches) == \
        (before[0] + 1, before[1] + 1)
    want = R.cache_moe_ref(x, si, w, wu, wd, wg)
    scale = want.float().abs().max().item()
    assert torch.isfinite(got).all()
    assert (got.float() - want.float()).abs().max().item() <= tol * scale
    g = K.slot_groups(si, S)
    h = K.up_gelu(x, g, wu)
    h_ref = R.slot_up_gelu_ref(x, g.row_tok, wu, g.grp_slot, g.grp_start,
                               g.grp_count)
    scale = h_ref.float().abs().max().item()
    assert (h.float() - h_ref.float()).abs().max().item() <= tol * scale
    for t in range(0, T, max(1, T // 5)):
        one = K.cache_moe(x[t:t + 1], si[t:t + 1], w[t:t + 1], wu, wd, wg)
        assert torch.equal(one, got[t:t + 1])


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
    (16, 16, 64, 192, (192, 129, 160), 3),     # whisper-medium's steps
    (32, 32, 80, 576, (543, 1, 77), 9),        # phi-2's heads, D 80
    (32, 32, 96, 576, (543, 1, 77), 9),        # phi-3-mini's, D 96
    (16, 16, 256, 576, (543, 1, 77), 9),       # gemma-7b's, D 256
    (71, 1, 64, 576, (543, 1, 77), 9),         # falcon-7b's 71 : 1
    (64, 1, 256, 200, (200, 1, 129), 4),       # 64 : 1 at D 256
    (8, 2, 24, 100, (100, 3, 64), 2),          # D 24: runs in 32
    (8, 2, 40, 100, (100, 3, 64), 2),          # D 40: runs in 64
    (8, 4, 72, 100, (100, 3, 64), 2),          # D 72: runs in 80
    (4, 4, 200, 100, (100, 3, 64), 2),         # D 200: runs in 256
    (4, 4, 8, 40, (40, 1, 17), 1),             # D 8: runs in 16
    # bf16: the narrow copies of the mma.sync instance (D 4 / 20 / 100) or
    # the wide instance (D 264 / 320 / 512); f32: the CUDA-core instance
    # (one block per row and head group walks the live keys)
    (4, 4, 4, 100, (100, 3, 64), 2),           # D 4
    (8, 2, 20, 576, (543, 1, 77), 9),          # D 20, 4 : 1
    (8, 1, 100, 300, (300, 1, 129), 5),        # D 100, 8 : 1
    (8, 8, 264, 200, (200, 1, 129), 4),        # D 264: three slices
    (8, 2, 320, 576, (543, 1, 77), 9),         # D 320
    (8, 1, 512, 200, (200, 1, 129), 4),        # D 512, 8 : 1
    (16, 1, 100, 300, (300, 1, 129), 5),       # D 100, 16 rows a product
    (32, 2, 320, 4096, (4096, 1, 4095), 16),   # D 320, 16 rows, 16 splits
    (8, 2, 4096, 1024, (1024, 1, 577), 16),    # D 4096: 32 slices
    (4, 2, 4104, 200, (200, 1, 129), 4),       # D 4104: a last slice of 8
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
                                     (32, 32, 112),    # zamba2-7b's
                                     (71, 1, 64),      # falcon-7b's
                                     (8, 8, 40)])      # a padded width
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


@pytest.mark.parametrize("D,piece", [(4, 8), (6, 4), (5, 2), (100, 8),
                                     (20, 8), (202, 4), (260, 8),
                                     (263, 2), (264, 16), (320, 16),
                                     (4099, 2)])
def test_decode_narrow_copies_at_every_piece_width(cuda, D, piece):
    """bf16 head dims TMA cannot read, one per piece of the narrow copies
    (16, 8, 4 and 2 bytes; D up to 256 in the mma.sync instance that holds
    D rounded up to 8, past it the wide instance): the entry point picks
    the tensor-core instance ``route`` names, never the CUDA-core one
    (``kernel_route``), and the call matches the plain version (the
    reference's bf16 tolerance), 4 q heads per kv head; each row of a 3-row
    call equals the same row alone, bit for bit, and what lies past the
    lengths does not matter."""
    gen = torch.Generator(cuda).manual_seed(D)
    q = torch.randn((3, 8, D), generator=gen, device=cuda).bfloat16()
    k, v = [torch.randn((3, 300, 2, D), generator=gen, device=cuda
                        ).bfloat16() for _ in range(2)]
    lengths = (300, 1, 129)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    assert DA.route(q, k, v) == DA.kernel_route(q, k, v) == \
        ("narrow" if D <= 256 else "wide")
    assert FA.piece_bytes(k) == FA.piece_bytes(v) == piece
    got = DA.decode_attention(q, k, v, lens)
    want = R.decode_attention_ref(q, k, v, lens)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=1e-2)
    for b in range(3):
        one = DA.decode_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                  lens[b:b + 1])
        assert torch.equal(one, got[b:b + 1])
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lengths):
        k2[b, n:] = float("nan")
        v2[b, n:] = float("nan")
    assert torch.equal(DA.decode_attention(q, k2, v2, lens), got)


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("nbytes", [8, 2])
def test_decode_narrow_route_equals_tma_route_bit_for_bit(cuda, D, nbytes):
    """At D 64 and 128 (TMA instances) k and v copied to an 8- or a 2-byte
    offset take the narrow copies (q at the same offset, which no route
    reads by TMA); the output equals the TMA route's on the same values
    aligned, bit for bit (the same mma.sync and softmax code on the same
    tiles), at llama3.2-3b's 24 / 8 heads in a 576-key cache."""
    gen = torch.Generator(cuda).manual_seed(D + nbytes)
    q = torch.randn((3, 24, D), generator=gen, device=cuda).bfloat16()
    k, v = [torch.randn((3, 576, 8, D), generator=gen, device=cuda
                        ).bfloat16() for _ in range(2)]
    lens = torch.tensor((543, 1, 77), dtype=torch.int32, device=cuda)
    qo, ko, vo = (_offset(t, nbytes) for t in (q, k, v))
    assert DA.route(q, k, v) == DA.kernel_route(q, k, v) == "tma"
    assert DA.route(qo, ko, vo) == DA.kernel_route(qo, ko, vo) == "narrow"
    got = DA.decode_attention(qo, ko, vo, lens)
    assert torch.equal(got, DA.decode_attention(q, k, v, lens))


@pytest.mark.parametrize("H,Hkv", [(8, 2), (32, 2)])
def test_decode_wide_instance_replays_in_a_cuda_graph(cuda, H, Hkv):
    """The wide instance (bf16 D 320: three 128-column slices, each a
    cluster of the cache's splits; 8 and 16 rows a product) captured in a
    CUDA graph: a replay after ``lengths`` changed in place equals the
    eager call at the new lengths, bit for bit."""
    gen = torch.Generator(cuda).manual_seed(H)
    q = torch.randn((2, H, 320), generator=gen, device=cuda).bfloat16()
    k, v = [torch.randn((2, 576, Hkv, 320), generator=gen, device=cuda
                        ).bfloat16() for _ in range(2)]
    lens = torch.tensor([100, 7], dtype=torch.int32, device=cuda)
    assert DA.kernel_route(q, k, v) == "wide"
    DA.decode_attention(q, k, v, lens)          # build, set up
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
    with pytest.raises(ValueError, match="any head dim from 1"):
        DA.decode_attention(torch.zeros((1, 4, 0), device=cuda),
                            torch.zeros((1, 8, 2, 0), device=cuda),
                            torch.zeros((1, 8, 2, 0), device=cuda), lens)
    for D in (20, 264):                              # now taken
        out = DA.decode_attention(torch.zeros((1, 4, D), device=cuda),
                                  torch.zeros((1, 8, 2, D), device=cuda),
                                  torch.zeros((1, 8, 2, D), device=cuda),
                                  lens)
        assert out.shape == (1, 4, D) and not out.any()
    with pytest.raises(ValueError):                  # 3 heads over 2
        DA.decode_attention(torch.zeros((1, 3, 16), device=cuda), k, k,
                            lens)
    # head dim 24 and 64 q heads per kv head are taken
    for H, Hkv, D in ((4, 2, 24), (64, 1, 16)):
        kv = torch.zeros((1, 8, Hkv, D), device=cuda)
        DA.decode_attention(torch.zeros((1, H, D), device=cuda), kv, kv,
                            lens)
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


@pytest.mark.parametrize("arch", ["command-r-35b", "granite-20b",
                                  "nemotron-4-340b"])
@pytest.mark.parametrize("decode", ["greedy", "sd"])
def test_other_dense_targets_on_the_card_match_their_greedy(cuda, arch,
                                                            decode):
    """The same for the other dense targets, reduced (command-r's tied
    embeddings, granite's one kv head and gelu FFN, nemotron's relu2 FFN):
    flash-decode launches once per layer per one-token step."""
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
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


def test_back_to_back_fetch_insert_lands_every_row_on_the_card(cuda):
    """Pinned staging and a copy stream: back-to-back ``fetch`` + ``insert``
    on one thread over more batches than the store has staging buffers,
    with no sync between them (batch i + 2 refills batch i's buffer while
    its copies may still be queued), then every slot equals its store row.
    Experts of 25 MB (d 1024, f 4096, bf16) keep each batch's copies long
    enough for a refill to overtake them were ``fetch`` not to wait."""
    from repro_torch.core import offload
    from repro_torch.core.cache import ExpertCache
    from repro_torch.core.offload import HostExpertStore
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(),
                              d_model=1024, moe_d_ff=4096, d_ff=4096)
    model = build_model(cfg, cuda, seed=0, expert_device="cpu")
    store = HostExpertStore(cfg, model, pin=True)
    keys = [(l, e) for l in range(store.num_layers)
            for e in range(store.num_experts)]
    for per_batch in (2, 3):
        batches = [keys[i:i + per_batch]
                   for i in range(0, len(keys), per_batch)]
        assert len(batches) > offload._NUM_STAGING
        cache = ExpertCache(len(keys), store.buffer_shapes(), torch.bfloat16,
                            table_shape=(store.num_layers,
                                         store.num_experts), device=cuda)
        for b in batches:
            cache.insert(b, store.fetch(b))
        cache.wait()
        assert cache.check_invariants()
        for (l, e), slot in cache.table.items():
            for n in store.names:
                assert torch.equal(cache.bufs[n][slot].cpu(),
                                   store.expert(n, l, e)), (per_batch, n, l,
                                                            e)
    assert store.pinned_bytes > 0


def test_chaos_serving_on_the_card_matches_its_greedy(cuda):
    """sd x spmoe under seeded faults (fetch errors, payload corruption,
    latency spikes) with pinned staging on the card: retries and checksum
    quarantine absorb every fault, and the tokens are the port's greedy."""
    from repro_torch.core.chaos import ChaosConfig
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, cuda, seed=0)
    draft = build_model(dcfg, cuda, seed=1)
    prompts = [torch.randint(0, cfg.vocab_size, (1, 6),
                             generator=torch.Generator().manual_seed(2 + i))
               for i in range(2)]
    refs = [greedy_generate(target, p.to(cuda), 16, 64).tolist()
            for p in prompts]
    chaos = ChaosConfig(seed=7, fetch_error_rate=0.2, corrupt_rate=0.1,
                        spike_rate=0.05, spike_s=0.001)
    with Engine(EngineConfig(model=cfg, draft=dcfg, decode="sd",
                             offload="spmoe", cache_slots=8, draft_len=3,
                             max_seq=64, chaos=chaos,
                             retry_backoff_s=0.001), target, draft) as eng:
        res = eng.serve_all([Request(prompt=p, max_new_tokens=16)
                             for p in prompts], concurrency=2)
        c = eng.runtime.counters()
        inj = eng.runtime.chaos.injected
        assert eng.runtime.cache.check_invariants()
    assert [r.tokens for r in res] == refs
    assert inj["fetch_errors"] > 0 and inj["corruptions"] > 0
    assert c["checksum_failures"] >= inj["corruptions"]
    assert c["io_errors"] == 0


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
    (1, 128, 128, 16, 16, 64, None),     # whisper-medium's served prefill
    (2, 512, 512, 16, 16, 64, None),     # whisper-medium, two rows
    (1, 256, 256, 32, 32, 80, None),     # phi-2's heads, D 80
    (1, 256, 256, 32, 32, 96, None),     # phi-3-mini's, D 96
    (1, 384, 384, 16, 16, 256, None),    # gemma-7b's, D 256: 2 stages
    (2, 96, 160, 8, 2, 256, 48),         # D 256, window, ragged
    (1, 128, 512, 8, 1, 256, None),      # D 256, Sq < Skv
    (1, 256, 256, 71, 1, 64, None),      # falcon-7b's 71 : 1
    (1, 256, 256, 8, 8, 24, None),       # D 24: runs in 32
    (2, 96, 160, 8, 2, 40, 48),          # D 40: runs in 64, window
    (1, 256, 256, 8, 4, 72, None),       # D 72: runs in 80
    (1, 256, 256, 8, 8, 104, None),      # D 104: runs in 112 (128)
    (1, 256, 256, 4, 4, 200, None),      # D 200: runs in 256
    (1, 64, 64, 4, 4, 8, 7),             # D 8: runs in 16
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


@pytest.mark.parametrize("D", [4, 20, 100, 264, 320, 512])
@pytest.mark.parametrize("rep", [1, 4, 8])
@pytest.mark.parametrize("Sq,window", [(256, None), (256, 100),
                                       (128, None)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_kernel_matches_plain_at_any_head_dim(cuda, D, rep, Sq, window,
                                                   dtype, tol):
    """The head dims no TMA instance takes (rows of 8, 40 and 200 bytes,
    and D past 256: 128-column output slices), which run in the wgmma
    instances with narrow copies and the wide instance (bf16) or the
    CUDA-core instance (f32), with 1, 4 and 8 q heads per kv head, causal,
    windowed, and
    Sq < Skv (256 keys), against the plain version at the reference's
    blocks of 128, where both round p (the served shapes' tolerance)."""
    gen = torch.Generator(cuda).manual_seed(D + rep)
    H, Skv = 8, 256
    q = torch.randn((1, Sq, H, D), generator=gen, device=cuda).to(dtype)
    k, v = [torch.randn((1, Skv, H // rep, D), generator=gen, device=cuda
                        ).to(dtype) for _ in range(2)]
    before = FA.flash_attention.launches
    got = FA.flash_attention(q, k, v, causal=True, window=window)
    assert FA.flash_attention.launches == before + 1
    want = R.flash_attention_ref(q, k, v, causal=True, window=window)
    err = (got.float() - want.float()).abs().amax(dim=-1)
    scale = want.float().abs().amax(dim=-1)
    assert torch.isfinite(got).all()
    assert bool((err <= tol * scale).all())


@pytest.mark.parametrize("D,piece", [(4, 8), (6, 4), (5, 2), (100, 8),
                                     (20, 8), (202, 4), (260, 8),
                                     (263, 2), (320, 16)])
def test_flash_narrow_copies_at_every_piece_width(cuda, D, piece):
    """bf16 head dims TMA cannot read, one per piece of the narrow copies
    (16, 8, 4 and 2 bytes; D up to 256 in the wgmma instance that holds D
    rounded up to 8, past it the wide instance): the entry point picks the
    tensor-core instance ``route`` names, never the CUDA-core one
    (``kernel_route``; chip_smoke.py names the kernel the profiler saw),
    and the call matches the plain version (FA_TOL 1e-2 of each row's
    max), causal and windowed, 4 q heads per kv head."""
    gen = torch.Generator(cuda).manual_seed(D)
    q = torch.randn((1, 256, 8, D), generator=gen, device=cuda).bfloat16()
    k, v = [torch.randn((1, 256, 2, D), generator=gen, device=cuda
                        ).bfloat16() for _ in range(2)]
    name = FA.route(q, k, v)
    assert name == FA.kernel_route(q, k, v) == ("narrow" if D <= 256
                                                else "wide")
    assert FA.piece_bytes(k) == piece
    for window in (None, 100):
        got = FA.flash_attention(q, k, v, causal=True, window=window)
        want = R.flash_attention_ref(q, k, v, causal=True, window=window)
        err = (got.float() - want.float()).abs().amax(dim=-1)
        assert torch.isfinite(got).all()
        assert bool((err <= 1e-2 * want.float().abs().amax(dim=-1)).all())


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("nbytes", [8, 2])
@pytest.mark.parametrize("window", [None, 100])
def test_flash_narrow_route_equals_tma_route_bit_for_bit(cuda, D, nbytes,
                                                        window):
    """At D 64 and 128 (TMA instances) q, k and v copied to an 8- or a
    2-byte offset take the narrow copies; the output equals the TMA
    route's on the same values aligned, bit for bit (the same wgmma,
    softmax and ping-pong code on the same tiles)."""
    gen = torch.Generator(cuda).manual_seed(D + nbytes)
    q = torch.randn((2, 384, 8, D), generator=gen, device=cuda).bfloat16()
    k, v = [torch.randn((2, 384, 2, D), generator=gen, device=cuda
                        ).bfloat16() for _ in range(2)]
    qo, ko, vo = (_offset(t, nbytes) for t in (q, k, v))
    assert FA.route(q, k, v) == FA.kernel_route(q, k, v) == "tma"
    assert FA.route(qo, ko, vo) == FA.kernel_route(qo, ko, vo) == "narrow"
    got = FA.flash_attention(qo, ko, vo, window=window)
    assert torch.equal(got, FA.flash_attention(q, k, v, window=window))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_attention_kernels_take_unaligned_rows(cuda, dtype, tol):
    """k and v as views one element into wider rows (pointers and strides
    off 16 bytes) at D 64, a width of the TMA instances: both kernels take
    them (flash in bf16 through its narrow copies, else through the
    CUDA-core instance) and match their plain versions."""
    gen = torch.Generator(cuda).manual_seed(11)
    D, H, Hkv, S = 64, 8, 2, 256
    q = torch.randn((1, S, H, D), generator=gen, device=cuda).to(dtype)
    k, v = [torch.randn((1, S, Hkv, D + 1), generator=gen, device=cuda
                        ).to(dtype)[..., 1:] for _ in range(2)]
    assert k.data_ptr() % 16 and k.stride(2) % 8
    got = FA.flash_attention(q, k, v, causal=True)
    want = R.flash_attention_ref(q, k, v, causal=True)
    err = (got.float() - want.float()).abs().amax(dim=-1)
    assert bool((err <= tol * want.float().abs().amax(dim=-1)).all())
    lens = torch.tensor([200], dtype=torch.int32, device=cuda)
    got = DA.decode_attention(q[:, 0], k, v, lens)
    want = R.decode_attention_ref(q[:, 0], k, v, lens)
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2e-2 if dtype == torch.bfloat16
                               else 2e-5, rtol=1e-2)


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
    (1, 512, 48, 64, 128, 256),          # mamba2-780m at Mamba2's chunk
    (2, 320, 4, 64, 64, 160),            # chunk 160: tiles 128 + 32
    (1, 262, 4, 64, 64, 131),            # a prime chunk: 128 + 3
    (1, 384, 4, 64, 160, 128),           # n 160: blocks 128 + 32
    (1, 512, 4, 64, 256, 256),           # n 256, chunk 256
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


@pytest.mark.parametrize("s,h,n,chunk", [(512, 48, 128, 128),
                                          (512, 48, 128, 256),
                                          (262, 4, 64, 131),
                                          (512, 4, 256, 128)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_ssd_kernel_from_a_state_matches_plain(cuda, s, h, n, chunk, dtype,
                                               tol):
    """From a given initial state: against ``ref.ssd_ref`` from the same
    state, and the sequence scanned in two halves, the second from the
    first's final state, against one scan of the whole (y and state; the
    served tolerances)."""
    x, dt, A, B, C = _ssd_inputs(cuda, 1, s, h, 64, n, dtype)
    init = torch.randn((1, h, 64, n), generator=torch.Generator(
        cuda).manual_seed(9), device=cuda)
    y, state = SSD.ssd_scan(x, dt, A, B, C, chunk, init)
    y_ref, state_ref = R.ssd_ref(x, dt, A, B, C, chunk, init)
    half = s // 2
    parts = [[t[:, a:b].contiguous() for t in (x, dt, B, C)]
             for a, b in ((0, half), (half, s))]
    c2 = chunk if half % chunk == 0 else half
    y1, s1 = SSD.ssd_scan(parts[0][0], parts[0][1], A, parts[0][2],
                          parts[0][3], c2)
    y2, s2 = SSD.ssd_scan(parts[1][0], parts[1][1], A, parts[1][2],
                          parts[1][3], c2, s1)
    yw, sw = SSD.ssd_scan(x, dt, A, B, C, c2)
    for got, want, t in ((y, y_ref, tol), (state, state_ref, 1e-4),
                         (torch.cat([y1, y2], 1), yw, tol), (s2, sw, 1e-4)):
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
    with pytest.raises(ValueError):
        SSD.ssd_scan(x, dt, A, B, C, 0)               # chunk 0
    with pytest.raises(ValueError):                   # a wrong state
        SSD.ssd_scan(x, dt, A, B, C, 16, torch.zeros((1, 2, 16, 8),
                                                      device=cuda))
    with pytest.raises(TypeError):
        SSD.ssd_scan(x.half(), dt, A, B.half(), C.half(), 16)
    with pytest.raises(TypeError):
        SSD.ssd_scan(x, dt.bfloat16(), A, B, C, 16)
    with pytest.raises(ValueError):
        SSD.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                     B, C, 16)
    wide = torch.zeros((1, 64, 256), device=cuda)     # n 256: taken
    y, st = SSD.ssd_scan(x, dt, A, wide, wide, 64)
    assert st.shape == (1, 2, 16, 256) and not y.any() and not st.any()


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


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                        (torch.bfloat16, 2e-2)])
def test_moe_gemm_entry_point_matches_its_plain_version_on_the_card(
        cuda, dtype, atol):
    """``ops.moe_gemm`` (expert e = slot e, its C rows one group) through
    the expert-FFN kernel's two stages against ``ref.moe_gemm_ref``."""
    gen = torch.Generator(cuda).manual_seed(3)
    E, C, d, f = 4, 64, 256, 512
    xg = torch.randn((E, C, d), generator=gen, device=cuda).to(dtype)
    wg, wu = (torch.randn((E, d, f), generator=gen, device=cuda).mul_(
        d ** -0.5).to(dtype) for _ in range(2))
    wd = torch.randn((E, f, d), generator=gen, device=cuda).mul_(
        f ** -0.5).to(dtype)
    valid = torch.rand((E, C), generator=gen, device=cuda) < 0.7
    n0 = (ops.moe_gemm.launches, K.gate_up.launches, K.down.launches)
    got = ops.moe_gemm(xg, wg, wu, wd, valid)
    want = R.moe_gemm_ref(xg, wg, wu, wd, valid)
    torch.testing.assert_close(got.float(), want.float(), atol=atol, rtol=0)
    assert (got[~valid] == 0).all()
    assert (ops.moe_gemm.launches, K.gate_up.launches, K.down.launches) == \
        tuple(n + 1 for n in n0)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    """One train step of a reduced mixtral (f32, S 32: the capacity route)
    on the card against the same step on the CPU, from the same weights and
    batch: the loss and every gradient (through the step's own gradient
    function) within 1e-4 relative."""
    _card_vs_cpu_step(cuda, "mixtral-8x7b")


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b",
                                  "whisper-medium"])
def test_other_families_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """The same for the SSD families (the plain scan ``ssd_ref`` on both
    devices; the kernel's wrapper is never called) and whisper (a frames
    batch)."""
    before = ops.ssd.launches
    _card_vs_cpu_step(cuda, arch)
    assert ops.ssd.launches == before


def _card_vs_cpu_step(cuda, arch):
    from repro_torch.models.train import make_loss_fn
    cfg = get_config(arch).reduced(dtype="float32")
    models = {}
    for dev in ("cpu", cuda):
        m = build_model(cfg, "cpu", seed=0).to(dev)
        for p in m.parameters():
            p.requires_grad_(True)
        models[str(dev)] = m
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (4, 33), generator=gen)
    frames = torch.randn((4, cfg.encoder_seq, cfg.d_model), generator=gen)
    out = {}
    for dev, m in models.items():
        batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
        if cfg.family == "encdec":
            batch["frames"] = frames.to(dev)
        loss, _ = make_loss_fn(m, cfg)(batch)
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in m.named_parameters()])
        out[dev] = (float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)})
    (lc, gc), (lg, gg) = out["cpu"], out[str(cuda)]
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for n, g in gc.items():
        assert torch.isfinite(gg[n]).all(), n
        err = float((gg[n] - g).abs().max()) / max(float(g.abs().max()),
                                                    1e-30)
        assert err <= 1e-4, (n, err)


@pytest.mark.parametrize("over", [{}, {"head_dim": 64,
                                       "attn_impl": "kernel"}],
                         ids=["xla", "kernel-hd64"])
def test_whisper_on_the_card_matches_the_cpu(cuda, over):
    """Reduced whisper in f32, the same weights on both devices: prefill
    and four one-token steps give the same logits within 1e-4 (under
    ``attn_impl="kernel"`` at head dim 64: flash once per decoder layer in
    the prefill, flash-decode once per decoder layer per step on the card,
    their plain versions on the CPU), and so does the train-mode forward."""
    cfg = get_config("whisper-medium").reduced(dtype="float32", **over)
    cpu = build_model(cfg, "cpu", seed=0)
    gpu = build_model(cfg, cuda, seed=0)
    gpu.load_state_dict(cpu.state_dict())
    gen = torch.Generator().manual_seed(3)
    prompt = torch.randint(0, cfg.vocab_size, (2, 24), generator=gen)
    frames = torch.randn((2, cfg.encoder_seq, cfg.d_model), generator=gen)
    n0 = (FA.flash_attention.launches, DA.decode_attention.launches)
    with torch.no_grad():
        lc, cc = cpu.prefill(prompt, 40, frames)
        lg, cg = gpu.prefill(prompt.to(cuda), 40, frames.to(cuda))
        torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
        tok = torch.argmax(lc, -1)[:, None]
        for pos in range(24, 28):
            lc, cc, _ = cpu.decode_step(cc, tok, pos)
            lg, cg, _ = gpu.decode_step(cg, tok.to(cuda), pos)
            torch.testing.assert_close(lg.cpu(), lc, atol=1e-4, rtol=0)
            tok = torch.argmax(lc[:, -1], -1)[:, None]
        fc, _ = cpu.forward(prompt, frames)
        fg, _ = gpu.forward(prompt.to(cuda), frames.to(cuda))
        torch.testing.assert_close(fg.cpu(), fc, atol=1e-4, rtol=0)
    n1 = (FA.flash_attention.launches, DA.decode_attention.launches)
    kernel = cfg.attn_impl == "kernel"
    assert n1[0] - n0[0] == 2 * cfg.num_layers * kernel
    assert n1[1] - n0[1] == 4 * cfg.num_layers * kernel
