"""PyTorch port, flash-decode on the CPU: the kernel's plain version against
the JAX Pallas kernel (run as its own tests run it on the CPU: interpret
mode) and the reference's ``decode_attention_ref``; then the
``attn_impl="kernel"`` route through ``attention_decode`` (one-token steps
on both sides of the window boundary, a wrapped ring, verify blocks of
five), ``DecoderLM.decode_step`` over a cache with a hole, and a dense
target (reduced llama3.2-3b) served greedy and speculatively, against the
reference.  The CUDA kernel itself is tested on a card (test_torch_cuda.py,
chip_smoke.py).

Inputs are made from a seed with numpy and fed to both packages.  Kernel
tolerances are those of the reference's own sweep (tests/test_kernels.py:
f32 atol 2e-5, bf16 2e-2, rtol 1e-2): the Pallas kernel sums in blocks with
an online softmax, the plain versions in one pass, and bf16 rounds p and
the output once each.  Layer outputs: f32 atol 1e-5, as
tests/test_torch_flash.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.core.engine import Engine as JaxEngine
from repro.core.engine import EngineConfig as JaxEngineConfig
from repro.core.engine import Request as JaxRequest
from repro.core.engine import derive_draft_config as jax_derive
from repro.kernels import ref as JR
from repro.kernels.decode_attention import decode_attention as jax_decode
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

from test_torch_flash import _view

torch.set_num_threads(1)  # pytest -n: several processes share the cores

ATOL = 1e-5


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(B, S, H, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, H, D), (B, S, Hkv, D), (B, S, Hkv, D))]
    lengths = rng.integers(1, S + 1, (B,)).astype(np.int32)
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    # the same rounded values on both sides
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return (jx, jnp.asarray(lengths)), (tx, torch.from_numpy(lengths))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("B,S,H,Hkv,D,bk", [
    (2, 32, 4, 2, 16, 8),             # the reference sweep's shapes
    (1, 64, 8, 8, 32, 16),
    (3, 16, 2, 1, 64, 8),
    (2, 64, 6, 2, 128, 16),           # llama3.2-3b widths, 2 kv heads
    (2, 32, 4, 2, 112, 8),            # zamba2-7b's head dim
    (1, 32, 4, 2, 192, 16),           # nemotron-4-340b's head dim
    (2, 32, 48, 1, 16, 8),            # granite-20b's 48 q heads per kv head
    (2, 32, 4, 2, 24, 8),             # a padded width (runs in 32 on a card)
    (1, 32, 4, 4, 80, 16),            # phi-2's head dim
    (2, 32, 4, 2, 96, 8),             # phi-3-mini's
    (1, 32, 2, 2, 256, 16),           # gemma-7b's
    (2, 32, 64, 1, 16, 8),            # 64 q heads per kv head
    (1, 32, 71, 1, 64, 16),           # falcon-7b's 71 : 1
    # head dims no TMA instance takes (the CUDA-core instance on a card):
    (2, 32, 4, 4, 4, 8),              # bf16 rows of 8 bytes
    (2, 32, 8, 2, 20, 8),             # 40-byte rows, 4 : 1
    (1, 32, 8, 1, 100, 16),           # 200-byte rows, 8 : 1
    (1, 32, 2, 2, 264, 16),           # past 256: three output slices
    (2, 32, 4, 1, 320, 8),            # past 256, 4 : 1
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_jax_kernel(B, S, H, Hkv, D, bk, dtype):
    ((jq, jk, jv), jlen), ((q, k, v), lens) = _inputs(B, S, H, Hkv, D,
                                                      dtype, 0)
    want = jax_decode(jq, jk, jv, jlen, block_k=bk, interpret=True)
    got = ops.decode_attention(q, k, v, lens)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=1e-2)
    np.testing.assert_allclose(
        _np(got), np.asarray(JR.decode_attention_ref(jq, jk, jv, jlen),
                             np.float32), atol=_tol(dtype), rtol=1e-2)


def test_ops_decode_routes_cpu_tensors_to_the_plain_version():
    _, ((q, k, v), lens) = _inputs(2, 24, 4, 2, 16, "float32", 1)
    before = DA.decode_attention.launches
    want = R.decode_attention_ref(q, k, v, lens)
    for fn in (ops.decode_attention, DA.decode_attention):
        assert torch.equal(fn(q, k, v, lens), want)
    assert DA.decode_attention.launches == before


def test_decode_wrapper_refuses_what_it_does_not_take():
    """The checks run before the library loads (no card needed).  The
    kernel takes every head dim from 1 (D 4, 20, 100, 264, 320 and 512
    too: the CUDA-core instance), unaligned cache rows and any number of q
    heads per kv head; D 0, a wrong dtype, a head count that is no multiple
    of the kv heads and lengths that are not int32 still raise."""
    q, k = torch.zeros((1, 4, 16)), torch.zeros((1, 8, 2, 16))
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(TypeError):
        DA._check(q.half(), k.half(), k.half(), lens)
    with pytest.raises(ValueError, match="any head dim from 1"):
        DA._check(torch.zeros((1, 4, 0)), torch.zeros((1, 8, 2, 0)),
                  torch.zeros((1, 8, 2, 0)), lens)
    for D in (4, 20, 100, 264, 320, 512):
        DA._check(torch.zeros((1, 4, D)), torch.zeros((1, 8, 2, D)),
                  torch.zeros((1, 8, 2, D)), lens)
    ku = torch.zeros((1, 8, 2, 20))[..., 2:18]       # 40-byte rows, offset
    DA._check(q, ku, ku, lens)
    with pytest.raises(ValueError):                  # 3 heads over 2
        DA._check(torch.zeros((1, 3, 16)), k, k, lens)
    with pytest.raises(ValueError):                  # int64 lengths
        DA._check(q, k, k, lens.long())
    DA._check(q, k, k, lens)


def _attn_params(d, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
              "wo": (H, hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


class _Spy:
    """Counts the plain flash-decode calls (the kernel route on the CPU)."""

    def __init__(self, monkeypatch):
        self.lengths = []
        orig = R.decode_attention_ref

        def spy(q, k, v, lengths):
            self.lengths.append(lengths.tolist())
            return orig(q, k, v, lengths)
        monkeypatch.setattr(R, "decode_attention_ref", spy)


@pytest.mark.parametrize("window", [16, None])
def test_attention_decode_kernel_route_matches_jax(window, monkeypatch):
    """One layer's decode steps from an empty cache, in both packages:
    one-token steps at 0..8, a verify block of five at 9..13, then one
    token at a time to 40.  With the reduced window of 16 (a ring of 32
    slots) the steps before 16 take the kernel route and the later ones,
    past the window and past the ring's wrap at 32, the masked route; with
    no window every one-token step takes the kernel route.  Every output
    and the final cache equal the reference's."""
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel", sliding_window=window)
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel", sliding_window=window)
    p = _attn_params(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, 3)
    jp = {n: jnp.asarray(a) for n, a in p.items()}
    tp = type("P", (), {n: torch.from_numpy(a) for n, a in p.items()})
    jc = JL.init_kv_cache(jcfg, 1, 64, jnp.float32)
    tc = L.init_kv_cache(cfg, 1, 64, torch.float32, torch.device("cpu"))
    spy = _Spy(monkeypatch)
    rng = np.random.default_rng(4)
    steps = [(pos, 1) for pos in range(9)] + [(9, 5)] + \
        [(pos, 1) for pos in range(14, 41)]
    for pos, sq in steps:
        x = rng.standard_normal((1, sq, cfg.d_model)).astype(np.float32)
        want, jc = JL.attention_decode(jp, jnp.asarray(x), jc,
                                       jnp.int32(pos), jcfg)
        got, tc = L.attention_decode(tp, torch.from_numpy(x), tc, pos, cfg,
                                     contiguous=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0, err_msg=f"pos {pos}")
    routed = [pos for pos, sq in steps
              if sq == 1 and (window is None or pos < window)]
    assert spy.lengths == [[pos + 1] for pos in routed]
    if window:           # the boundary: 14 and 15 routed, 16 and 17 not
        assert {14, 15} <= set(routed) and not {16, 17} & set(routed)
        assert max(pos for pos, _ in steps) >= tc["k"].shape[1]  # wrapped
    for name in ("k", "v", "pos_map"):
        np.testing.assert_allclose(tc[name].numpy(), np.asarray(jc[name]),
                                   atol=ATOL, rtol=0)


def test_non_contiguous_steps_take_the_masked_route(monkeypatch):
    """``attn_impl="xla"`` and a caller that cannot vouch for the prefix
    take the masked route even for a one-token step."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(
        dtype="float32"), attn_impl="kernel")
    p = _attn_params(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, 5)
    tp = type("P", (), {n: torch.from_numpy(a) for n, a in p.items()})
    tc = L.init_kv_cache(cfg, 1, 16, torch.float32, torch.device("cpu"))
    spy = _Spy(monkeypatch)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 1, cfg.d_model)).astype(np.float32))
    L.attention_decode(tp, x, tc, 0, cfg)
    L.attention_decode(tp, x, tc, 1, dataclasses.replace(cfg,
                                                         attn_impl="xla"),
                       contiguous=True)
    assert spy.lengths == []
    L.attention_decode(tp, x, tc, 2, cfg, contiguous=True)
    assert spy.lengths == [[3]]


def _dense_pair(seed: int, draft_seed: int):
    jcfg = dataclasses.replace(jax_config("llama3.2-3b").reduced(
        dtype="float32"), attn_impl="kernel")
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(
        dtype="float32"), attn_impl="kernel")
    jm, jdm = jax_build(jcfg), jax_build(jax_derive(jcfg))
    jtp = jm.init(jax.random.PRNGKey(seed))
    jdp = jdm.init(jax.random.PRNGKey(draft_seed))
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(derive_draft_config(cfg), "cpu"),
                            jax.tree.map(np.asarray, jdp))
    return (jcfg, jm, jtp, jdp), (cfg, target, draft)


def test_decode_step_over_a_hole_matches_jax(monkeypatch):
    """A decode step past the written prefix (a draft whose last token was
    accepted without being fed leaves such a hole) attends only the slots
    the pos_map mask allows: the masked route, as the reference, from then
    on; steps over a whole prefix take the kernel route, one launch per
    layer."""
    (jcfg, jm, jtp, _), (cfg, target, _) = _dense_pair(0, 1)
    prompt = np.random.default_rng(8).integers(0, cfg.vocab_size, (1, 8))
    _, jc = jm.prefill(jtp, jnp.asarray(prompt), 32)
    _, tc = target.prefill(torch.from_numpy(prompt), 32)
    spy = _Spy(monkeypatch)
    for pos in (8, 9, 11, 12):                     # position 10 never fed
        tok = np.array([[pos * 7 % cfg.vocab_size]])
        jl, jc, _ = jm.decode_step(jtp, jc, jnp.asarray(tok), pos)
        tl, tc, _ = target.decode_step(tc, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0, err_msg=f"pos {pos}")
    assert spy.lengths == [[9]] * cfg.num_layers + [[10]] * cfg.num_layers
    assert tc["written"] == 10


@pytest.mark.parametrize("decode", ["greedy", "sd"])
def test_dense_engine_matches_jax_engine(decode, monkeypatch):
    """Reduced llama3.2-3b under ``attn_impl="kernel"``, greedy x none and
    sd x none with the derived half-depth draft: the port's Engine emits the
    JAX Engine's tokens and its own greedy tokens, every one-token step of
    the target (greedy) or the draft (sd) through the flash-decode route."""
    (jcfg, jm, jtp, jdp), (cfg, target, draft) = _dense_pair(0, 1)
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 12))
    common = dict(decode=decode, draft_len=3, max_seq=64)
    with JaxEngine(JaxEngineConfig(model=jcfg, **common), jtp,
                   jdp if decode == "sd" else None) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(prompt),
                                      max_new_tokens=16)).tokens
    spy = _Spy(monkeypatch)
    with Engine(EngineConfig(model=cfg, **common), target,
                draft if decode == "sd" else None) as eng:
        got = eng.submit(Request(prompt=prompt, max_new_tokens=16))
    assert got.tokens == want
    assert got.tokens == greedy_generate(target, torch.from_numpy(prompt),
                                         16, 64).tolist()
    layers = (draft if decode == "sd" else target).cfg.num_layers
    assert spy.lengths and len(spy.lengths) % layers == 0


DECODE_ROUTES = {
    # name: (dtype, D, k / v offset in elements, row pad, route, k's piece
    #        in bytes)
    "bf16-D4": (torch.bfloat16, 4, 0, 0, "narrow", 8),
    "bf16-D20": (torch.bfloat16, 20, 0, 0, "narrow", 8),
    "bf16-D100": (torch.bfloat16, 100, 0, 0, "narrow", 8),
    "bf16-D200": (torch.bfloat16, 200, 0, 0, "tma", 16),
    "bf16-D202": (torch.bfloat16, 202, 0, 0, "narrow", 4),
    "bf16-D5": (torch.bfloat16, 5, 0, 0, "narrow", 2),
    "bf16-D264": (torch.bfloat16, 264, 0, 0, "wide", 16),
    "bf16-D320": (torch.bfloat16, 320, 0, 0, "wide", 16),
    "bf16-D512": (torch.bfloat16, 512, 0, 0, "wide", 16),
    "bf16-D4096": (torch.bfloat16, 4096, 0, 0, "wide", 16),
    "bf16-D4104": (torch.bfloat16, 4104, 0, 0, "wide", 16),
    "bf16-D8195": (torch.bfloat16, 8195, 0, 0, "wide", 2),
    "bf16-D64": (torch.bfloat16, 64, 0, 0, "tma", 16),
    "bf16-D128": (torch.bfloat16, 128, 0, 0, "tma", 16),
    "bf16-D64-offset-8-bytes": (torch.bfloat16, 64, 4, 0, "narrow", 8),
    "bf16-D64-offset-2-bytes": (torch.bfloat16, 64, 1, 0, "narrow", 2),
    "bf16-D64-rows-of-65": (torch.bfloat16, 64, 0, 1, "narrow", 2),
    "bf16-D128-rows-of-130": (torch.bfloat16, 128, 0, 2, "narrow", 4),
    "f32-D20": (torch.float32, 20, 0, 0, "any", None),
    "f32-D264": (torch.float32, 264, 0, 0, "any", None),
    "f32-D64": (torch.float32, 64, 0, 0, "tma", None),
    "f32-D128": (torch.float32, 128, 0, 0, "tma", None),
    "f32-D64-offset-4-bytes": (torch.float32, 64, 1, 0, "any", None),
}


@pytest.mark.parametrize("case", sorted(DECODE_ROUTES))
def test_decode_route_follows_dtype_head_dim_and_strides(case):
    """The instance ``csrc/decode_attention.cu`` runs a call in, as
    ``route`` mirrors its entry point (no card needed): a D that is a
    multiple of 8 to 256 with k and v 16-byte aligned takes the TMA
    instances; otherwise bf16 takes the mma.sync kernel with narrow copies
    (D up to 256, pieces of ``piece_bytes``) or the wide instance (any D
    past 256), and f32 the CUDA-core instance.  q's strides choose nothing (no instance reads it by TMA).
    The wrapper's checks take every one of them."""
    dtype, D, off, pad, want, piece = DECODE_ROUTES[case]
    q = torch.zeros((1, 4, D), dtype=dtype)
    k = _view((1, 8, 2, D), dtype, off, pad)
    lens = torch.ones(1, dtype=torch.int32)
    DA._check(q, k, k, lens)
    assert DA.route(q, k, k) == want
    if piece is not None:
        assert FA.piece_bytes(k) == piece
    if want == "tma":                   # one unaligned tensor is enough
        kv = _view((1, 8, 2, D), dtype, 1)
        assert DA.route(q, kv, k) == DA.route(q, k, kv) == (
            "narrow" if dtype == torch.bfloat16 else "any")
        qo = _view((1, 1, 4, D + 1), dtype, 1)[0, :, :, :D]
        assert DA.route(qo, k, k) == "tma"
