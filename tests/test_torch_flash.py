"""PyTorch port, flash attention (prefill) on the CPU: the kernel's plain
version against the JAX Pallas kernel (run as its own tests run it on the
CPU: interpret mode) and against both packages' ``attention_ref``, then the
``attn_impl="kernel"`` route through ``attention_forward``, ``DecoderLM``
and the serving engine against the reference.  The CUDA kernel itself is
tested on a card (test_torch_cuda.py, chip_smoke.py).

Inputs are made from a seed with numpy and fed to both packages.  Kernel
tolerances are those of the reference's own sweep (tests/test_kernels.py:
f32 atol 2e-5, bf16 2e-2, rtol 1e-2): the two sides sum the same products
in another order, and bf16 rounds p and the output once each.  Model
logits: f32 atol 1e-4, as tests/test_torch_model.py."""
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
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (Engine, EngineConfig, Request,
                                     derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.models import layers as L
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

LOGIT_ATOL = 1e-4


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _qkv(B, Sq, Skv, H, Hkv, D, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
    jx = [jnp.asarray(a, jnp.dtype(dtype)) for a in arrs]
    # the same rounded values on both sides
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in jx]
    return jx, tx


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,bq,bk", [
    (1, 16, 16, 4, 4, 16, 8, 8),      # MHA square
    (2, 16, 32, 4, 2, 16, 8, 8),      # GQA, kv longer (decode-block case)
    (1, 32, 32, 8, 1, 32, 16, 16),    # MQA
    (1, 8, 8, 2, 2, 64, 8, 8),        # single block
    (1, 16, 16, 4, 2, 112, 8, 8),     # zamba2-7b's head dim
    (1, 16, 16, 2, 2, 192, 8, 8),     # nemotron-4-340b's head dim
    (1, 16, 16, 48, 1, 16, 8, 8),     # granite-20b's 48 q heads per kv head
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_kernel(B, Sq, Skv, H, Hkv, D, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(B, Sq, Skv, H, Hkv, D, dtype, 0)
    want = jax_flash(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                     interpret=True)
    got = R.flash_attention_ref(q, k, v, causal=True, block_q=bq,
                                block_k=bk)
    assert got.dtype == q.dtype and got.shape == q.shape
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=_tol(dtype), rtol=1e-2)
    # and against the unblocked oracle of both packages
    np.testing.assert_allclose(_np(got), _np(R.attention_ref(q, k, v)),
                               atol=_tol(dtype), rtol=1e-2)
    np.testing.assert_allclose(
        _np(R.attention_ref(q, k, v)),
        np.asarray(JR.attention_ref(jq, jk, jv), np.float32),
        atol=_tol(dtype), rtol=1e-2)


@pytest.mark.parametrize("window", [4, 7, 16])
def test_flash_ref_sliding_window_matches_jax_kernel(window):
    (jq, jk, jv), (q, k, v) = _qkv(1, 16, 16, 4, 2, 16, "float32", 1)
    want = jax_flash(jq, jk, jv, causal=True, window=window, block_q=8,
                     block_k=8, interpret=True)
    got = R.flash_attention_ref(q, k, v, causal=True, window=window,
                                block_q=8, block_k=8)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5,
                               rtol=1e-3)
    np.testing.assert_allclose(_np(got),
                               _np(R.attention_ref(q, k, v, window=window)),
                               atol=2e-5, rtol=1e-3)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    _, (q, k, v) = _qkv(1, 16, 16, 4, 2, 16, "float32", 2)
    before = FA.flash_attention.launches
    want = R.flash_attention_ref(q, k, v, window=7, block_q=8, block_k=8)
    for fn in (ops.flash_attention, FA.flash_attention):
        got = fn(q, k, v, causal=True, window=7, block_q=8, block_k=8)
        assert torch.equal(got, want)
    assert FA.flash_attention.launches == before


def test_block_precondition_is_the_references():
    """Sequence lengths must be multiples of their (capped) blocks: the
    reference asserts it, the port raises before anything runs."""
    _, (q, k, v) = _qkv(1, 12, 12, 2, 2, 16, "float32", 3)
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, block_q=8, block_k=8)
    with pytest.raises(AssertionError):
        jax_flash(*map(jnp.asarray, (q.numpy(), k.numpy(), v.numpy())),
                  block_q=8, block_k=8, interpret=True)
    ops.flash_attention(q, k, v, block_q=128, block_k=128)   # capped: 12


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """The checks run before the library loads (no card needed)."""
    q = torch.zeros((1, 8, 4, 16), dtype=torch.float16)
    with pytest.raises(TypeError):
        FA._check(q, q, q)
    q = torch.zeros((1, 8, 4, 24))
    with pytest.raises(ValueError):
        FA._check(q, q, q)                       # head dim 24
    q = torch.zeros((1, 8, 3, 16))
    k = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError):
        FA._check(q, k, k)                       # 3 heads over 2 kv heads
    # the registered configs' head shapes: zamba2-7b, nemotron, granite
    for H, Hkv, D in ((32, 32, 112), (96, 8, 192), (48, 1, 128)):
        k = torch.zeros((1, 8, Hkv, D))
        FA._check(torch.zeros((1, 8, H, D)), k, k)


def _attn_params(d, H, Hkv, hd, seed):
    rng = np.random.default_rng(seed)
    shapes = {"wq": (d, H, hd), "wk": (d, Hkv, hd), "wv": (d, Hkv, hd),
              "wo": (H, hd, d)}
    return {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for n, s in shapes.items()}


@pytest.mark.parametrize("window", [None, 8])
def test_attention_forward_kernel_route_matches_jax(window):
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel", sliding_window=window)
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel", sliding_window=window)
    p = _attn_params(cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                     cfg.head_dim, 4)
    x = np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    want = JL.attention_forward({n: jnp.asarray(a) for n, a in p.items()},
                                jnp.asarray(x), jcfg)
    tp = type("P", (), {n: torch.from_numpy(a) for n, a in p.items()})
    got = L.attention_forward(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    plain = L.attention_forward(tp, torch.from_numpy(x),
                                dataclasses.replace(cfg, attn_impl="xla"))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-5,
                               rtol=0)


def _pair(arch, seed, **over):
    jcfg = dataclasses.replace(jax_config(arch).reduced(dtype="float32"),
                               attn_impl="kernel", **over)
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              attn_impl="kernel", **over)
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(seed))
    tm = load_jax_params(build_model(cfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    return jm, jp, tm


@pytest.mark.parametrize("arch,over,fwd_len", [
    ("mixtral-8x7b", {}, 8),               # the reference routes >8 tokens
    ("llama3.2-3b", {"sliding_window": 8}, 16),   # with capacity in forward
])
def test_model_forward_and_prefill_kernel_route_match_jax(arch, over,
                                                          fwd_len):
    jm, jp, tm = _pair(arch, 0, **over)
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, tm.cfg.vocab_size, (1, fwd_len))
    jl, _ = jm.forward(jp, jnp.asarray(tokens))
    tl, _ = tm.forward(torch.from_numpy(tokens))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    prompt = rng.integers(0, tm.cfg.vocab_size, (1, 16))
    jl, jc = jm.prefill(jp, jnp.asarray(prompt), 48)
    tl, tc = tm.prefill(torch.from_numpy(prompt), 48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_ATOL,
                               rtol=0)
    for l in range(tm.cfg.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["layers"][l][name].numpy(),
                                       np.asarray(jc["layers"][name][l]),
                                       atol=LOGIT_ATOL, rtol=0)


def test_engine_kernel_route_matches_jax_engine():
    """sd x spmoe with ``attn_impl="kernel"`` (every draft prefill goes
    through flash attention) on both packages, prefetching synchronously:
    the same tokens, and the port's own greedy tokens."""
    jcfg = dataclasses.replace(jax_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel")
    cfg = dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="float32"), attn_impl="kernel")
    jtp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    jdp = jax_build(jax_derive(jcfg)).init(jax.random.PRNGKey(1))
    dcfg = derive_draft_config(cfg)
    assert dcfg.attn_impl == "kernel"
    target = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jtp))
    draft = load_jax_params(build_model(dcfg, "cpu"),
                            jax.tree.map(np.asarray, jdp))
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, (1, 8))
    common = dict(decode="sd", offload="spmoe", cache_slots=8, draft_len=3,
                  max_seq=64, prefetch_mode="vanilla")
    with JaxEngine(JaxEngineConfig(model=jcfg, draft=jax_derive(jcfg),
                                   **common), jtp, jdp) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(prompt),
                                      max_new_tokens=10)).tokens
    calls = []
    orig = R.flash_attention_ref

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return orig(*a, **kw)

    R.flash_attention_ref = spy
    try:
        with Engine(EngineConfig(model=cfg, draft=dcfg, **common), target,
                    draft) as eng:
            got = eng.submit(Request(prompt=prompt, max_new_tokens=10))
    finally:
        R.flash_attention_ref = orig
    assert len(calls) == dcfg.num_layers        # one draft prefill
    assert got.tokens == want
    assert got.tokens == greedy_generate(target, torch.from_numpy(prompt),
                                         10, 64).tolist()
