"""PyTorch port, the dense targets of the reference's assigned pool that
came last: command-r-35b (swiglu, tied embeddings), granite-20b (48 q heads
on one kv head, a two-matrix gelu FFN) and nemotron-4-340b (head dim 192,
a squared-ReLU FFN), reduced in f32 with the JAX reference's weights
(through ``params_from_jax``).

* the configs copy the reference's field for field;
* ``prefill`` and one ``decode_step`` block against the reference's
  ``DecoderLM`` (logits and caches at atol 1e-4, as
  tests/test_torch_model.py);
* under ``attn_impl="kernel"`` the prefill runs flash attention's plain
  version once per layer and every one-token step flash-decode's (spies on
  ``ref.flash_attention_ref`` / ``ref.decode_attention_ref``), and the
  logits hold against the reference run the same way;
* ``Engine`` greedy x none and sd x none (the derived half-depth draft)
  emit the JAX engine's tokens wherever the reference's top-2 margin
  exceeds 1e-3, the rule of tests/test_torch_engine.py (a near tie may
  flip on either side, after which the streams part);
* every decode policy x offload none emits the port's own greedy tokens;
* the launcher serves each (``--arch``).

Reduced configs keep what sets these models apart: granite's single kv
head, nemotron's relu2 FFN and untied head, command-r's tied embeddings.
Prompts are made from a seed with numpy."""
import dataclasses
import sys

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
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (DECODE_POLICIES, Engine, EngineConfig,
                                     Request, derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.kernels import ref as R
from repro_torch.launch import serve as launcher
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

ARCHS = ("command-r-35b", "granite-20b", "nemotron-4-340b")
ATOL = 1e-4
MARGIN = 1e-3
TOK, MAX_SEQ, PROMPT = 12, 64, 16

# (layers, d, q heads, kv heads, head dim, d_ff, vocab, activation, tied)
PUBLISHED = {
    "command-r-35b": (40, 8192, 64, 8, 128, 22528, 256000, "swiglu", True),
    "granite-20b": (52, 6144, 48, 1, 128, 24576, 49152, "gelu", False),
    "nemotron-4-340b": (96, 18432, 96, 8, 192, 73728, 256000, "relu2",
                        False),
}


def _pair(arch, attn_impl):
    jcfg = dataclasses.replace(jax_config(arch).reduced(dtype="float32"),
                               attn_impl=attn_impl)
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              attn_impl=attn_impl)
    return jcfg, cfg


@pytest.fixture(scope="module", params=ARCHS)
def dn(request):
    """One arch: both packages' reduced target and derived draft on the
    reference's weights (seeds 0 / 1), a prompt and the port's greedy."""
    arch = request.param
    jcfg, cfg = _pair(arch, "xla")
    jm, jdm = jax_build(jcfg), jax_build(jax_derive(jcfg))
    jtp = jm.init(jax.random.PRNGKey(0))
    jdp = jdm.init(jax.random.PRNGKey(1))
    ntp = jax.tree.map(np.asarray, jtp)
    target = load_jax_params(build_model(cfg, "cpu"), ntp)
    draft = load_jax_params(build_model(derive_draft_config(cfg), "cpu"),
                            jax.tree.map(np.asarray, jdp))
    prompt = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                               (1, PROMPT))
    ref = greedy_generate(target, torch.from_numpy(prompt), TOK,
                          MAX_SEQ).tolist()
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jm=jm, jtp=jtp, jdp=jdp,
                ntp=ntp, target=target, draft=draft, prompt=prompt, ref=ref)


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(R, name)

    def spy(q, *a, **kw):
        calls.append(tuple(q.shape))
        return orig(q, *a, **kw)
    monkeypatch.setattr(R, name, spy)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_the_reference(arch):
    port, ref = get_config(arch), jax_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced(dtype="float32")) == \
        dataclasses.asdict(ref.reduced(dtype="float32"))
    assert (port.num_layers, port.d_model, port.num_heads,
            port.num_kv_heads, port.head_dim, port.d_ff, port.vocab_size,
            port.ffn_activation, port.tie_embeddings) == PUBLISHED[arch]
    assert port.family == "dense" and not port.is_moe
    small = port.reduced(dtype="float32")
    assert small.ffn_activation == port.ffn_activation
    assert small.num_kv_heads == min(port.num_kv_heads, 4)
    assert derive_draft_config(small).num_layers == small.num_layers // 2


def test_prefill_and_decode_block_match_jax(dn):
    jm, jtp, target = dn["jm"], dn["jtp"], dn["target"]
    prompt = dn["prompt"]
    block = np.random.default_rng(3).integers(0, dn["cfg"].vocab_size,
                                              (1, 5))
    jl0, jc = jm.prefill(jtp, jnp.asarray(prompt), MAX_SEQ)
    jl1, jc, _ = jm.decode_step(jtp, jc, jnp.asarray(block), PROMPT)
    tl0, tc = target.prefill(torch.from_numpy(prompt), MAX_SEQ)
    tl1, tc, _ = target.decode_step(tc, torch.from_numpy(block), PROMPT)
    np.testing.assert_allclose(tl0.numpy(), np.asarray(jl0), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(tl1.numpy(), np.asarray(jl1), atol=ATOL,
                               rtol=0)
    for l in range(dn["cfg"].num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc["layers"][l][name].numpy(),
                                       np.asarray(jc["layers"][name][l]),
                                       atol=ATOL, rtol=0)
    if dn["cfg"].tie_embeddings:
        assert not hasattr(target, "head")


def test_kernel_route_runs_flash_and_flash_decode(dn, monkeypatch):
    """The same weights under ``attn_impl="kernel"`` on both sides (the
    reference's flash attention in interpret mode): the prefill takes the
    flash route once per layer at this model's head shape, each one-token
    step the flash-decode route once per layer, and the logits hold."""
    jcfg, cfg = _pair(dn["arch"], "kernel")
    jm = jax_build(jcfg)
    target = load_jax_params(build_model(cfg, "cpu"), dn["ntp"])
    prompt = dn["prompt"]
    flash = _spy(monkeypatch, "flash_attention_ref")
    decode = _spy(monkeypatch, "decode_attention_ref")
    jl, jc = jm.prefill(dn["jtp"], jnp.asarray(prompt), MAX_SEQ)
    tl, tc = target.prefill(torch.from_numpy(prompt), MAX_SEQ)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=0)
    assert flash == [(1, PROMPT, cfg.num_heads, cfg.head_dim)] * \
        cfg.num_layers
    tok = jnp.argmax(jl, axis=-1)[:, None]          # prefill: [B, V]
    for pos in range(PROMPT, PROMPT + 3):
        jl, jc, _ = jm.decode_step(dn["jtp"], jc, tok, pos)
        tl, tc, _ = target.decode_step(tc, torch.from_numpy(np.array(tok)),
                                       pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"pos {pos}")
        tok = jnp.argmax(jl[:, -1], axis=-1)[:, None]
    assert decode == [(1, cfg.num_heads, cfg.head_dim)] * \
        (3 * cfg.num_layers)


def _jax_teacher_forced(dn, tokens):
    """The reference's logits over ``tokens`` emitted after the prompt:
    ``prefill`` of the prompt and one ``decode_step`` over the rest."""
    jm, jtp, prompt = dn["jm"], dn["jtp"], dn["prompt"]
    jl0, jc = jm.prefill(jtp, jnp.asarray(prompt), MAX_SEQ)
    rest = jnp.asarray(np.asarray(tokens[:-1])[None])
    jl1, _, _ = jm.decode_step(jtp, jc, rest, PROMPT)
    return np.concatenate([np.asarray(jl0), np.asarray(jl1)[0]])


@pytest.mark.parametrize("decode", ["greedy", "sd"])
def test_engine_matches_jax_engine(dn, decode):
    common = dict(decode=decode, draft_len=3, max_seq=MAX_SEQ)
    with JaxEngine(JaxEngineConfig(model=dn["jcfg"], **common), dn["jtp"],
                   dn["jdp"] if decode == "sd" else None) as jeng:
        want = jeng.submit(JaxRequest(prompt=jnp.asarray(dn["prompt"]),
                                      max_new_tokens=TOK)).tokens
    with Engine(EngineConfig(model=dn["cfg"], **common), dn["target"],
                dn["draft"] if decode == "sd" else None) as eng:
        got = eng.submit(Request(prompt=dn["prompt"], max_new_tokens=TOK))
    assert got.tokens == dn["ref"]
    assert len(want) == len(got.tokens) == TOK
    jl = _jax_teacher_forced(dn, want)
    top2 = np.sort(jl, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    assert clear.any()
    assert (np.asarray(want) == jl.argmax(-1)).all()
    for i, (g, w) in enumerate(zip(got.tokens, want)):
        if g != w:                  # the streams part at a near tie only
            assert not clear[i], (i, g, w)
            break


@pytest.mark.parametrize("decode", DECODE_POLICIES)
def test_decode_policies_emit_the_ports_greedy(dn, decode):
    with Engine(EngineConfig(model=dn["cfg"], decode=decode, draft_len=3,
                             max_draft_len=5, max_seq=MAX_SEQ),
                dn["target"],
                dn["draft"] if decode != "greedy" else None) as eng:
        res = eng.submit(Request(prompt=dn["prompt"], max_new_tokens=TOK))
    assert res.tokens == dn["ref"], decode
    assert res.finish_reason == "length"


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_the_arch(arch, capsys, monkeypatch):
    """``launch/serve.py --arch`` takes each: sd x none with the derived
    half-depth draft, its default for a dense target."""
    cfg, dcfg = launcher.reduced_pair(arch)
    assert dcfg == derive_draft_config(cfg)
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--arch", arch, "--tokens", "4",
        "--requests", "2"])
    launcher.main()
    out = capsys.readouterr().out
    for rid in ("req-0", "req-1"):
        assert f"[{rid}] finish=length" in out
    assert "cumulative: requests=2 tokens=8" in out
