"""PyTorch port, the SSD families: the Mamba2 block (``mamba_forward`` with
its prefill cache, ``mamba_decode``) and ``DecoderLM`` for reduced
mamba2-780m (ssm) and zamba2-7b (hybrid) against the JAX reference through
the weight bridge ``params_from_jax`` (forward, prefill with its caches,
recurrent decode steps); greedy x none serving against the reference
``Engine``; and what the port refuses: a draft-verifying decode policy over
an ssm or hybrid target, and a multi-token mamba decode step.

f32, atol 1e-4 on logits, inputs made from a seed with numpy."""
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
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.core.engine import Engine, EngineConfig, Request
from repro_torch.launch import serve as launcher
from repro_torch.models import mamba as M
from repro_torch.models.convert import load_jax_params, params_from_jax
from repro_torch.models.registry import build_model

ATOL = 1e-4
ARCHS = ["mamba2-780m", "zamba2-7b"]
# reduced configs: each arch as ``reduced`` cuts it, a zamba2 whose 7
# layers leave a tail after two groups of (2 mamba + the shared block), as
# zamba2-7b's 81 layers leave 3, and a zamba2 whose shared block keeps the
# full model's head dim, 112, under attn_impl="kernel" (both packages'
# flash kernel in every forward and prefill, the port's flash-decode in
# every one-token step; on the CPU the port runs their plain versions)
D112 = {"head_dim": 112, "attn_impl": "kernel"}
MODELS = {"mamba2-780m": ("mamba2-780m", {}), "zamba2-7b": ("zamba2-7b", {}),
          "zamba2-7b-tail": ("zamba2-7b", {"num_layers": 7,
                                           "attn_every": 3}),
          "zamba2-7b-d112": ("zamba2-7b", D112)}
LAYOUTS = {"zamba2-7b": (2, 1, 0), "zamba2-7b-tail": (2, 2, 1)}
# the reference's functions, compiled once per shape (much faster than
# running them op by op)
jax_mamba_forward = jax.jit(JM.mamba_forward, static_argnums=2)
jax_mamba_decode = jax.jit(JM.mamba_decode, static_argnums=3)
jax_prefill_cache = jax.jit(JT._mamba_prefill_cache, static_argnums=2)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


@pytest.fixture(scope="module", params=list(MODELS))
def pair(request):
    arch, over = MODELS[request.param]
    jcfg = jax_config(arch).reduced(dtype="float32", **over)
    cfg = get_config(arch).reduced(dtype="float32", **over)
    assert cfg.num_layers == jcfg.num_layers
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(build_model(cfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    return jm, jp, tm


def _jit(jm):
    """The reference model's forward / prefill / decode_step, compiled."""
    return (jax.jit(jm.forward), jax.jit(jm.prefill, static_argnums=2),
            jax.jit(jm.decode_step))


@pytest.fixture(scope="module")
def block():
    """One reduced mamba2 block's parameters on both sides."""
    cfg = get_config("mamba2-780m").reduced(dtype="float32")
    jp = JM.init_mamba(jax.random.PRNGKey(3),
                       jax_config("mamba2-780m").reduced(dtype="float32"),
                       jnp.float32)
    mod = M.Mamba(cfg, torch.float32, torch.device("cpu"),
                  torch.Generator().manual_seed(0))
    mod.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jp)))
    return cfg, jp, mod


def test_mamba_block_forward_and_prefill_cache_match_jax(block):
    """21 steps: chunks of 16, padded to 32 with dt = 0."""
    cfg, jp, mod = block
    jcfg = jax_config("mamba2-780m").reduced(dtype="float32")
    x = np.random.default_rng(21).standard_normal((2, 21, cfg.d_model)
                                                  ).astype(np.float32)
    want = jax_mamba_forward(jp, jnp.asarray(x), jcfg)
    got, cache = M.mamba_forward(mod, torch.from_numpy(x), cfg,
                                 with_cache=True)
    _close(got, want)
    jcache = jax_prefill_cache({"mamba": jp}, jnp.asarray(x), jcfg)
    _close(cache["ssm"], jcache["ssm"])
    _close(cache["conv"], jcache["conv"])


def test_mamba_block_decode_matches_jax(block):
    cfg, jp, mod = block
    jcfg = jax_config("mamba2-780m").reduced(dtype="float32")
    rng = np.random.default_rng(5)
    jc = JM.init_mamba_cache(jcfg, 2, jnp.float32)
    jc = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jc.items()}
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jy, jc = jax_mamba_decode(jp, jnp.asarray(x), jc, jcfg)
        ty, tc = M.mamba_decode(mod, torch.from_numpy(x), tc, cfg)
        _close(ty, jy)
        for k in ("ssm", "conv"):
            _close(tc[k], jc[k])
    with pytest.raises(ValueError, match="one token"):
        M.mamba_decode(mod, torch.zeros((2, 3, cfg.d_model)), tc, cfg)


def test_forward_matches_jax(pair):
    jm, jp, tm = pair
    tokens = np.random.default_rng(1).integers(0, 256, (2, 40))
    jl, _ = _jit(jm)[0](jp, jnp.asarray(tokens))
    tl, taux = tm.forward(torch.from_numpy(tokens))
    _close(tl, jl)
    assert taux.item() == 0.0


def test_prefill_and_decode_steps_match_jax(pair):
    """A 21-token prompt (chunks of 16, padded to 32) fills every cache as
    the reference does; then four recurrent steps."""
    jm, jp, tm = pair
    _, jprefill, jdecode = _jit(jm)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, (1, 21))
    jl, jc = jprefill(jp, jnp.asarray(prompt), 48)
    tl, tc = tm.prefill(torch.from_numpy(prompt), 48)
    _close(tl, jl)
    _check_caches(tm, tc, jc)
    for pos in range(21, 25):
        tok = rng.integers(0, 256, (1, 1))
        jl, jc, _ = jdecode(jp, jc, jnp.asarray(tok), pos)
        tl, tc, _ = tm.decode_step(tc, torch.from_numpy(tok), pos)
        _close(tl, jl)
    _check_caches(tm, tc, jc)


def _check_caches(tm, tc, jc):
    """Every site's cache against the reference's stacked one."""
    if tm.cfg.family == "ssm":
        for l, c in enumerate(tc["layers"]):
            for k in ("ssm", "conv"):
                _close(c[k], jc["layers"][k][l])
        return
    for g, group in enumerate(tc["mamba_groups"]):
        for i, c in enumerate(group):
            for k in ("ssm", "conv"):
                _close(c[k], jc["mamba_groups"][k][g, i])
        for k in ("k", "v", "pos_map"):
            _close(tc["shared_attn"][g][k], jc["shared_attn"][k][g])
    assert len(tc["tail"]) == (len(jc["tail"]["ssm"]) if "tail" in jc
                               else 0)
    for t, c in enumerate(tc["tail"]):
        for k in ("ssm", "conv"):
            _close(c[k], jc["tail"][k][t])


def test_bridge_unstacks_groups_and_keeps_the_shared_block(pair):
    _, jp, tm = pair
    state = params_from_jax(jax.tree.map(np.asarray, jp))
    assert set(state) == set(tm.state_dict())
    if tm.cfg.family == "hybrid":
        groups, per, tail = tm.hybrid_layout()
        assert (groups, per, tail) == LAYOUTS[
            "zamba2-7b-tail" if tm.cfg.num_layers == 7 else "zamba2-7b"]
        assert f"mamba_groups.1.{per - 1}.mamba.in_proj" in state
        assert "shared_attn.attn.wq" in state and "shared_attn.ffn.wg" in state
        assert torch.equal(
            state[f"mamba_groups.1.{per - 1}.mamba.A_log"],
            torch.from_numpy(np.array(jp["mamba_groups"]["mamba"]["A_log"]
                                      [1, per - 1])))
        assert ("tail" in jp) == bool(tail)
        for t in range(tail):
            assert torch.equal(
                state[f"tail.{t}.mamba.in_proj"],
                torch.from_numpy(np.array(jp["tail"]["mamba"]["in_proj"][t])))
    else:
        assert "layers.3.mamba.dt_bias" in state
        assert "layers.0.ln2" not in state


def test_greedy_engine_matches_jax_engine(pair):
    jm, jp, tm = pair
    prompt = np.random.default_rng(2).integers(0, 256, (1, 7))
    jcfg = JaxEngineConfig(model=jm.cfg, decode="greedy", offload="none",
                           max_seq=32)
    want = JaxEngine(jcfg, jp).submit(
        JaxRequest(prompt=jnp.asarray(prompt), max_new_tokens=10)).tokens
    config = EngineConfig(model=tm.cfg, decode="greedy", max_seq=32)
    eng = Engine(config, tm)
    got = eng.submit(Request(prompt=prompt, max_new_tokens=10))
    assert got.tokens == want
    assert got.finish_reason == "length"
    assert list(eng.stream(Request(prompt=prompt, max_new_tokens=10))) \
        == want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("decode", ["sd", "sd-adaptive"])
def test_draft_verifying_decode_over_an_ssd_target_raises(arch, decode):
    cfg = get_config(arch).reduced(dtype="float32")
    with pytest.raises(ValueError, match="greedy"):
        EngineConfig(model=cfg, decode=decode)
    assert EngineConfig(model=cfg, decode="greedy").decode == "greedy"


def test_seeded_init_and_the_hybrid_layout_at_full_width():
    cfg = get_config("mamba2-780m").reduced(dtype="float32")
    a, b, c = (build_model(cfg, "cpu", seed=s) for s in (3, 3, 4))
    assert torch.equal(a.layers[1].mamba.in_proj, b.layers[1].mamba.in_proj)
    assert not torch.equal(a.layers[1].mamba.in_proj,
                           c.layers[1].mamba.in_proj)
    assert a.layers[0].mamba.A_log.dtype == torch.float32
    z = get_config("zamba2-7b")
    full = build_model(z.reduced(dtype="float32", num_layers=81,
                                 attn_every=6), "cpu")
    assert full.hybrid_layout() == (13, 5, 3)     # zamba2-7b's 81 layers
    assert len(full.tail) == 3 and len(full.mamba_groups[12]) == 5


def test_launcher_serves_mamba_greedy_by_default(capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--arch", "mamba2-780m", "--tokens", "3",
        "--stream"])
    launcher.main()
    lines = capsys.readouterr().out.splitlines()
    assert [p.split(":")[0] for p in lines[0].split()] == ["req-0"] * 3
    assert "[req-0] finish=length" in lines
    monkeypatch.setattr(sys, "argv", [
        "serve", "--device", "cpu", "--arch", "zamba2-7b", "--decode", "sd"])
    with pytest.raises(ValueError, match="greedy"):
        launcher.main()


def test_zamba2_head_dim_112_takes_both_attention_kernels(monkeypatch):
    """Under ``attn_impl="kernel"`` the shared block at head dim 112 runs
    the flash kernel in the prefill and flash-decode in each one-token step
    (their plain versions here, which the wrappers take for CPU tensors),
    once per shared-block site, and gives the logits of the ``"xla"`` route
    (``mha``) of the same weights."""
    from repro_torch.kernels import ref as R
    cfg = get_config("zamba2-7b").reduced(dtype="float32", **D112)
    tm = build_model(cfg, "cpu", seed=0)
    xla = build_model(get_config("zamba2-7b").reduced(
        dtype="float32", head_dim=112), "cpu", seed=0)
    calls = {"flash": [], "decode": []}
    for name, key in (("flash_attention_ref", "flash"),
                      ("decode_attention_ref", "decode")):
        orig = getattr(R, name)

        def spy(q, *a, _orig=orig, _key=key, **kw):
            calls[_key].append(q.shape[-1])
            return _orig(q, *a, **kw)
        monkeypatch.setattr(R, name, spy)
    sites = tm.hybrid_layout()[0]
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 256,
                                                                (1, 21)))
    tl, tc = tm.prefill(prompt, 32)
    xl, xc = xla.prefill(prompt, 32)
    _close(tl, xl.detach().numpy())
    assert calls == {"flash": [112] * sites, "decode": []}
    for pos in range(21, 24):
        tok = prompt[:, pos - 21:pos - 20]
        tl, tc, _ = tm.decode_step(tc, tok, pos)
        xl, xc, _ = xla.decode_step(xc, tok, pos)
        _close(tl, xl.detach().numpy())
    assert calls["decode"] == [112] * (3 * sites)
