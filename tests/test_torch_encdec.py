"""PyTorch port, the encoder-decoder family (``models/encdec.py``,
whisper-medium) against the JAX reference's ``EncDecLM``: reduced in f32
(2 encoder + 2 decoder layers, ``encoder_seq`` 8), the reference's weights
(key 0) carried over by ``load_jax_params``, tokens and frames made from a
seed with numpy.

* the config copies the reference's field for field;
* ``encode``, ``forward``'s logits, ``prefill``'s logits and its caches
  (the cross K / V of every layer, the self-attention K / V) within 1e-4
  absolute, and three ``decode_step``s against the reference's;
* the decode chain against the teacher-forced ``forward`` with the
  tolerances of ``tests/test_models.py::test_decode_matches_forward``
  (prefill atol 2e-3 / rtol 1e-3, each step atol 5e-3 / rtol 1e-2);
* under ``attn_impl="kernel"`` (the kernels' plain versions on the CPU) a
  spy on ``ops.flash_attention`` / ``ops.decode_attention``: the decoder's
  self-attention calls flash once per layer in ``forward`` and
  ``prefill`` and flash-decode once per layer in each one-token step; the
  encoder and the cross-attention call neither; the logits hold against
  the reference's under ``"xla"`` within 1e-4; a step past a hole takes
  the masked route;
* ``layers.attention_forward``'s ``mask``, ``kv_override`` and
  ``use_rope`` against the reference's with the same arguments (1e-5);
* ``build_model`` gives ``EncDecLM``; the ``Trainer`` refuses an encdec
  model (its pipeline gives no frames, as the reference's gives none)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models import layers as JL
from repro.models.registry import build_model as jax_build
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops
from repro_torch.launch.train import Trainer
from repro_torch.models import layers as L
from repro_torch.models.convert import load_jax_params
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

ARCH = "whisper-medium"
ATOL = 1e-4
B, S, MAX, STEPS = 2, 10, 24, 3


def _cfgs(attn_impl="xla"):
    jcfg = dataclasses.replace(jax_config(ARCH).reduced(dtype="float32"),
                               attn_impl=attn_impl)
    cfg = dataclasses.replace(get_config(ARCH).reduced(dtype="float32"),
                              attn_impl=attn_impl)
    return jcfg, cfg


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + STEPS)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.encoder_seq, cfg.d_model)
                                 ).astype(np.float32)
    return toks, frames


@pytest.fixture(scope="module")
def wm():
    """Both packages' reduced whisper on the reference's weights."""
    jcfg, cfg = _cfgs()
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jp)
    tm = load_jax_params(build_model(cfg, "cpu"), tree)
    toks, frames = _inputs(cfg)
    return {"jm": jm, "jp": jp, "tree": tree, "tm": tm, "cfg": cfg,
            "toks": toks, "frames": frames}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=atol, rtol=rtol)


def test_config_copies_the_reference():
    from repro.configs import whisper_medium as jax_whisper
    from repro_torch.configs import whisper_medium
    assert dataclasses.asdict(whisper_medium.CONFIG) == \
        dataclasses.asdict(jax_whisper.CONFIG)
    assert dataclasses.asdict(get_config(ARCH).reduced()) == \
        dataclasses.asdict(jax_config(ARCH).reduced())
    cfg = get_config(ARCH)
    assert (cfg.num_layers, cfg.encoder_layers, cfg.encoder_seq,
            cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.ffn_activation,
            cfg.tie_embeddings) == (24, 24, 1500, 1024, 16, 16, 64, 4096,
                                    51865, "gelu", True)


def test_build_model_gives_the_encdec_model(wm):
    assert isinstance(wm["tm"], EncDecLM)
    names = {n for n, _ in wm["tm"].named_parameters()}
    assert "enc.1.attn.wq" in names and "dec.1.cross_attn.wv" in names
    assert "dec.0.ln_x" in names and "head" not in names
    assert not any(p.requires_grad for p in wm["tm"].parameters())


def test_encode_matches_the_reference(wm):
    want = wm["jm"].encode(wm["jp"], jnp.asarray(wm["frames"]))
    with torch.no_grad():
        got = wm["tm"].encode(_t(wm["frames"]))
    _close(got, want)


def test_forward_matches_the_reference(wm):
    toks = wm["toks"][:, :S]
    want, jaux = wm["jm"].forward(wm["jp"], jnp.asarray(toks),
                                  jnp.asarray(wm["frames"]))
    with torch.no_grad():
        got, aux = wm["tm"].forward(_t(toks).long(), _t(wm["frames"]))
    assert got.shape == (B, S, wm["cfg"].vocab_size)
    _close(got, want)
    assert float(aux) == float(jaux) == 0.0


def _prefills(wm):
    toks = wm["toks"][:, :S]
    jlast, jcache = wm["jm"].prefill(wm["jp"], jnp.asarray(toks), MAX,
                                     jnp.asarray(wm["frames"]))
    with torch.no_grad():
        last, cache = wm["tm"].prefill(_t(toks).long(), MAX,
                                       _t(wm["frames"]))
    return jlast, jcache, last, cache


def test_prefill_logits_and_caches_match_the_reference(wm):
    jlast, jcache, last, cache = _prefills(wm)
    _close(last, jlast)
    for kv in ("k", "v"):
        _close(cache["cross"][kv], jcache["cross"][kv])
        for l, c in enumerate(cache["self"]):
            _close(c[kv], jcache["self"][kv][l])
    for l, c in enumerate(cache["self"]):
        np.testing.assert_array_equal(c["pos_map"].numpy(),
                                      np.asarray(jcache["self"]["pos_map"][l]))
    assert cache["written"] == S


def test_decode_steps_match_the_reference_and_the_forward(wm):
    """Three one-token steps: each against the reference's step (1e-4) and
    against the teacher-forced forward over the longer sequence (the
    tolerances of the reference's own decode test)."""
    jlast, jcache, last, cache = _prefills(wm)
    toks, frames = wm["toks"], wm["frames"]
    with torch.no_grad():
        full, _ = wm["tm"].forward(_t(toks[:, :S]).long(), _t(frames))
    _close(last, full[:, -1].numpy(), atol=2e-3, rtol=1e-3)
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jlg, jcache, _ = wm["jm"].decode_step(wm["jp"], jcache,
                                              jnp.asarray(tok), S + i)
        with torch.no_grad():
            lg, cache, taps = wm["tm"].decode_step(cache, _t(tok).long(),
                                                   S + i)
            full, _ = wm["tm"].forward(_t(toks[:, :S + i + 1]).long(),
                                       _t(frames))
        assert taps == {} and cache["written"] == S + i + 1
        _close(lg, jlg)
        _close(lg[:, -1], full[:, -1].numpy(), atol=5e-3, rtol=1e-2)


# ---------------------------------------------------------------- routes


def _spy(monkeypatch):
    calls = {"flash": [], "decode": []}
    flash, decode = ops.flash_attention, ops.decode_attention

    def spy_flash(q, k, v, **kw):
        calls["flash"].append(tuple(q.shape))
        return flash(q, k, v, **kw)

    def spy_decode(q, k, v, lengths):
        calls["decode"].append(tuple(q.shape))
        return decode(q, k, v, lengths)
    monkeypatch.setattr(ops, "flash_attention", spy_flash)
    monkeypatch.setattr(ops, "decode_attention", spy_decode)
    return calls


def test_kernel_routes_cover_the_decoder_self_attention_only(wm,
                                                             monkeypatch):
    """``attn_impl="kernel"``: flash once per decoder layer in ``forward``
    and ``prefill`` (at the decoder's [B, S, H, hd]; never at the encoder's
    length), flash-decode once per decoder layer in each one-token step;
    the logits equal the reference's under ``"xla"`` within 1e-4."""
    _, cfg = _cfgs("kernel")
    tm = load_jax_params(build_model(cfg, "cpu"), wm["tree"])
    calls = _spy(monkeypatch)
    toks, frames = wm["toks"], wm["frames"]
    H, hd, Ld = cfg.num_heads, cfg.head_dim, cfg.num_layers
    with torch.no_grad():
        logits, _ = tm.forward(_t(toks[:, :S]).long(), _t(frames))
    assert calls == {"flash": [(B, S, H, hd)] * Ld, "decode": []}
    want, _ = wm["jm"].forward(wm["jp"], jnp.asarray(toks[:, :S]),
                               jnp.asarray(frames))
    _close(logits, want)
    calls["flash"].clear()
    jlast, jcache, _, _ = _prefills(wm)
    with torch.no_grad():
        last, cache = tm.prefill(_t(toks[:, :S]).long(), MAX, _t(frames))
    assert calls == {"flash": [(B, S, H, hd)] * Ld, "decode": []}
    _close(last, jlast)
    calls["flash"].clear()
    for i in range(STEPS):
        tok = toks[:, S + i:S + i + 1]
        jlg, jcache, _ = wm["jm"].decode_step(wm["jp"], jcache,
                                              jnp.asarray(tok), S + i)
        with torch.no_grad():
            lg, cache, _ = tm.decode_step(cache, _t(tok).long(), S + i)
        _close(lg, jlg)
    assert calls == {"flash": [], "decode": [(B, H, hd)] * Ld * STEPS}


def test_a_step_past_a_hole_takes_the_masked_route(wm, monkeypatch):
    """A step that starts past ``written`` leaves a position no block
    wrote: it and every later step run the pos_map-masked ``mha``, and
    match the reference's step, which reads the same mask."""
    _, cfg = _cfgs("kernel")
    tm = load_jax_params(build_model(cfg, "cpu"), wm["tree"])
    toks, frames = wm["toks"], wm["frames"]
    jlast, jcache, _, _ = _prefills(wm)
    with torch.no_grad():
        _, cache = tm.prefill(_t(toks[:, :S]).long(), MAX, _t(frames))
    calls = _spy(monkeypatch)
    for pos in (S + 1, S + 2):             # position S is never written
        tok = toks[:, pos:pos + 1]
        jlg, jcache, _ = wm["jm"].decode_step(wm["jp"], jcache,
                                              jnp.asarray(tok), pos)
        with torch.no_grad():
            lg, cache, _ = tm.decode_step(cache, _t(tok).long(), pos)
        _close(lg, jlg)
    assert calls == {"flash": [], "decode": []}
    assert cache["written"] == S


# ---------------------------------------------------------------- attention


def _attn_pair(seed):
    jcfg, cfg = _cfgs()
    rng = np.random.default_rng(seed)
    d, H, hd = cfg.d_model, cfg.num_heads, cfg.head_dim
    w = {n: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for n, s in (("wq", (d, H, hd)), ("wk", (d, H, hd)),
                      ("wv", (d, H, hd)), ("wo", (H, hd, d)))}
    mod = torch.nn.Module()
    for n, a in w.items():
        setattr(mod, n, torch.nn.Parameter(_t(a), requires_grad=False))
    x = rng.standard_normal((B, 7, d)).astype(np.float32)
    kv = [rng.standard_normal((B, 5, H, hd)).astype(np.float32)
          for _ in range(2)]
    mask = rng.random((B, 1, 1, 7, 7)) < 0.7
    mask[..., 0] = True                     # every query sees a key
    return jcfg, cfg, w, mod, x, kv, mask


@pytest.mark.parametrize("case", ["causal", "mask", "mask_no_rope",
                                  "kv_override", "kv_override_rope"])
def test_attention_forward_arguments_match_the_reference(case):
    """The new arguments with the reference's meaning: a ``mask`` used as
    given (rope on or off), ``kv_override`` supplying k / v with no rope on
    them (q rotated or not by ``use_rope``), and neither: causal."""
    jcfg, cfg, w, mod, x, kv, mask = _attn_pair(3)
    kw = {"causal": {}, "mask": {"mask": mask},
          "mask_no_rope": {"mask": mask, "use_rope": False},
          "kv_override": {"kv_override": kv, "use_rope": False},
          "kv_override_rope": {"kv_override": kv}}[case]
    jkw = {k: (tuple(jnp.asarray(a) for a in v) if k == "kv_override"
               else jnp.asarray(v) if k == "mask" else v)
           for k, v in kw.items()}
    tkw = {k: (tuple(_t(a) for a in v) if k == "kv_override"
               else _t(v) if k == "mask" else v) for k, v in kw.items()}
    want = JL.attention_forward({n: jnp.asarray(a) for n, a in w.items()},
                                jnp.asarray(x), jcfg, **jkw)
    got = L.attention_forward(mod, _t(x), cfg, **tkw)
    _close(got, want, atol=1e-5)


@pytest.mark.parametrize("case", ["mask", "kv_override"])
def test_a_mask_or_an_override_keeps_the_kernel_out(case, monkeypatch):
    """Under ``attn_impl="kernel"`` only causal self-attention with no mask
    and no override takes flash (the reference's conditions)."""
    _, cfg, _, mod, x, kv, mask = _attn_pair(4)
    cfg = dataclasses.replace(cfg, attn_impl="kernel")
    calls = _spy(monkeypatch)
    kw = {"mask": _t(mask)} if case == "mask" else \
        {"kv_override": tuple(_t(a) for a in kv), "use_rope": False}
    want = L.attention_forward(mod, _t(x), dataclasses.replace(
        cfg, attn_impl="xla"), **kw)
    got = L.attention_forward(mod, _t(x), cfg, **kw)
    assert calls["flash"] == []
    assert torch.equal(got, want)
    L.attention_forward(mod, _t(x), cfg)
    assert calls["flash"] == [(B, 7, cfg.num_heads, cfg.head_dim)]


# ---------------------------------------------------------------- training


def test_remat_gives_the_same_gradients():
    """Per-block remat of both stacks recomputes the same values: one loss
    gradient with ``remat`` on and off, parameter for parameter."""
    from repro_torch.models.train import make_loss_fn
    _, cfg = _cfgs()
    toks, frames = _inputs(cfg, seed=1)
    batch = {"tokens": _t(toks[:, :S]).long(), "labels":
             _t(toks[:, 1:S + 1]).long(), "frames": _t(frames)}
    grads = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        m = build_model(c, "cpu", seed=0)
        for p in m.parameters():
            p.requires_grad_(True)
        loss, _ = make_loss_fn(m, c)(batch)
        grads.append(torch.autograd.grad(loss, list(m.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_the_trainer_refuses_an_encdec_model():
    cfg = get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="frames"):
        Trainer(cfg, ShapeConfig("t", 16, 2, "train"), RunConfig(),
                device="cpu")
