"""PyTorch port, one train step (``models/train.py`` with ``optim/*``)
against the reference's ``jax.jit(make_train_step(...))`` from the same
weights and batch: reduced mixtral (plain, ``microbatch=2``,
``grad_compress``, ``adamw8bit``), deepseek, llama3.2-3b, the vlm
(llava-next-mistral-7b), the encdec whisper-medium (with a ``frames``
batch) and the SSD families mamba2-780m and zamba2-7b (plain and
``microbatch=2``; their scan is the plain ``ssd_ref`` in both packages),
f32.

Tolerances: ``loss``, ``ce``, ``aux_loss``, ``grad_norm`` and ``lr`` within
1e-5 relative; the AdamW moments within 1e-5; the parameters after the step
within 1e-6, or 1e-6 + 2·lr where the reference's gradient is below 1e-6 in
magnitude (at step 1 Adam's update is nearly sign(g), so a gradient that
small moves its weight by anything up to lr on either side).  With int8
states or int8 gradients a value on a rounding boundary may land one
quantum apart: the dequantised moments and the compressed gradients'
residuals within one quantum of their block's scale, and the parameters
within 1e-6 + 2·lr.  A microbatched step casts the averaged gradients to
bf16 and clips them in bf16 (both packages): for the SSD families'
microbatch cases, whose step-1 gradients reach 0.14 at this size, an
element whose f32 values differ in the last bits may round one bf16 step
apart (2^-7 of it at most), so their moments hold within 1e-5 plus that
step's share (m: 2^-7 |m|, v: 2^-6 |v|); their parameters keep 1e-6.

Also, within the port: remat ``full`` / ``selective`` / off give the same
step; the vlm's logits cover its text only; ``load_jax_params`` keeps the
gradients the trainer turned on; an encdec batch without frames raises;
and the kernel guard: a train step under ``attn_impl="kernel"`` raises
naming flash attention (mixtral and whisper, whose decoder self-attention
takes the kernel), the SSD families' train step never calls the scan
kernel's wrapper, and serving under ``attn_impl="kernel"`` still runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JaxRunConfig
from repro.configs.registry import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro.models.train import make_train_step as jax_train_step
from repro.optim.grad_compress import init_error_feedback as jax_ef
from repro.optim.optimizer import dequantize_i8 as jax_dequantize_i8
from repro.optim.optimizer import make_optimizer as jax_optimizer
from repro.optim.optimizer import warmup_cosine as jax_warmup_cosine
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config
from repro_torch.models.convert import (load_jax_params, params_from_jax,
                                        stack_groups)
from repro_torch.models.registry import build_model
from repro_torch.models.train import make_train_step
from repro_torch.optim.grad_compress import init_error_feedback
from repro_torch.optim.optimizer import (QBLOCK, block_units,
                                         dequantize_stack,
                                         make_optimizer, warmup_cosine)

torch.set_num_threads(1)  # pytest -n: several processes share the cores

RTOL = 1e-5
LR = 1e-3
# cases whose moments carry the bf16 step's share (see the docstring)
BF16_GRAD_CASES = ("mamba2-microbatch2", "zamba2-microbatch2")
B, S = 4, 32
CASES = {
    "mixtral": ("mixtral-8x7b", 0, "adamw", False),
    "mixtral-microbatch2": ("mixtral-8x7b", 2, "adamw", False),
    "mixtral-grad_compress": ("mixtral-8x7b", 0, "adamw", True),
    "mixtral-adamw8bit": ("mixtral-8x7b", 0, "adamw8bit", False),
    "deepseek": ("deepseek-v2-lite-16b", 0, "adamw", False),
    "llama": ("llama3.2-3b", 0, "adamw", False),
    "vlm": ("llava-next-mistral-7b", 0, "adamw", False),
    "whisper": ("whisper-medium", 0, "adamw", False),
    "mamba2": ("mamba2-780m", 0, "adamw", False),
    "mamba2-microbatch2": ("mamba2-780m", 2, "adamw", False),
    "zamba2": ("zamba2-7b", 0, "adamw", False),
    "zamba2-microbatch2": ("zamba2-7b", 2, "adamw", False),
}


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.standard_normal(
            (B, cfg.num_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _port_model(cfg, jp):
    tm = build_model(cfg, "cpu")
    for p in tm.parameters():
        p.requires_grad_(True)
    return load_jax_params(tm, jax.tree.map(np.asarray, jp))


def _run_port(tm, cfg, microbatch, opt_name, compress, batch, remat=None):
    if remat is not None:
        tm.cfg = dataclasses.replace(cfg, remat=remat[0],
                                     remat_policy=remat[1])
    opt = make_optimizer(opt_name, warmup_cosine(LR, 2, 100),
                         groups=stack_groups(dict(tm.named_parameters()),
                                             QBLOCK))
    step = make_train_step(tm, tm.cfg, RunConfig(microbatch=microbatch), opt,
                           grad_compress=compress)
    params = dict(tm.named_parameters())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if compress:
        return step(params, opt.init(params), tb,
                    init_error_feedback(params))
    return step(params, opt.init(params), tb)


@pytest.fixture(scope="module", params=sorted(CASES))
def stepped(request):
    """Both steps from the reference's weights (key 0) and one batch."""
    arch, microbatch, opt_name, compress = CASES[request.param]
    jcfg = jax_config(arch).reduced(dtype="float32")
    cfg = get_config(arch).reduced(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jopt = jax_optimizer(opt_name, jax_warmup_cosine(LR, 2, 100))
    jstep = jax.jit(jax_train_step(jm, jcfg, JaxRunConfig(
        microbatch=microbatch), jopt, grad_compress=compress))
    args = [jp, jopt.init(jp), {k: jnp.asarray(v) for k, v in batch.items()}]
    if compress:
        args.append(jax_ef(jp))
    jout = jax.tree.map(np.asarray, jstep(*args))
    jdeq = {}
    if opt_name == "adamw8bit":     # the reference's stacked leaves
        for qf, sf in (("m_q", "m_s"), ("v_q", "v_s")):
            jdeq[qf] = jax.tree.map(
                lambda q, sc, p: np.asarray(jax_dequantize_i8(q, sc,
                                                              p.shape)),
                getattr(jout[1], qf), getattr(jout[1], sf), jp)
    tm = _port_model(cfg, jp)
    out = _run_port(tm, cfg, microbatch, opt_name, compress, batch)
    return {"case": request.param, "jout": jout, "out": out,
            "opt": opt_name, "compress": compress, "jdeq": jdeq}


def test_metrics_match_the_reference(stepped):
    jm, m = stepped["jout"][-1], stepped["out"][-1]
    for k in ("loss", "ce", "aux_loss", "grad_norm", "lr"):
        want, got = float(jm[k]), float(m[k])
        assert abs(got - want) <= RTOL * max(abs(want), 1e-6), (k, got, want)


def _clip(stepped) -> float:
    """The reference step's gradient clipping factor (grad_clip 1)."""
    return min(1.0, 1.0 / float(stepped["jout"][-1]["grad_norm"]))


def _bound(tree, factor):
    """Per element of the port's layout: ``factor`` times the largest
    magnitude of its reference leaf (a whole stacked [L, ...] tensor)."""
    return params_from_jax(jax.tree.map(
        lambda a: np.full(a.shape, np.abs(a).max() * factor, np.float32),
        tree))


def _close(got, want, bound, name):
    diff = np.abs(got - want)
    assert (diff <= bound).all(), (name, float(diff.max()))


def test_optimizer_state_matches_the_reference(stepped):
    """AdamW: the moments within 1e-5.  With compressed gradients the
    gradients may differ by one quantum of their block (at most the
    largest compressed gradient of the leaf over 127), which moves m by
    (1 - b1) and v by (1 - b2) times its effect; the residuals within
    one quantum.  AdamW8bit: the dequantised moments within one quantum
    of the leaf's largest magnitude over 127 (the blocks are the
    reference's stacked [L, ...] leaves' own: a layer whose tensor is no
    whole number of 256-blocks is quantized with the other layers of its
    stack, ``convert.stack_groups``, and dequantized through its
    group)."""
    jstate, state = stepped["jout"][1], stepped["out"][1]
    assert int(state.step) == int(jstate.step) == 1
    if stepped["opt"] == "adamw":
        want_m, want_v = params_from_jax(jstate.m), params_from_jax(jstate.v)
        assert set(want_m) == set(state.m) == set(state.v)
        if stepped["compress"]:
            g = _bound(jstate.m, 1 / 0.1 / _clip(stepped))
            q = {n: t / 127 for n, t in g.items()}
            for n, w in params_from_jax(stepped["jout"][2]).items():
                _close(stepped["out"][2][n].numpy(), w.numpy(),
                       q[n].numpy() + RTOL, n)
        for n in want_m:
            bm = bv = RTOL
            if stepped["case"] in BF16_GRAD_CASES:
                bm = RTOL + 2 ** -7 * np.abs(want_m[n].numpy())
                bv = RTOL + 2 ** -6 * np.abs(want_v[n].numpy())
            if stepped["compress"]:
                qn, gn = q[n].numpy(), g[n].numpy()
                bm = RTOL + 0.1 * qn
                bv = RTOL + 0.05 * qn * (2 * gn + qn)
            _close(state.m[n].numpy(), want_m[n].numpy(), bm, n)
            _close(state.v[n].numpy(), want_v[n].numpy(), bv, n)
        return
    units = block_units(stepped["out"][0],
                        stack_groups(stepped["out"][0], QBLOCK))
    for qf, sf in (("m_q", "m_s"), ("v_q", "v_s")):
        want = params_from_jax(stepped["jdeq"][qf])
        bound = _bound(stepped["jdeq"][qf], 1 / 127 * (1 + 1e-4))
        q, s = getattr(state, qf), getattr(state, sf)
        got = {}
        for key, names in units.items():
            got.update(zip(names, dequantize_stack(
                q[key], s[key], [want[n] for n in names])))
        for n, w in want.items():
            _close(got[n].numpy(), w.numpy(), bound[n].numpy() + 1e-12, n)


def test_parameters_after_the_step_match_the_reference(stepped):
    jparams = params_from_jax(stepped["jout"][0])
    params = stepped["out"][0]
    assert set(jparams) == set(params)
    lr = float(stepped["jout"][-1]["lr"])
    exact = stepped["opt"] == "adamw" and not stepped["compress"]
    if exact:   # at step 1, m = (1 - b1) · clip · g
        g = {n: t.numpy() / 0.1 / _clip(stepped)
             for n, t in params_from_jax(stepped["jout"][1].m).items()}
    for n, want in jparams.items():
        diff = np.abs(params[n].detach().numpy() - want.numpy())
        if exact:
            tiny = np.abs(g[n]) < 1e-6
            assert (diff[~tiny] <= 1e-6).all(), n
            assert (diff[tiny] <= 1e-6 + 2 * lr).all(), n
        else:
            assert (diff <= 1e-6 + 2 * lr).all(), n


def test_configs_copy_the_reference():
    """``ShapeConfig``, ``SHAPES``, ``shape_applicable``, ``RunConfig`` and
    the llava config, field for field."""
    from repro.configs import base as jax_base
    from repro.configs import llava_next_mistral_7b as jax_llava
    from repro_torch.configs import base
    from repro_torch.configs import llava_next_mistral_7b as llava
    from repro_torch.configs.registry import ARCHS
    assert dataclasses.asdict(llava.CONFIG) == \
        dataclasses.asdict(jax_llava.CONFIG)
    assert dataclasses.asdict(llava.CONFIG.reduced()) == \
        dataclasses.asdict(jax_llava.CONFIG.reduced())
    assert dataclasses.asdict(base.RunConfig()) == \
        dataclasses.asdict(jax_base.RunConfig())
    assert {n: dataclasses.asdict(c) for n, c in base.SHAPES.items()} == \
        {n: dataclasses.asdict(c) for n, c in jax_base.SHAPES.items()}
    for arch in ARCHS:
        for name, shape in base.SHAPES.items():
            assert base.shape_applicable(get_config(arch), shape) == \
                jax_base.shape_applicable(jax_config(arch),
                                          jax_base.SHAPES[name])
    assert base.SHAPES["train_4k"].tokens == 4096 * 256


# ---------------------------------------------------------------- within the port


def _fresh(arch="mixtral-8x7b", **over):
    cfg = dataclasses.replace(get_config(arch).reduced(dtype="float32"),
                              **over)
    tm = build_model(cfg, "cpu", seed=0)
    for p in tm.parameters():
        p.requires_grad_(True)
    return cfg, tm


@pytest.mark.parametrize("remat", [(True, "selective"), (False, "full")],
                         ids=["selective", "off"])
def test_remat_policies_give_the_same_step(remat):
    """Per-layer remat recomputes the same values: a step with remat
    ``selective`` or off equals one with ``full``, parameter for
    parameter."""
    cfg, tm = _fresh()
    batch = _batch(cfg)
    _run_port(tm, cfg, 2, "adamw", False, batch, remat=(True, "full"))
    want = {n: p.detach().clone() for n, p in tm.named_parameters()}
    cfg, tm = _fresh()
    _, _, metrics = _run_port(tm, cfg, 2, "adamw", False, batch, remat=remat)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)
    assert np.isfinite(float(metrics["loss"]))


def test_selective_remat_saves_the_projections():
    """The selective policy keeps the outputs of products with no batch
    dimension and recomputes the rest."""
    from torch.utils.checkpoint import CheckpointPolicy

    from repro_torch.models.transformer import _save_matmuls
    aten = torch.ops.aten
    one = torch.zeros(1, 4, 4)
    many = torch.zeros(3, 4, 4)
    assert _save_matmuls(None, aten.mm.default, one[0], one[0]) == \
        CheckpointPolicy.MUST_SAVE
    assert _save_matmuls(None, aten.bmm.default, one, one) == \
        CheckpointPolicy.MUST_SAVE
    assert _save_matmuls(None, aten.bmm.default, many, many) == \
        CheckpointPolicy.PREFER_RECOMPUTE
    assert _save_matmuls(None, aten.silu.default, one) == \
        CheckpointPolicy.PREFER_RECOMPUTE


def test_vlm_logits_cover_the_text_and_prefill_takes_the_patches():
    jcfg = jax_config("llava-next-mistral-7b").reduced(dtype="float32")
    cfg = get_config("llava-next-mistral-7b").reduced(dtype="float32")
    jm = jax_build(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = load_jax_params(build_model(cfg, "cpu"),
                         jax.tree.map(np.asarray, jp))
    batch = _batch(cfg)
    toks, pe = batch["tokens"], batch["patch_embeds"]
    jl, _ = jm.forward(jp, jnp.asarray(toks), patch_embeds=jnp.asarray(pe))
    with torch.no_grad():
        tl, _ = tm.forward(torch.from_numpy(toks),
                           patch_embeds=torch.from_numpy(pe))
        assert tl.shape == (B, S, cfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        jlast, _ = jm.prefill(jp, jnp.asarray(toks), 64,
                              patch_embeds=jnp.asarray(pe))
        tlast, cache = tm.prefill(torch.from_numpy(toks), 64,
                                  patch_embeds=torch.from_numpy(pe))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), atol=1e-4,
                               rtol=0)
    assert cache["written"] == cfg.num_patches + S
    with pytest.raises(ValueError, match="patch_embeds"):
        tm.forward(torch.from_numpy(toks))


def test_load_jax_params_keeps_the_trainers_gradients():
    jcfg = jax_config("mixtral-8x7b").reduced(dtype="float32")
    jp = jax_build(jcfg).init(jax.random.PRNGKey(0))
    cfg, tm = _fresh()
    load_jax_params(tm, jax.tree.map(np.asarray, jp))
    assert all(p.requires_grad for p in tm.parameters())
    served = load_jax_params(build_model(cfg, "cpu"),
                             jax.tree.map(np.asarray, jp))
    assert not any(p.requires_grad for p in served.parameters())


# ---------------------------------------------------------------- the guard


def _refused_under_the_kernel(arch):
    cfg, tm = _fresh(arch, attn_impl="kernel")
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    with pytest.raises(RuntimeError, match="flash_attention"):
        _run_port(tm, cfg, 0, "adamw", False, _batch(cfg))
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), before[n]), n


def test_a_train_step_under_the_attention_kernel_raises():
    """Flash attention has no backward: the step raises naming it, as the
    reference's ``jax.grad`` through its Pallas kernel fails; it never
    trains with the attention gradient missing."""
    _refused_under_the_kernel("mixtral-8x7b")


def test_a_whisper_train_step_under_the_attention_kernel_raises():
    """whisper's decoder self-attention takes the kernel (its encoder and
    cross-attention run ``mha``, as the reference's do), so its step is
    refused the same way."""
    _refused_under_the_kernel("whisper-medium")


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_ssd_family_train_step_takes_the_plain_scan(arch, monkeypatch):
    """The train-mode forward scans with ``ref.ssd_ref`` (the reference's
    route), never through the kernel's wrapper ``ops.ssd``, whose guard
    still raises under autograd; a served prefill of the same model calls
    the wrapper once per mamba layer."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as R
    from repro_torch.models import mamba as M
    calls = {"ops": 0, "ref": 0}
    wrapper, plain = ops.ssd, R.ssd_ref

    def spy(name, fn):
        def inner(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return inner
    monkeypatch.setattr(M.ops, "ssd", spy("ops", wrapper))
    monkeypatch.setattr(M.R, "ssd_ref", spy("ref", plain))
    cfg, tm = _fresh(arch)
    mamba = sum(1 for _, blk, _ in tm._sites(None) if blk.kind == "mamba")
    _, _, metrics = _run_port(tm, cfg, 0, "adamw", False, _batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    # the forward and the remat recompute of each mamba block
    assert calls == {"ops": 0, "ref": 2 * mamba}
    with torch.no_grad():
        tm.prefill(torch.from_numpy(_batch(cfg)["tokens"][:1]).long(), 64)
    assert calls["ops"] == mamba
    x = torch.zeros((1, 16, 2, 4), requires_grad=True)
    with pytest.raises(RuntimeError, match="SSD-family"):
        wrapper(x, torch.ones((1, 16, 2)), -torch.ones(2),
                torch.zeros((1, 16, 4)), torch.zeros((1, 16, 4)), 16)


def test_an_encdec_batch_needs_frames():
    from repro_torch.models.train import make_loss_fn
    cfg, tm = _fresh("whisper-medium")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()
             if k != "frames"}
    with pytest.raises(ValueError, match="frames"):
        make_loss_fn(tm, cfg)(batch)


def test_serving_under_the_attention_kernel_is_unaffected():
    """The guard acts only where autograd records: the served model (no
    parameter requires grad) runs its full-sequence pass and a decode step
    through the kernels' plain versions, under grad mode or not."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(
        dtype="float32"), attn_impl="kernel")
    tm = build_model(cfg, "cpu", seed=0)
    toks = torch.from_numpy(_batch(cfg)["tokens"][:1, :16].astype(np.int64))
    logits = tm.score(toks)
    _, cache = tm.prefill(toks[:, :15], 32)
    step, _, _ = tm.decode_step(cache, toks[:, 15:], 15)
    np.testing.assert_allclose(step[:, 0].detach().numpy(),
                               logits[:, 15].detach().numpy(), atol=1e-4,
                               rtol=0)
