"""PyTorch port, the optimizers and gradient compression (``optim/*``)
against the reference (``repro.optim``): ``warmup_cosine`` at every step
of a schedule, ``quantize_i8`` (equal int8 values, scales within 1e-7),
``global_norm`` / ``clip_by_global_norm``, and the port's versions of
``tests/test_substrate.py``'s AdamW, AdamW8bit, quantization round-trip and
error-feedback tests; plus one AdamW and one AdamW8bit update of a small
tree against the reference's (f32, 1e-6).  The int8 blocks of the
reference's stacked leaves (``convert.stack_groups``): tiny llama3.2-3b,
mamba2-780m and zamba2-7b, the 8-bit state leaf by leaf after two updates,
and 3 ``Trainer`` steps' losses against the reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.optim import optimizer as JO
from repro_torch.optim.grad_compress import (compress_with_error_feedback,
                                             compressed_bytes_fraction,
                                             init_error_feedback)
from repro_torch.optim.optimizer import (QBLOCK, AdamW, AdamW8bit,
                                         clip_by_global_norm, dequantize_i8,
                                         global_norm, make_optimizer,
                                         quantize_i8, warmup_cosine)

torch.set_num_threads(1)  # pytest -n: several processes share the cores


@pytest.mark.parametrize("base,warm,total", [(3e-4, 100, 10000),
                                             (1e-3, 20, 60), (0.1, 2, 100),
                                             (1e-3, 0, 8)])
def test_warmup_cosine_matches_the_reference(base, warm, total):
    ours = warmup_cosine(base, warm, total)
    ref = JO.warmup_cosine(base, warm, total)
    steps = sorted(set(range(0, total + 2, max(1, total // 200)))
                   | {0, 1, warm, warm + 1, total})
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps, jnp.int32)))
    got = np.asarray([ours(s) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4096, 1000])
def test_quantize_i8_matches_the_reference(n):
    x = np.random.default_rng(n).standard_normal(n).astype(np.float32) * 3
    x[: n // 3] *= 1e-3                  # blocks of very different scales
    q, s = quantize_i8(torch.from_numpy(x))
    wq, ws = JO.quantize_i8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
    np.testing.assert_allclose(s.numpy(), np.asarray(ws), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(
        dequantize_i8(q, s, (n,)).numpy(),
        np.asarray(JO.dequantize_i8(wq, ws, (n,))))


def test_global_norm_and_clip_match_the_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((7, 5)).astype(np.float32),
            "b": rng.standard_normal(300).astype(np.float32)}
    want = float(JO.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = float(global_norm(torch.from_numpy(v) for v in tree.values()))
    assert abs(got - want) <= 1e-6 * want
    clipped, norm = clip_by_global_norm(
        {k: torch.from_numpy(v.copy()) for k, v in tree.items()}, 1.0)
    wclipped, _ = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    for k in tree:
        np.testing.assert_allclose(clipped[k].numpy(),
                                   np.asarray(wclipped[k]), atol=1e-7)


@pytest.mark.parametrize("name", ["adamw", "adamw8bit"])
def test_one_update_matches_the_reference(name):
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((4, 300)).astype(np.float32),
              "b": rng.standard_normal(7).astype(np.float32)}
    grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.1
             for k, v in params.items()}
    ref = JO.make_optimizer(name, JO.warmup_cosine(1e-2, 2, 10))
    jp = jax.tree.map(jnp.asarray, params)
    jstate = ref.init(jp)
    opt = make_optimizer(name, warmup_cosine(1e-2, 2, 10))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = opt.init(tp)
    for _ in range(3):
        jp, jstate, jm = ref.update(jax.tree.map(jnp.asarray, grads),
                                    jstate, jp)
        tp, state, m = opt.update({k: torch.from_numpy(v.copy())
                                   for k, v in grads.items()}, state, tp)
        assert abs(m["lr"] - float(jm["lr"])) <= 1e-9
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= 1e-5
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)
    assert int(state.step) == 3


# ------------------------------------------- tests/test_substrate.py, ported

def _optimize(opt, steps=60):
    params = {"w": torch.tensor([3.0, -2.0, 1.5]), "b": torch.tensor([0.5])}
    state = opt.init(params)
    for _ in range(steps):
        grads = {k: 2 * v for k, v in params.items()}   # d/dp of sum(p²)
        params, state, _ = opt.update(grads, state, params)
    return params


def test_adamw_converges_quadratic():
    opt = AdamW(warmup_cosine(0.1, 2, 100), weight_decay=0.0)
    params = _optimize(opt)
    assert float(params["w"].abs().max()) < 0.3


def test_adamw8bit_tracks_fp32():
    p32 = _optimize(AdamW(warmup_cosine(0.05, 2, 100), weight_decay=0.0))
    p8 = _optimize(AdamW8bit(warmup_cosine(0.05, 2, 100), weight_decay=0.0))
    for k in p32:
        np.testing.assert_allclose(p8[k].numpy(), p32[k].numpy(), atol=0.15)


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 1000))
def test_quantize_roundtrip_bounded(seed, n):
    x = np.random.default_rng(seed).normal(size=n).astype(np.float32) * 10
    q, s = quantize_i8(torch.from_numpy(x))
    back = dequantize_i8(q, s, (n,)).numpy()
    # error bounded by half a quantization step of the worst block
    assert np.abs(back - x).max() <= (np.abs(x).max() / 127.0) * 0.5 + 1e-6


def test_grad_compression_error_feedback_unbiased():
    """With EF, the *accumulated* applied gradient converges to the true sum
    (residual stays bounded)."""
    g = {"w": torch.full((300,), 0.003)}     # tiny gradient that int8 rounds
    ef = init_error_feedback(g)
    applied = torch.zeros(300)
    for _ in range(50):
        cg, ef = compress_with_error_feedback(g, ef)
        applied = applied + cg["w"]
    np.testing.assert_allclose(applied.numpy(), 50 * 0.003, rtol=0.05)


def test_compression_keeps_dtypes_and_counts_bytes():
    g = {"w": torch.randn(700, generator=torch.Generator().manual_seed(0)
                          ).to(torch.bfloat16)}
    cg, ef = compress_with_error_feedback(g, init_error_feedback(g))
    assert cg["w"].dtype == torch.bfloat16 and ef["w"].dtype == torch.float32
    assert compressed_bytes_fraction() == (1.0 + 4.0 / 256.0) / 4.0
    with pytest.raises(ValueError):
        make_optimizer("sgd", warmup_cosine(1e-3, 1, 10))


# ------------------------- the reference's stacked leaves (256-blocks)

# tiny configs: llama3.2-3b as tests/test_system.py's trainer (its norms
# are 32 a layer), mamba2-780m and zamba2-7b reduced (``A_log`` / ``D`` /
# ``dt_bias`` 8 a layer; zamba2 stacks ``mamba_groups`` on two axes), f32
STACK_ARCHS = {"llama3.2-3b": dict(num_layers=2, d_model=32, num_heads=2,
                                   num_kv_heads=2, head_dim=16, d_ff=64,
                                   vocab_size=128, dtype="float32"),
               "mamba2-780m": dict(dtype="float32"),
               "zamba2-7b": dict(dtype="float32")}


def _leaf_paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _reference_leaf(tree: dict, path: str, groups: dict) -> np.ndarray:
    """The port's state of the reference's leaf ``path``: its group's, or
    its layers' own blocks one after another (in the reference's order),
    or the parameter's own."""
    from repro_torch.models.convert import STACKED
    top, _, rest = path.partition(".")
    depth = STACKED.get(top, 0)
    if not depth:
        return tree[path].numpy()
    key = ".".join([top] + ["*"] * depth + [rest])
    if key in groups:
        return tree[key].numpy()
    names = [n for n in tree if n.startswith(top + ".")
             and n.split(".", 1 + depth)[-1] == rest]
    names.sort(key=lambda n: [int(i) for i in n.split(".")[1:1 + depth]])
    return np.concatenate([tree[n].numpy() for n in names])


def test_stack_groups_follow_the_references_flattening():
    """A group is a stacked leaf whose layer tensors are not whole blocks:
    its members in row-major order over the stacked axes (numerically:
    ``mamba_groups.10.0`` after ``mamba_groups.2.1``), weight matrices and
    one-layer stacks not grouped, no key a parameter's."""
    from repro_torch.models.convert import stack_groups
    shapes = {"wte": (256, 64), "ln_f": (64,), "shared_attn.ln1": (64,)}
    for g in (0, 2, 10):
        for i in (0, 1):
            shapes[f"mamba_groups.{g}.{i}.mamba.A_log"] = (112,)
            shapes[f"mamba_groups.{g}.{i}.mamba.in_proj"] = (64, 512)
    for t in (0, 1, 11):
        shapes[f"tail.{t}.mamba.conv_b"] = (7296,)
    shapes["layers.0.ln1"] = (32,)                 # one layer: its own
    params = {n: torch.zeros(s) for n, s in shapes.items()}
    groups = stack_groups(params, QBLOCK)
    assert groups == {
        "mamba_groups.*.*.mamba.A_log": [
            f"mamba_groups.{g}.{i}.mamba.A_log" for g in (0, 2, 10)
            for i in (0, 1)],
        "tail.*.mamba.conv_b": [f"tail.{t}.mamba.conv_b"
                                for t in (0, 1, 11)]}
    q = AdamW8bit(warmup_cosine(1e-3, 1, 10), groups=groups).init(params).m_q
    assert q["mamba_groups.*.*.mamba.A_log"].shape == (6 * 112 // 256 + 1,
                                                       256)
    assert q["tail.*.mamba.conv_b"].shape == (3 * 7296 // 256 + 1, 256)
    assert "mamba_groups.0.0.mamba.A_log" not in q
    assert q["layers.0.ln1"].shape == (1, 256)


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("arch", list(STACK_ARCHS))
def test_eight_bit_state_equals_the_references_leaf_by_leaf(arch, compress):
    """Two AdamW8bit updates (with int8 gradient compression or without)
    of the same seeded gradients of every parameter in both packages:
    after each, every leaf of the reference's int8 moments equals the
    port's (a group of ``convert.stack_groups``, or its layers' blocks one
    after another) exactly, and its scales within 1e-6 relative; compressed
    gradients and residuals within 1e-7.  The reference's update runs op
    by op, each product and sum rounded on its own, as the port's does
    (under ``jax.jit`` XLA may fuse a multiply-add: one int8 of mamba2's
    then moves by one step)."""
    from repro.configs.registry import get_config as jax_config
    from repro.models.registry import build_model as jax_build
    from repro.optim import grad_compress as JG
    from repro_torch.models.convert import params_from_jax, stack_groups
    cfg = jax_config(arch).reduced(**STACK_ARCHS[arch])
    tree = jax.tree.map(np.asarray, jax_build(cfg).init(
        jax.random.PRNGKey(0)))
    rng = np.random.default_rng(11)
    steps = [jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 1e-3
                                     ).astype(np.float32), tree)
             for _ in range(2)]
    ref = JO.make_optimizer("adamw8bit", JO.warmup_cosine(3e-3, 2, 40))
    jp = jax.tree.map(jnp.asarray, tree)
    jstate, jef = ref.init(jp), JG.init_error_feedback(jp)
    tp = params_from_jax(tree)
    groups = stack_groups(tp, QBLOCK)
    assert groups and all(len(m) > 1 for m in groups.values())
    opt = make_optimizer("adamw8bit", warmup_cosine(3e-3, 2, 40),
                         groups=groups)
    state, ef = opt.init(tp), init_error_feedback(tp)
    for g in steps:
        jg, tg = jax.tree.map(jnp.asarray, g), params_from_jax(g)
        if compress:
            jg, jef = JG.compress_with_error_feedback(jg, jef)
            tg, ef = compress_with_error_feedback(tg, ef, groups)
            for want, got in ((jg, tg), (jef, ef)):
                for n, t in params_from_jax(jax.tree.map(np.asarray,
                                                         want)).items():
                    np.testing.assert_allclose(got[n].numpy(), t.numpy(),
                                               atol=1e-7, rtol=0,
                                               err_msg=n)
        jp, jstate, _ = ref.update(jg, jstate, jp)
        tp, state, _ = opt.update(tg, state, tp)
        for field in ("m_q", "m_s", "v_q", "v_s"):
            for path, leaf in _leaf_paths(getattr(jstate, field)):
                got = _reference_leaf(getattr(state, field), path, groups)
                want = np.asarray(leaf)
                assert got.shape == want.shape, (field, path)
                if field.endswith("_q"):
                    np.testing.assert_array_equal(got, want,
                                                  err_msg=f"{field} {path}")
                else:
                    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0,
                                               err_msg=f"{field} {path}")


@pytest.mark.parametrize("arch", list(STACK_ARCHS))
def test_eight_bit_trainer_losses_match_the_reference(arch, tmp_path):
    """The reference's ``Trainer`` and the port's, from the reference's
    initial weights (a step-0 checkpoint), 3 steps of AdamW8bit with int8
    gradient compression at B 4 x S 32: losses within 1e-5 relative at
    steps 1 and 2, and within 1e-4 at step 3, which comes after
    AdamW8bit's blow-up in both packages (ROADMAP Queue 3 item 9: a block
    whose int8 second moment is 0 divides m by eps, which turns 1e-7 of
    summation-order noise into up to 3e-5)."""
    from repro.configs.base import RunConfig as JaxRun
    from repro.configs.base import ShapeConfig as JaxShape
    from repro.configs.registry import get_config as jax_config
    from repro.launch.train import Trainer as JaxTrainer
    from repro.models.registry import build_model as jax_build
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import Trainer
    from repro_torch.models.convert import params_from_jax
    run = dict(warmup_steps=2, total_steps=40, learning_rate=3e-3,
               optimizer="adamw8bit")
    jcfg = jax_config(arch).reduced(**STACK_ARCHS[arch])
    _, want = JaxTrainer(jcfg, JaxShape("tiny", 32, 4, "train"),
                         JaxRun(**run), grad_compress=True).train(
                             3, log_every=0)
    init = jax.tree.map(np.asarray, jax_build(jcfg).init(
        jax.random.PRNGKey(0)))

    def trainer():
        return Trainer(get_config(arch).reduced(**STACK_ARCHS[arch]),
                       ShapeConfig("tiny", 32, 4, "train"), RunConfig(**run),
                       device="cpu", ckpt_dir=str(tmp_path),
                       grad_compress=True)
    state = trainer().init_state()
    with torch.no_grad():
        for name, t in params_from_jax(init).items():
            state["params"][name].copy_(t)
    Checkpointer(str(tmp_path)).save(0, state, blocking=True)
    _, got = trainer().train(3, log_every=0)
    rel = np.abs(np.subtract(got, want)) / np.abs(want)
    assert rel[0] < 1e-5 and rel[1] < 1e-5 and rel[2] < 1e-4, (got, want)
    assert got[2] > 10 * got[0] and want[2] > 10 * want[0]
