"""PyTorch port, the optimizers and gradient compression (``optim/*``)
against the reference (``repro.optim``): ``warmup_cosine`` at every step
of a schedule, ``quantize_i8`` (equal int8 values, scales within 1e-7),
``global_norm`` / ``clip_by_global_norm``, and the port's versions of
``tests/test_substrate.py``'s AdamW, AdamW8bit, quantization round-trip and
error-feedback tests; plus one AdamW and one AdamW8bit update of a small
tree against the reference's (f32, 1e-6)."""
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
from repro_torch.optim.optimizer import (AdamW, AdamW8bit,
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
