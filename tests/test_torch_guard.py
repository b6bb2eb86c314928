"""PyTorch port, the kernel guard (``kernels/guard.py``): every kernel
wrapper raises a ``RuntimeError`` naming its kernel when grad mode is on
and an input requires grad, on the CPU too (in front of the plain
version), and runs under ``torch.no_grad()`` or on inputs that do not
require grad.  The kernels are loaded through ``ctypes``: their outputs
carry no ``grad_fn``, so without the guard a train step would silently
lose the gradient behind them.

Also ``ops.moe_gemm``, the dense-layout entry point, on the CPU against the
reference's ``ops.moe_gemm`` in interpret mode (the Pallas kernel's body,
f32, atol 1e-5); its kernel route is a ``cuda`` test
(``tests/test_torch_cuda.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import ops

torch.set_num_threads(1)  # pytest -n: several processes share the cores


def _rand(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


def _flash():
    return ("flash_attention", lambda q, k, v: ops.flash_attention(
        q, k, v, causal=True), (_rand(1, 16, 4, 16), _rand(1, 16, 2, 16, seed=1),
                                _rand(1, 16, 2, 16, seed=2)))


def _decode():
    lengths = torch.tensor([5], dtype=torch.int32)
    return ("decode_attention", lambda q, k, v: ops.decode_attention(
        q, k, v, lengths), (_rand(1, 4, 16), _rand(1, 8, 2, 16, seed=1),
                            _rand(1, 8, 2, 16, seed=2)))


def _ssd():
    dt = torch.nn.functional.softplus(_rand(1, 16, 2, seed=1))
    A = -torch.exp(_rand(2, seed=2))

    def run(x, B, C):
        return ops.ssd(x, dt, A, B, C, 8)[0]
    return ("ssd_scan", run, (_rand(1, 16, 2, 4), _rand(1, 16, 8, seed=3),
                              _rand(1, 16, 8, seed=4)))


def _cache_moe():
    slots = torch.tensor([[0, 2], [1, -1], [2, 0]])
    w = torch.full((3, 2), 0.5)
    return ("cache_moe", lambda x, wu, wd, wg: ops.cache_moe(
        x, slots, w, wu, wd, wg), (_rand(3, 8), _rand(3, 8, 16, seed=1),
                                   _rand(3, 16, 8, seed=2),
                                   _rand(3, 8, 16, seed=3)))


def _groups():
    return K.slot_groups(torch.tensor([[0, 2], [1, 0]]), 3)


def _gate_up():
    return ("cache_moe_gate_up", lambda x, wg, wu: K.gate_up(
        x, _groups(), wg, wu), (_rand(2, 8), _rand(3, 8, 16, seed=1),
                                _rand(3, 8, 16, seed=2)))


def _up_gelu():
    return ("cache_moe_up_gelu", lambda x, wu: K.up_gelu(x, _groups(), wu),
            (_rand(2, 8), _rand(3, 8, 16, seed=1)))


def _down():
    return ("cache_moe_down", lambda h, wd: K.down(h, _groups(), wd),
            (_rand(4, 16), _rand(3, 16, 8, seed=1)))


def _moe_gemm():
    valid = torch.tensor([[True, False], [True, True]])
    return ("moe_gemm", lambda xg, wg, wu, wd: ops.moe_gemm(
        xg, wg, wu, wd, valid), (_rand(2, 2, 8), _rand(2, 8, 16, seed=1),
                                 _rand(2, 8, 16, seed=2),
                                 _rand(2, 16, 8, seed=3)))


WRAPPERS = {f.__name__[1:]: f for f in (_flash, _decode, _ssd, _cache_moe,
                                         _gate_up, _up_gelu, _down,
                                         _moe_gemm)}


@pytest.mark.parametrize("which", sorted(WRAPPERS))
def test_wrapper_refuses_autograd_and_runs_without_it(which):
    name, fn, inputs = WRAPPERS[which]()
    want = fn(*inputs)
    assert want.grad_fn is None
    for i in range(len(inputs)):
        graded = [t.clone().requires_grad_(j == i)
                  for j, t in enumerate(inputs)]
        with pytest.raises(RuntimeError, match=name):
            fn(*graded)
        with torch.no_grad():
            assert torch.equal(fn(*graded), want)
    if which == "ssd":
        with pytest.raises(RuntimeError, match="SSD-family"):
            fn(*(t.clone().requires_grad_(True) for t in inputs))


def test_moe_gemm_matches_the_reference_in_interpret_mode():
    rng = np.random.default_rng(7)
    E, C, d, f = 4, 8, 128, 128
    xg, wg, wu = (rng.standard_normal(s).astype(np.float32) * 0.3
                  for s in ((E, C, d), (E, d, f), (E, d, f)))
    wd = rng.standard_normal((E, f, d)).astype(np.float32) * 0.3
    valid = rng.random((E, C)) < 0.7
    want = jax_ops.moe_gemm(*(jnp.asarray(a) for a in (xg, wg, wu, wd,
                                                      valid)),
                            impl="interpret")
    got = ops.moe_gemm(*(torch.from_numpy(a) for a in (xg, wg, wu, wd,
                                                     valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    assert (got.numpy()[~valid] == 0).all()
