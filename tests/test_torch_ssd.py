"""PyTorch port, SSD scan: the plain versions ``ref.ssd_ref`` /
``ref.ssd_decode_ref`` against the JAX reference's (y and final state, with
and without an initial state) and against its Pallas kernel in interpret
mode, at the shapes of the reference's ``test_ssd_scan_sweep`` plus a chunk
that is not a power of two and a padded length, and at the served widths
(mamba2-780m, zamba2-7b; S 512); and the CPU route of the kernel's
wrappers.

f32, atol 1e-4 / rtol 1e-3 (as the reference's sweep), inputs made from a
seed with numpy."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R
from repro_torch.kernels import ssd_scan as SSD

torch.set_num_threads(1)  # pytest -n: several processes share the cores

TOL = dict(atol=1e-4, rtol=1e-3)
jax_ssd_ref = jax.jit(JR.ssd_ref, static_argnums=5)
jax_ssd_decode_ref = jax.jit(JR.ssd_decode_ref)

SWEEP = [(1, 16, 2, 8, 4, 8), (2, 32, 3, 8, 4, 8), (1, 64, 1, 16, 8, 16)]
EXTRA = [(1, 77, 2, 8, 4, 77),          # one chunk of 77 (a 77-token prompt)
         (2, 48, 3, 16, 16, 12)]        # chunk 12: not a power of two


def _inputs(b, s, h, p, n, seed=0, init=False):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(f32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f32)
    B = rng.standard_normal((b, s, n)).astype(f32)
    C = rng.standard_normal((b, s, n)).astype(f32)
    st = rng.standard_normal((b, h, p, n)).astype(f32) if init else None
    return x, dt, A, B, C, st


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("b,s,h,p,n,chunk,init", [
    *(shape + (False,) for shape in SWEEP + EXTRA),
    SWEEP[1] + (True,), EXTRA[1] + (True,)])
def test_ssd_ref_matches_jax(b, s, h, p, n, chunk, init):
    arrs = _inputs(b, s, h, p, n, init=init)
    *ins, st = arrs
    jy, jst = jax_ssd_ref(*_jax(ins), chunk, *_jax([st]))
    ty, tst = R.ssd_ref(*_torch(ins), chunk, *_torch([st]))
    assert ty.dtype == torch.float32 and tst.shape == (b, h, p, n)
    _close(ty, jy)
    _close(tst, jst)


@pytest.mark.parametrize("b,s,h,p,n,chunk", SWEEP + EXTRA[:1])
def test_ssd_ref_matches_the_pallas_kernel(b, s, h, p, n, chunk):
    """The reference's TPU kernel run in interpret mode (it returns y
    only)."""
    ins = _inputs(b, s, h, p, n, seed=1)[:5]
    want = jax_ssd_scan(*_jax(ins), chunk, interpret=True)
    got, _ = R.ssd_ref(*_torch(ins), chunk)
    _close(got, want)


# the widths the card times (PERF.md): mamba2-780m (h 48, p 64, n 128) and
# zamba2-7b (h 112, p 64, n 64), one 512-token sequence in chunks of 128.
# Tolerance: |y| reaches ~260 there, and an output near 0 is the sum of
# terms of that size that cancel, so the two packages' f32 summation orders
# leave up to 1.7e-4 on it (at |y| 0.04; 1.1e-3 at most anywhere, on a
# large |y|), past TOL's atol of 1e-4.  atol 1e-3 is 4e-6 of the largest
# |y|; rtol stays TOL's.
SERVED = {"mamba2": (1, 512, 48, 64, 128, 128),
          "zamba2": (1, 512, 112, 64, 64, 128)}
SERVED_TOL = dict(atol=1e-3, rtol=TOL["rtol"])


@pytest.mark.parametrize("model", sorted(SERVED))
def test_ssd_ref_matches_jax_at_the_served_widths(model):
    """The plain version the card holds the kernel against, at the widths
    PERF.md times: y and state against the reference's ``ssd_ref``, y
    against its Pallas kernel in interpret mode."""
    b, s, h, p, n, chunk = SERVED[model]
    ins = _inputs(b, s, h, p, n, seed=5)[:5]
    ty, tst = R.ssd_ref(*_torch(ins), chunk)
    jy, jst = jax_ssd_ref(*_jax(ins), chunk)
    ky = jax_ssd_scan(*_jax(ins), chunk, interpret=True)
    for got, want in ((ty, jy), (tst, jst), (ty, ky)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **SERVED_TOL)


def test_ssd_decode_ref_matches_jax_and_the_chunked_scan():
    """One recurrent step against the reference's, and 12 steps against
    the chunked scan over the same sequence (y and state)."""
    b, s, h, p, n = 2, 12, 3, 4, 5
    x, dt, A, B, C, st = _inputs(b, s, h, p, n, seed=2, init=True)
    jy, jst = jax_ssd_decode_ref(*_jax([st, x[:, 0], dt[:, 0], A, B[:, 0],
                                        C[:, 0]]))
    ty, tst = R.ssd_decode_ref(*_torch([st, x[:, 0], dt[:, 0], A, B[:, 0],
                                        C[:, 0]]))
    _close(ty, jy)
    _close(tst, jst)
    state = torch.from_numpy(st)
    ys = []
    for t in range(s):
        y, state = R.ssd_decode_ref(state, *_torch([x[:, t], dt[:, t], A,
                                                    B[:, t], C[:, t]]))
        ys.append(y)
    yc, sc = R.ssd_ref(*_torch([x, dt, A, B, C]), 4, torch.from_numpy(st))
    torch.testing.assert_close(torch.stack(ys, 1), yc, **TOL)
    torch.testing.assert_close(state, sc, **TOL)


def test_padding_with_zero_dt_leaves_the_state_unchanged():
    """300 steps padded to 384 in chunks of 128 (dt = 0 on the pad, as
    ``mamba_forward`` pads) give the y and state of the 300 steps in chunks
    of 100."""
    x, dt, A, B, C, _ = _inputs(1, 300, 2, 8, 4, seed=3)
    pad = [np.pad(a, [(0, 0), (0, 84)] + [(0, 0)] * (a.ndim - 2))
           for a in (x, dt, B, C)]
    yp, sp = R.ssd_ref(*_torch([pad[0], pad[1], A, pad[2], pad[3]]), 128)
    yu, su = R.ssd_ref(*_torch([x, dt, A, B, C]), 100)
    torch.testing.assert_close(yp[:, :300], yu, **TOL)
    torch.testing.assert_close(sp, su, **TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    """``ops.ssd`` is the kernel's wrapper, which routes a CPU tensor to
    ``ref.ssd_ref`` and counts no launch."""
    assert ops.ssd is SSD.ssd_scan
    ins = _torch(_inputs(1, 32, 2, 8, 4, seed=4)[:5])
    want = R.ssd_ref(*ins, 8)
    before = ops.ssd.launches
    got = ops.ssd(*ins, 8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert ops.ssd.launches == before


def test_plain_version_refuses_a_length_the_chunk_does_not_divide():
    ins = _torch(_inputs(1, 30, 2, 8, 4)[:5])
    with pytest.raises(ValueError):
        R.ssd_ref(*ins, 8)


# chunks and state widths past the kernel's 128-row tile and 128-column
# block (it scans a chunk past 128 in 128-row tiles with a ragged last one,
# and a state past 128 in 128-column blocks): Mamba2's published chunk 256,
# 160 (tiles 128 + 32), a prime 131 (128 + 3), and n 160 and 256.
WIDE = [(1, 512, 2, 8, 16, 256), (2, 320, 2, 8, 16, 160),
        (1, 262, 2, 8, 4, 131), (1, 256, 2, 8, 160, 128),
        (1, 256, 2, 8, 256, 64)]


@pytest.mark.parametrize("b,s,h,p,n,chunk", WIDE)
def test_ssd_ref_matches_jax_at_any_chunk_and_state_width(b, s, h, p, n,
                                                          chunk):
    """y and state against the reference's ``ssd_ref``, y against its
    Pallas kernel in interpret mode, from zero and from an initial
    state."""
    x, dt, A, B, C, st = _inputs(b, s, h, p, n, seed=6, init=True)
    ins = [x, dt, A, B, C]
    ky = jax_ssd_scan(*_jax(ins), chunk, interpret=True)
    for init in (None, st):
        jy, jst = jax_ssd_ref(*_jax(ins), chunk, *_jax([init]))
        ty, tst = SSD.ssd_scan(*_torch(ins), chunk, *_torch([init]))
        assert tst.shape == (b, h, p, n)
        _close(ty, jy)
        _close(tst, jst)
    _close(R.ssd_ref(*_torch(ins), chunk)[0], ky)


@pytest.mark.parametrize("b,s,h,p,n,chunk", WIDE)
def test_the_chunk_moves_the_result_only_by_rounding(b, s, h, p, n, chunk):
    """What lets the kernel scan in tiles of its own: the scan at the
    caller's chunk against the same scan in chunks of 1 (f32, the served
    widths' tolerance)."""
    x, dt, A, B, C, st = _inputs(b, s, h, p, n, seed=7, init=True)
    ins = _torch([x, dt, A, B, C])
    init = torch.from_numpy(st)
    y, s_end = R.ssd_ref(*ins, chunk, init)
    y1, s1 = R.ssd_ref(*ins, 1, init)
    torch.testing.assert_close(y, y1, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s_end, s1, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("chunk", [128, 256, 131])
def test_ssd_scan_from_a_state_matches_the_reference(chunk):
    """``ssd_scan(..., init_state=)`` (the CPU route) against the
    reference's ``ssd_ref`` from the same state, f32 at 1e-5; and the two
    halves of a sequence, the second from the first's final state, against
    one scan of the whole."""
    s = 2 * chunk
    x, dt, A, B, C, st = _inputs(1, s, 2, 8, 16, seed=8, init=True)
    dt = dt * 0.05                      # states that carry across chunks
    ins = [x, dt, A, B, C]
    jy, jst = jax_ssd_ref(*_jax(ins), chunk, jnp.asarray(st))
    ty, tst = ops.ssd(*_torch(ins), chunk, torch.from_numpy(st))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tst.numpy(), np.asarray(jst), atol=1e-5,
                               rtol=1e-5)
    first = [a[:, :chunk] if a.ndim > 1 else a for a in ins]
    second = [a[:, chunk:] if a.ndim > 1 else a for a in ins]
    y1, s1 = ops.ssd(*_torch(first), chunk)
    y2, s2 = ops.ssd(*_torch(second), chunk, s1)
    yw, sw = ops.ssd(*_torch(ins), chunk)
    torch.testing.assert_close(torch.cat([y1, y2], 1), yw, **TOL)
    torch.testing.assert_close(s2, sw, **TOL)


def test_kernel_wrapper_takes_any_chunk_and_width_and_refuses_the_rest():
    """The checks run before the library loads (no card needed): any chunk
    that divides s, any n and a [b, h, p, n] f32 initial state pass; a
    chunk that does not divide s, chunk 0, a wrong initial state or dtype
    raise."""
    ins = _torch(_inputs(1, 262, 2, 8, 256)[:5])
    for chunk in (1, 2, 131, 262):
        SSD._check(*ins, chunk, None)
    SSD._check(*ins, 131, torch.zeros((1, 2, 8, 256)))
    for chunk in (0, 128, 256):
        with pytest.raises(ValueError):
            SSD._check(*ins, chunk, None)
    with pytest.raises(ValueError):
        SSD._check(*ins, 131, torch.zeros((1, 2, 8, 255)))
    with pytest.raises(TypeError):
        SSD._check(*ins, 131, torch.zeros((1, 2, 8, 256),
                                          dtype=torch.float64))
    with pytest.raises(TypeError):
        SSD._check(ins[0].double(), *ins[1:], 131, None)
