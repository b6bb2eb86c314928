"""PyTorch port, kernels: the plain versions and the CPU route of the
slot-indexed cache MoE against the JAX reference (run as its own tests run
it on the CPU: the Pallas kernel in interpret mode) and the sync-free index
prep.  The CUDA kernel itself is tested on a card in test_torch_cuda.py.

Inputs are made from a seed with numpy and fed to both packages; f32
throughout, tolerance atol 1e-5 (the two sides sum the same products in a
different order)."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.cache_moe import cache_moe as jax_cache_moe
from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

torch.set_num_threads(1)  # pytest -n: several processes share the cores

ATOL = 1e-5


def _inputs(T, k, S, d, f, seed, slot_ids):
    rng = np.random.default_rng(seed)
    return dict(x=rng.standard_normal((T, d), np.float32),
                wg=(rng.standard_normal((S, d, f)) * 0.1).astype(np.float32),
                wu=(rng.standard_normal((S, d, f)) * 0.1).astype(np.float32),
                wd=(rng.standard_normal((S, f, d)) * 0.1).astype(np.float32),
                weights=rng.uniform(size=(T, k)).astype(np.float32),
                slot_ids=np.asarray(slot_ids, np.int32))


def _cases():
    T, k = 4, 2
    rng = np.random.default_rng(0)
    return {
        "empty_pool": (64, np.full((T, k), -1)),
        "one_slot": (64, np.full((T, k), 37)),
        "fully_occupied": (4, np.arange(T * k).reshape(T, k) % 4),
        "pool_larger_than_choices": (64, rng.integers(0, 64, (T, k))),
        "negative_ids": (6, np.asarray([[0, -1], [-1, -1], [5, 2],
                                        [2, -3]])),
    }


def _torch(a):
    return {n: torch.from_numpy(v) for n, v in a.items()}


@pytest.mark.parametrize("case", sorted(_cases()))
def test_cache_moe_matches_jax_kernel(case):
    """Plain version and the port's CPU route (index prep + per-stage plain
    versions + f32 combine) against the JAX Pallas kernel in interpret
    mode."""
    S, slot_ids = _cases()[case]
    a = _inputs(4, 2, S, 32, 64, 11, slot_ids)
    want = np.asarray(jax_cache_moe(
        jnp.asarray(a["x"]), jnp.asarray(a["slot_ids"]),
        jnp.asarray(a["weights"]), jnp.asarray(a["wu"]),
        jnp.asarray(a["wd"]), jnp.asarray(a["wg"]), interpret=True))
    t = _torch(a)
    plain = R.cache_moe_ref(t["x"], t["slot_ids"], t["weights"], t["wu"],
                            t["wd"], t["wg"])
    routed = K.cache_moe(t["x"], t["slot_ids"], t["weights"], t["wu"],
                         t["wd"], t["wg"])
    np.testing.assert_allclose(plain.numpy(), want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(routed.numpy(), want, atol=ATOL, rtol=0)
    if case == "empty_pool":
        assert not routed.any() and not plain.any()


@pytest.mark.parametrize("gated", [True, False])
def test_cache_moe_ref_matches_jax_ref(gated):
    """The plain version against the JAX oracle, swiglu and gelu experts."""
    a = _inputs(6, 2, 5, 16, 24, 3,
                np.random.default_rng(3).integers(-1, 5, (6, 2)))
    wg = a["wg"] if gated else None
    want = np.asarray(JR.cache_moe_ref(
        jnp.asarray(a["x"]), jnp.asarray(a["slot_ids"]),
        jnp.asarray(a["weights"]), jnp.asarray(a["wu"]),
        jnp.asarray(a["wd"]), None if wg is None else jnp.asarray(wg)))
    t = _torch(a)
    got = R.cache_moe_ref(t["x"], t["slot_ids"], t["weights"], t["wu"],
                          t["wd"], None if wg is None else t["wg"])
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_moe_gemm_ref_matches_jax():
    rng = np.random.default_rng(4)
    E, C, d, f = 3, 8, 16, 24
    xg = rng.standard_normal((E, C, d)).astype(np.float32)
    wg, wu = [(rng.standard_normal((E, d, f)) * 0.1).astype(np.float32)
              for _ in range(2)]
    wd = (rng.standard_normal((E, f, d)) * 0.1).astype(np.float32)
    valid = rng.uniform(size=(E, C)) < 0.7
    want = np.asarray(JR.moe_gemm_ref(*map(jnp.asarray,
                                           (xg, wg, wu, wd, valid))))
    got = R.moe_gemm_ref(*map(torch.from_numpy, (xg, wg, wu, wd, valid)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_slot_groups_dispatch():
    """Groups cover exactly the valid choices, in slot order, with fixed
    shapes (M = min(S, T·k) groups, P = T·k rows)."""
    slot_ids = torch.tensor([[30, -1], [7, 30], [19, 7]], dtype=torch.int32)
    g = K.slot_groups(slot_ids, 32)
    assert g.grp_slot.shape == (6,) and g.row_tok.shape == (6,)
    assert g.grp_slot[:3].tolist() == [7, 19, 30]
    assert g.grp_count.tolist() == [2, 1, 2, 0, 0, 0]
    assert g.grp_start[:3].tolist() == [0, 2, 3]
    # each valid choice's sorted row holds its token
    for t in range(3):
        for c in range(2):
            if slot_ids[t, c] >= 0:
                assert int(g.row_tok[g.inv[t * 2 + c]]) == t
    assert g.valid.tolist() == [[True, False], [True, True], [True, True]]


def test_stage_plain_versions_compose_to_cache_moe():
    """The two stage wrappers on CPU tensors route to their plain versions;
    rows outside every group stay exactly zero."""
    a = _torch(_inputs(5, 2, 12, 16, 32, 5,
                       np.random.default_rng(5).integers(-1, 12, (5, 2))))
    g = K.slot_groups(a["slot_ids"], 12)
    launched = K.gate_up.launches, K.down.launches
    h = K.gate_up(a["x"], g, a["wg"], a["wu"])
    y = K.down(h, g, a["wd"])
    n_valid = int((a["slot_ids"] >= 0).sum())
    assert not h[n_valid:].any() and not y[n_valid:].any()
    assert (K.gate_up.launches, K.down.launches) == launched


def test_ops_routes_cpu_tensors_to_the_plain_version():
    a = _torch(_inputs(3, 2, 4, 16, 32, 6, [[0, 1], [2, -1], [3, 3]]))
    before = ops.cache_moe.launches
    got = ops.cache_moe(a["x"], a["slot_ids"], a["weights"], a["wu"],
                        a["wd"], a["wg"])
    want = R.cache_moe_ref(a["x"], a["slot_ids"], a["weights"], a["wu"],
                           a["wd"], a["wg"])
    assert torch.equal(got, want)
    assert ops.cache_moe.launches == before


def test_kernel_rejects_unsupported_dtypes_on_cuda_tensors():
    """A float16 input is refused before anything launches (checked on the
    wrapper's validation, which runs before the library loads)."""
    x = torch.zeros((2, 8), dtype=torch.float16)
    g = K.slot_groups(torch.zeros((2, 2), dtype=torch.int32), 2)
    with pytest.raises(TypeError):
        K._check_call(x, g)


@pytest.mark.parametrize("gated", [True, False])
def test_cache_moe_matches_jax_kernel_at_any_width(gated):
    """d 36 and f 60: bf16 rows of 72 and 120 bytes, no whole number of 16
    (the card's tensor-core body takes them by narrow copies), swiglu and
    gelu experts, against the JAX Pallas kernel in interpret mode; each
    stage's plain version as the wrappers route it."""
    slot_ids = np.random.default_rng(9).integers(-1, 6, (5, 2))
    a = _inputs(5, 2, 6, 36, 60, 12, slot_ids)
    wg = a["wg"] if gated else None
    want = np.asarray(jax_cache_moe(
        jnp.asarray(a["x"]), jnp.asarray(a["slot_ids"]),
        jnp.asarray(a["weights"]), jnp.asarray(a["wu"]),
        jnp.asarray(a["wd"]), None if wg is None else jnp.asarray(wg),
        interpret=True))
    t = _torch(a)
    wg_t = t["wg"] if gated else None
    got = K.cache_moe(t["x"], t["slot_ids"], t["weights"], t["wu"], t["wd"],
                      wg_t)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    g = K.slot_groups(t["slot_ids"], 6)
    h = K.gate_up(t["x"], g, wg_t, t["wu"]) if gated \
        else K.up_gelu(t["x"], g, t["wu"])
    assert h.shape == (10, 60) and K.down(h, g, t["wd"]).shape == (10, 36)


def test_moe_gemm_matches_the_reference_at_any_width():
    """``ops.moe_gemm`` at d 36, f 60 against the reference's
    ``ops.moe_gemm`` in interpret mode."""
    from repro.kernels import ops as jax_ops
    rng = np.random.default_rng(13)
    E, C, d, f = 3, 8, 36, 60
    xg, wg, wu = (rng.standard_normal(s).astype(np.float32) * 0.3
                  for s in ((E, C, d), (E, d, f), (E, d, f)))
    wd = rng.standard_normal((E, f, d)).astype(np.float32) * 0.3
    valid = rng.random((E, C)) < 0.7
    want = jax_ops.moe_gemm(*(jnp.asarray(a) for a in (xg, wg, wu, wd,
                                                      valid)),
                            impl="interpret")
    got = ops.moe_gemm(*(torch.from_numpy(a) for a in (xg, wg, wu, wd,
                                                     valid)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _offset_view(shape, dtype, nbytes):
    """A zero tensor of ``shape`` whose data starts ``nbytes`` past a
    16-byte boundary (contiguous)."""
    n = math.prod(shape)
    el = torch.empty((), dtype=dtype).element_size()
    buf = torch.zeros(n + 16 // el, dtype=dtype)
    skip = (-buf.data_ptr() % 16 + nbytes) // el
    t = buf[skip:skip + n].view(shape)
    assert t.data_ptr() % 16 == nbytes
    return t


ROUTE_CASES = {
    # name: (dtype, d, f, x offset, pool offset, (body, rows, weights))
    "bf16-36-60": (torch.bfloat16, 36, 60, 0, 0, ("narrow", 8, 8)),
    "bf16-34-58": (torch.bfloat16, 34, 58, 0, 0, ("narrow", 4, 4)),
    "bf16-37-61": (torch.bfloat16, 37, 61, 0, 0, ("narrow", 2, 2)),
    "bf16-32-64": (torch.bfloat16, 32, 64, 0, 0, ("tma", 16, 16)),
    "bf16-32-64-x-off-2": (torch.bfloat16, 32, 64, 2, 0, ("narrow", 2, 16)),
    "bf16-32-64-x-off-8": (torch.bfloat16, 32, 64, 8, 0, ("narrow", 8, 16)),
    "bf16-32-64-pool-off-4": (torch.bfloat16, 32, 64, 0, 4,
                              ("narrow", 16, 4)),
    "bf16-36-60-x-off-4": (torch.bfloat16, 36, 60, 4, 0, ("narrow", 4, 8)),
    "f32-36-60": (torch.float32, 36, 60, 0, 0, ("fma", 4, 16)),
    "f32-36-62": (torch.float32, 36, 62, 0, 0, ("fma", 4, 4)),
    "f32-36-62-pool-off-4": (torch.float32, 36, 62, 0, 4, ("fma", 4, 4)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_wrappers_take_any_width_and_ask_alignment_only_of_their_route(case):
    """The route and copy widths the kernel takes for a stage (``_route``,
    as csrc/cache_moe.cu chooses them), and the wrappers' checks, which run
    before the library loads (no card needed): bf16 runs on the tensor
    cores at every width, by TMA where the rows and the pool are whole 16
    bytes from aligned pointers, else by narrow copies of the widest piece
    each tensor allows, from any pointer; f32 keeps the FMA body, whose
    16-byte weight loads (N a multiple of 4) alone ask an aligned pool."""
    dtype, d, f, x_off, w_off, want = ROUTE_CASES[case]
    x = _offset_view((3, d), dtype, x_off)
    w = _offset_view((2, d, f), dtype, w_off)
    route = K._route(x, (w, w), d, f)
    assert route == want
    K._check("x", x, dtype, 2, False)
    if K._vector_weights(route) and w_off:
        with pytest.raises(ValueError, match="16-byte"):
            K._check("wu", w, dtype, 3, True)
    else:
        K._check("wu", w, dtype, 3, K._vector_weights(route))
    assert K._vector_weights(route) == (dtype == torch.float32 and f % 4 == 0)
    # the down stage reads h [P, f] into [d] columns: its own widths
    h = _offset_view((4, f), dtype, 0)
    wd = _offset_view((2, f, d), dtype, w_off)
    body, rows, wts = K._route(h, (wd,), f, d)
    if dtype == torch.bfloat16:
        assert rows == K._piece(h, f) and wts == K._piece(wd, d)
        assert body == ("tma" if rows == wts == 16 else "narrow")
    else:
        assert (body, rows, wts) == ("fma", 4, 16 if d % 4 == 0 else 4)


@pytest.mark.parametrize("d,f", [(34, 58), (37, 61)])
def test_cache_moe_matches_jax_kernel_at_every_piece_width(d, f):
    """The widths of the narrow copies' 4- and 2-byte pieces (bf16 rows of
    68 / 116 and 74 / 122 bytes on the card), swiglu and gelu experts, the
    port's CPU route against the JAX Pallas kernel in interpret mode."""
    slot_ids = np.random.default_rng(d).integers(-1, 6, (5, 2))
    a = _inputs(5, 2, 6, d, f, d + f, slot_ids)
    t = _torch(a)
    for gated in (True, False):
        wg = a["wg"] if gated else None
        want = np.asarray(jax_cache_moe(
            jnp.asarray(a["x"]), jnp.asarray(a["slot_ids"]),
            jnp.asarray(a["weights"]), jnp.asarray(a["wu"]),
            jnp.asarray(a["wd"]), None if wg is None else jnp.asarray(wg),
            interpret=True))
        got = K.cache_moe(t["x"], t["slot_ids"], t["weights"], t["wu"],
                          t["wd"], t["wg"] if gated else None)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
