"""PyTorch port, kernels: the plain versions and the CPU route of the
slot-indexed cache MoE against the JAX reference (run as its own tests run
it on the CPU: the Pallas kernel in interpret mode) and the sync-free index
prep.  The CUDA kernel itself is tested on a card in test_torch_cuda.py.

Inputs are made from a seed with numpy and fed to both packages; f32
throughout, tolerance atol 1e-5 (the two sides sum the same products in a
different order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as JR
from repro.kernels.cache_moe import cache_moe as jax_cache_moe
from repro_torch.kernels import cache_moe as K
from repro_torch.kernels import ops
from repro_torch.kernels import ref as R

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
