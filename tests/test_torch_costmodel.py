"""PyTorch port, the analytical cost model (``models/costmodel.py``) and the
input specs (``models/registry.py``) against the reference's: every FLOP,
byte, collective and roofline function equal to the reference's for every
assigned arch x shape x production mesh (the peaks given to both); the
port's default peaks are the card's; the reference's cost-model tests,
ported (``step_flops`` cross-validated against ``FlopCounterMode`` on a
1-layer reduced llama forward, the counterpart of the reference's check
against XLA's ``cost_analysis``, with its 0.5-2.5x band); and
``input_specs`` / ``decode_input_specs`` as meta tensors with the
reference's keys, shapes and dtypes."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.registry import ASSIGNED
from repro.configs.registry import get_config as jax_config
from repro.models import costmodel as JC
from repro.models import registry as JR
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.models import costmodel as C
from repro_torch.models import registry as R

torch.set_num_threads(1)  # pytest -n: several processes share the cores

MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16}]
REF_PEAKS = dict(peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9)
DTYPES = {jnp.dtype(jnp.int32): torch.int32,
          jnp.dtype(jnp.bfloat16): torch.bfloat16,
          jnp.dtype(jnp.float32): torch.float32}


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@pytest.mark.parametrize("mesh", MESHES, ids=["16x16", "2x16x16"])
def test_every_function_equals_the_reference(arch, mesh):
    cfg, jcfg = get_config(arch), jax_config(arch)
    assert C._n_attn_layers(cfg) == JC._n_attn_layers(jcfg)
    for n in (1, 7, 128, 4096):
        if cfg.is_moe:
            assert C._unique_experts_touched(cfg, n) == \
                JC._unique_experts_touched(jcfg, n)
    for name, shape in SHAPES.items():
        jshape = JSHAPES[name]
        B, S = shape.global_batch, shape.seq_len
        assert C._attn_flops_per_layer(cfg, S, S, B) == \
            JC._attn_flops_per_layer(jcfg, S, S, B)
        assert C._attn_flops_per_layer(cfg, 1, S, B) == \
            JC._attn_flops_per_layer(jcfg, 1, S, B)
        if cfg.ssm_state_dim:
            assert C._ssd_flops_per_layer(cfg, S, B) == \
                JC._ssd_flops_per_layer(jcfg, S, B)
        assert C.kv_cache_bytes(cfg, B, S) == JC.kv_cache_bytes(jcfg, B, S)
        assert C.weights_read_bytes(cfg, shape) == \
            JC.weights_read_bytes(jcfg, jshape)
        for remat in (None, False, True):
            for cf in (None, 1.0, 1.5):
                assert C.step_flops(cfg, shape, remat, cf) == \
                    JC.step_flops(jcfg, jshape, remat, cf)
        for wg in (False, True):
            assert C.step_hbm_bytes(cfg, shape, mesh, wg) == \
                JC.step_hbm_bytes(jcfg, jshape, mesh, wg)
            assert C.step_hbm_bytes(cfg, shape, None, wg) == \
                JC.step_hbm_bytes(jcfg, jshape, None, wg)
            for mode in ("train", "serve"):
                assert C.collective_bytes(cfg, shape, mesh, mode, wg) == \
                    JC.collective_bytes(jcfg, jshape, mesh, mode, wg)
                for kw in ({}, {"grad_compress": True}, {"verify_block": 4},
                           {"remat": False, "capacity_factor": 1.25}):
                    assert C.roofline_terms(cfg, shape, mesh, mode, wg,
                                            **kw, **REF_PEAKS) == \
                        JC.roofline_terms(jcfg, jshape, mesh, mode, wg,
                                          **kw, **REF_PEAKS)


def test_default_peaks_are_the_cards():
    """NVIDIA H100 80GB HBM3 (SXM5) datasheet figures, not a TPU's."""
    got = {k: v.default for k, v in
           inspect.signature(C.roofline_terms).parameters.items()
           if k in REF_PEAKS}
    assert got == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                   "ici_bw": 450e9}
    ref = {k: v.default for k, v in
           inspect.signature(JC.roofline_terms).parameters.items()
           if k in REF_PEAKS}
    assert ref == REF_PEAKS
    cfg, mesh = get_config("llama3.2-3b"), MESHES[0]
    port = C.roofline_terms(cfg, SHAPES["decode_32k"], mesh, "serve")
    ours = C.roofline_terms(cfg, SHAPES["decode_32k"], mesh, "serve",
                            **REF_PEAKS)
    assert port["t_memory"] == pytest.approx(ours["t_memory"] * 819e9
                                             / 3.35e12)


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_input_specs_equal_the_reference(arch, shape):
    cfg, jcfg = get_config(arch), jax_config(arch)
    port = R.input_specs(cfg, SHAPES[shape])
    ref = JR.input_specs(jcfg, JSHAPES[shape])
    assert set(port) == set(ref)
    for k, t in port.items():
        assert t.is_meta
        assert tuple(t.shape) == ref[k].shape, k
        assert t.dtype == DTYPES[jnp.dtype(ref[k].dtype)], k


def _port_leaves(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _port_leaves(v, path + (k,))
    elif isinstance(node, list):
        for v in node:
            yield from _port_leaves(v, path)
    elif isinstance(node, torch.Tensor):
        yield path, node


@pytest.mark.parametrize("arch", sorted(ASSIGNED))
def test_decode_input_specs_equal_the_reference(arch):
    """The same tensors: the reference stacks a cache over its layers, the
    port keeps one per layer, so each reference leaf [L.., *s] is L..
    port tensors of shape s (or one stacked tensor of the same shape)."""
    shape = SHAPES["decode_32k"]
    port = R.decode_input_specs(get_config(arch), shape)
    ref = JR.decode_input_specs(jax_config(arch), JSHAPES["decode_32k"])
    for k in ("tokens", "pos"):
        assert port[k].is_meta and tuple(port[k].shape) == ref[k].shape
        assert port[k].dtype == DTYPES[jnp.dtype(ref[k].dtype)]
    refs = {tuple(p.key for p in path): l for path, l in
            jax.tree_util.tree_flatten_with_path(ref["cache"])[0]}
    count = {}
    for keys, t in _port_leaves(port["cache"]):
        assert t.is_meta
        leaf = refs[keys]
        depth = leaf.ndim - t.dim()
        assert tuple(t.shape) == leaf.shape[depth:], keys
        assert t.dtype == DTYPES[jnp.dtype(leaf.dtype)], keys
        count[keys] = count.get(keys, 0) + 1
        count.setdefault(("depth",) + keys, depth)
    for keys, leaf in refs.items():
        depth = count[("depth",) + keys]
        assert count[keys] == int(np.prod(leaf.shape[:depth])), keys


# --- the reference's cost-model tests, ported -------------------------------

@pytest.mark.parametrize("arch,expected_b,tol", [
    ("llama3.2-3b", 3.2e9, 0.15),
    ("mixtral-8x7b", 46.7e9, 0.10),
    ("granite-20b", 20e9, 0.25),
    ("command-r-35b", 35e9, 0.20),
    ("nemotron-4-340b", 340e9, 0.15),
    ("deepseek-v2-lite-16b", 15.7e9, 0.25),
    ("mamba2-780m", 0.78e9, 0.25),
    ("zamba2-7b", 7.2e9, 0.35),
])
def test_param_counts_match_published(arch, expected_b, tol):
    cfg = get_config(arch)
    total, active = C.count_params(cfg)
    assert abs(total - expected_b) / expected_b < tol, \
        f"{arch}: {total/1e9:.2f}B"
    if cfg.family != "hybrid":
        assert active <= total


def test_moe_active_params_much_smaller():
    total, active = C.count_params(get_config("mixtral-8x7b"))
    assert active < 0.35 * total


def test_expert_bytes_matches_paper():
    b = C.expert_param_bytes(get_config("mixtral-8x7b"))
    assert abs(b - 336e6) / 336e6 < 0.05
    b = C.expert_param_bytes(get_config("deepseek-v2-lite-16b"))
    assert abs(b - 16.5e6) / 16.5e6 < 0.10


def test_flops_cross_validated_with_flop_counter():
    """Single-layer dense forward: the analytical matmul FLOPs against
    what ``FlopCounterMode`` counts of the port's forward (a superset of
    the projections and attention products it models, in the reference's
    0.5-2.5x band)."""
    cfg = get_config("llama3.2-3b").reduced(d_model=128, num_heads=8,
                                            num_kv_heads=8, head_dim=16,
                                            d_ff=256, num_layers=1,
                                            vocab_size=512)
    cfg = dataclasses.replace(cfg, remat=False)
    model = R.build_model(cfg, device="cpu")
    B, S = 2, 64
    tokens = torch.zeros((B, S), dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        model(tokens)
    counted = fc.get_total_flops()
    ours = C.step_flops(cfg, ShapeConfig("t", S, B, "prefill"))["total"]
    assert 0.5 * ours < counted < 2.5 * ours, (counted, ours)


def test_train_flops_3x_forward_plus_remat():
    cfg = get_config("llama3.2-3b")
    f_fwd = C.step_flops(cfg, ShapeConfig("x", 4096, 256, "prefill"))["total"]
    f_train = C.step_flops(cfg, SHAPES["train_4k"], remat=False)["total"]
    assert abs(f_train / f_fwd - 3.0) < 0.01
    f_remat = C.step_flops(cfg, SHAPES["train_4k"], remat=True)["total"]
    assert abs(f_remat / f_fwd - 4.0) < 0.01
    useful = C.step_flops(cfg, SHAPES["train_4k"], remat=True)["useful"]
    assert abs(useful / f_fwd - 3.0) < 0.01


def test_decode_flops_scale_with_batch_not_seq():
    cfg = get_config("llama3.2-3b")
    a = C.step_flops(cfg, ShapeConfig("a", 32768, 128, "decode"))["total"]
    b = C.step_flops(cfg, ShapeConfig("b", 32768, 64, "decode"))["total"]
    assert abs(a / b - 2.0) < 0.05


def test_swa_caps_kv_cache():
    mix = get_config("mixtral-8x7b")
    assert C.kv_cache_bytes(mix, 1, 524288) <= \
        C.kv_cache_bytes(mix, 1, 4096) * 1.1


def test_mla_cache_much_smaller_than_gqa():
    ds = get_config("deepseek-v2-lite-16b")
    gqa = dataclasses.replace(ds, use_mla=False)
    assert C.kv_cache_bytes(ds, 8, 32768) < \
        0.25 * C.kv_cache_bytes(gqa, 8, 32768)


def test_collective_bytes_ep_vs_tp():
    mesh = MESHES[0]
    ds = C.collective_bytes(get_config("deepseek-v2-lite-16b"),
                            SHAPES["train_4k"], mesh, "train")
    mx = C.collective_bytes(get_config("mixtral-8x7b"), SHAPES["train_4k"],
                            mesh, "train")
    assert ds["all_to_all"] > 0
    assert mx["all_to_all"] == 0


def test_roofline_terms_positive_and_dominant():
    mesh = MESHES[0]
    for arch in ("llama3.2-3b", "mixtral-8x7b", "mamba2-780m"):
        for shape in ("train_4k", "decode_32k"):
            r = C.roofline_terms(get_config(arch), SHAPES[shape], mesh,
                                 "train" if shape == "train_4k" else "serve")
            assert r["t_compute"] > 0 and r["t_memory"] > 0
            assert r["dominant"] in ("compute", "memory", "collective")
            assert 0 < r["roofline_fraction"] <= 1.0 + 1e-9
            assert 0 < r["useful_ratio"] <= 1.2
