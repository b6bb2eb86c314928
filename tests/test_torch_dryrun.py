"""PyTorch port, the multi-pod dry-run (``launch/dryrun.py``) over a fake
process group, in subprocesses: llama3.2-3b decode_32k and mamba2-780m
prefill_32k with ``--seq-parallel`` on the 16x16 mesh both end ``ok``
with the reference's record keys, their argument bytes equal to the closed
form from the sharding rules (each parameter's and cache tensor's bytes
over the product of its spec's mesh axes; the sequence-parallel cell's
weights whole, its tokens one rank's shard); a train-mode cell (FSDP: the
weights gathered on use) records an ``all_gather``; a cell that
``shape_applicable`` refuses is ``skipped``; and a 2-layer mixtral-8x7b
train cell on the 2 x 16 x 16 mesh ends ``ok`` with its FSDP collectives
over the flattened (pod x data) dim."""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.models import sharding as SH
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

SRC = Path(__file__).resolve().parents[1] / "src"
MESH = {"data": 16, "model": 16}
KEYS = {"arch", "shape", "status", "fn", "mesh", "weight_gather",
        "verify_block", "capacity_factor", "remat_override", "compile_s",
        "memory", "xla_cost", "hlo_collectives", "roofline"}


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


def _dryrun(tmp_path, *args):
    out = tmp_path / "cells.json"
    res = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--multi-pod", "no", "--out", str(out), *args],
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    cells = json.loads(out.read_text()) if out.exists() else []
    return res, cells


def _local_bytes(t, spec):
    return t.numel() * t.element_size() // int(np.prod(
        [SH.mesh_axis_size(MESH, a) for a in spec]))


def _tensors(tree, specs):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, specs[k])
    elif isinstance(tree, list):
        for v, s in zip(tree, specs):
            yield from _tensors(v, s)
    elif isinstance(tree, torch.Tensor):
        yield tree, specs


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    res, decode = _dryrun(tmp, "--arch", "llama3.2-3b", "--shape",
                          "decode_32k,long_500k")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    tmp2 = tmp_path_factory.mktemp("dryrun_sp")
    res, sp = _dryrun(tmp2, "--arch", "mamba2-780m", "--shape",
                      "prefill_32k", "--seq-parallel")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return {(c["arch"], c["shape"]): c for c in decode + sp}


def test_decode_cell_ok_with_the_rules_argument_bytes(cells):
    cell = cells[("llama3.2-3b", "decode_32k")]
    assert cell["status"] == "ok", cell
    assert KEYS <= set(cell)
    assert cell["mesh"] == MESH and cell["fn"] == "serve_step(block=1)"
    cfg, shape = get_config("llama3.2-3b"), SHAPES["decode_32k"]
    model = build_model(cfg, device="meta")
    params = dict(model.named_parameters())
    specs = SH.param_pspecs(cfg, params, MESH, mode="serve")
    want = sum(_local_bytes(t, specs[n]) for n, t in params.items())
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    want += sum(_local_bytes(t, s) for t, s in _tensors(
        cache, SH.cache_pspecs(cfg, cache, MESH)))
    want += shape.global_batch * 4 // 16           # the tokens, int32
    assert cell["memory"]["argument_bytes"] == want
    mem = cell["memory"]
    assert mem["peak_per_device"] >= mem["argument_bytes"] > 0
    assert cell["xla_cost"]["flops_per_device_body"] > 0
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert "all_gather" in cell["hlo_collectives"]


def test_seq_parallel_cell_ok_with_whole_weights(cells):
    cell = cells[("mamba2-780m", "prefill_32k")]
    assert cell["status"] == "ok", cell
    assert cell["fn"] == "prefill_forward(seq_parallel)"
    model = build_model(get_config("mamba2-780m"), device="meta")
    want = sum(t.numel() * t.element_size() for t in model.parameters())
    B, S = SHAPES["prefill_32k"].global_batch, SHAPES["prefill_32k"].seq_len
    want += (B // 16) * (S // 16) * 4              # one rank's tokens
    assert cell["memory"]["argument_bytes"] == want
    # the halo, end states and decays, all-gathered over the model axis
    ag = cell["hlo_collectives"]["all_gather"]
    assert ag["count"] == 3 * 48 + 1
    assert 0 < ag["bytes"] < 48 * 16 * 2 * 1.7e6


def test_inapplicable_cell_is_skipped(cells):
    cell = cells[("llama3.2-3b", "long_500k")]
    assert cell["status"] == "skipped" and "reason" in cell


TRAIN = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    D.start_fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    # full width, two layers: the FSDP gather of every layer's weights
    D.get_config = lambda a: dataclasses.replace(get_config(a), num_layers=2)
    print(json.dumps(D.lower_cell("llama3.2-3b", "train_4k", mesh)))
""")


def test_train_cell_gathers_fsdp_weights():
    res = subprocess.run([sys.executable, "-c", TRAIN], capture_output=True,
                         text=True, timeout=300, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    cell = json.loads(res.stdout.strip().splitlines()[-1])
    assert cell["status"] == "ok" and cell["fn"] == "train_step(micro=1)"
    colls = cell["hlo_collectives"]
    assert colls["all_gather"]["count"] > 0
    assert colls["all_gather"]["bytes"] > 0
    assert "reduce_scatter" in colls or "all_reduce" in colls


MULTI_POD_TRAIN = textwrap.dedent("""
    import dataclasses, json
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    D.start_fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    D.get_config = lambda a: dataclasses.replace(get_config(a), num_layers=2)
    print(json.dumps(D.lower_cell("mixtral-8x7b", "train_4k", mesh)))
""")


def test_multi_pod_train_cell_shards_fsdp_over_flattened_pod_data():
    """mixtral-8x7b at full width, 2 layers, train_4k on the 2 x 16 x 16
    mesh: laid out on the flattened (pod_data 32, model 16) mesh, each
    FSDP weight is all-gathered and its gradient reduce-scattered in one
    collective over the 32 ranks of pod x data (over the two mesh dims
    DTensor's planner ran past the 900 s cell limit)."""
    res = subprocess.run([sys.executable, "-c", MULTI_POD_TRAIN],
                         capture_output=True, text=True, timeout=300,
                         env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    cell = json.loads(res.stdout.strip().splitlines()[-1])
    assert cell["status"] == "ok" and cell["fn"] == "train_step(micro=1)"
    assert cell["mesh"] == {"pod": 2, "data": 16, "model": 16}
    assert cell["layout_mesh"] == {"pod_data": 32, "model": 16}
    colls = cell["hlo_collectives"]
    for fam in ("all_gather", "reduce_scatter"):
        assert colls[fam]["calls_by_group_size"].get("32", 0) > 0, colls
        assert colls[fam]["bytes"] > 0
    assert set(colls["all_gather"]["calls_by_group_size"]) <= {"16", "32"}
