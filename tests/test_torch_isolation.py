"""PyTorch port, isolation: the port (its package, ``chip_smoke.py`` and
the ``examples/*_torch.py``) imports neither JAX nor anything of the
reference package, and its entry points run on the card unless the caller
asks for the CPU (without a card they raise)."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import Engine, EngineConfig, Request

torch.set_num_threads(1)  # pytest -n: several processes share the cores

PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
EXAMPLES = sorted((Path(__file__).resolve().parents[1] / "examples")
                  .glob("*_torch.py"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [SMOKE] +
                         EXAMPLES,
                         ids=lambda p: str(p.relative_to(PORT.parents[1])))
def test_no_jax_or_reference_imports(path):
    for mod in _imports(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.core.engine, "
            "repro_torch.core.runtime, repro_torch.core.graphs, "
            "repro_torch.launch.serve, "
            "repro_torch.models.mamba, repro_torch.kernels.ssd_scan, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.cache_moe, repro_torch.kernels.guard, "
            "repro_torch.launch.train, repro_torch.models.train, "
            "repro_torch.optim.optimizer, repro_torch.optim.grad_compress, "
            "repro_torch.data.pipeline, "
            "repro_torch.checkpoint.checkpointer, "
            "repro_torch.runtime.fault_tolerance, "
            "repro_torch.models.sharding, repro_torch.models.mamba_sp, "
            "repro_torch.models.costmodel, repro_torch.models.registry, "
            "repro_torch.launch.mesh, repro_torch.launch.dryrun; "
            "import torch.distributed as dist; "
            "print('jax' in sys.modules, 'repro' in sys.modules, "
            "dist.is_initialized())")
    env = dict(os.environ, PYTHONPATH=str(PORT.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    # and no process group is started by an import (launch/mesh.py,
    # launch/dryrun.py start theirs when called)
    assert out.stdout.split() == ["False", "False", "False"]


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny():
    return dataclasses.replace(get_config("mixtral-8x7b").reduced(
        dtype="float32"), num_layers=2)


def test_entry_points_raise_without_a_card(no_card, monkeypatch):
    from repro_torch.launch import serve
    from repro_torch.models.transformer import DecoderLM
    cfg = _tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        DecoderLM(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(EngineConfig(model=cfg, offload="spmoe"))
    monkeypatch.setattr(sys, "argv", ["serve", "--tokens", "2"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()
    ssm = get_config("mamba2-780m").reduced(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(EngineConfig(model=ssm, decode="greedy"))
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "zamba2-7b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "llama3.2-3b"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()


def test_expert_cache_and_phi_default_to_the_card(no_card, monkeypatch):
    from repro_torch.core.cache import ExpertCache
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        ExpertCache(2, {"wu": (4, 4)}, torch.float32)
    cache = ExpertCache(2, {"wu": (4, 4)}, torch.float32, device="cpu")
    assert cache.bufs["wu"].device.type == "cpu"
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", "phi-3.5-moe"])
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main()


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    cfg = _tiny()
    with Engine(EngineConfig(model=cfg, offload="spmoe", decode="sd",
                             draft_len=2, max_seq=32), device="cpu") as eng:
        assert eng.device.type == "cpu"
        assert eng.runtime.cache.bufs["wu"].device.type == "cpu"
        # the engine built its target: its experts live in the store only
        assert eng.target.layers[0].moe.wu.numel() == 0
        res = eng.submit(Request(prompt=[1, 2, 3], max_new_tokens=5))
    assert len(res.tokens) == 5
    assert res.finish_reason == "length"


def test_chip_smoke_refuses_to_run_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(SMOKE)], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
