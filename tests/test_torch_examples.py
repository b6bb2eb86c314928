"""PyTorch port, the serving examples (``examples/quickstart_torch.py``,
``examples/serve_spmoe_torch.py``) run through their ``main`` at their
smallest size on the CPU: every stream they print as lossless is the
port's greedy stream, and without ``--device cpu`` they ask for the card
(and raise without one)."""
import importlib.util
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)  # pytest -n: several processes share the cores

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart_is_lossless_on_the_cpu(capsys):
    out = _load("quickstart_torch").main(["--device", "cpu", "--tokens", "4"])
    ref = out["reference"]
    assert len(ref) == 4
    assert out["stream"] == out["warm"] == out["concurrent"][0] == \
        out["chaos"] == ref
    printed = capsys.readouterr().out
    assert "lossless: True" in printed
    assert "chaos drill lossless: True" in printed


@pytest.mark.parametrize("concurrency", ["1", "2"])
def test_serve_spmoe_every_policy_is_lossless_on_the_cpu(concurrency,
                                                         capsys):
    mod = _load("serve_spmoe_torch")
    got = mod.main(["--device", "cpu", "--tokens", "4", "--requests", "2",
                    "--concurrency", concurrency])
    assert got == {p: True for p in mod.OFFLOAD_POLICIES}
    assert len(got) == 4 and "none" not in got
    assert capsys.readouterr().out.count(" True ") == 4


@pytest.mark.parametrize("name", ["quickstart_torch", "serve_spmoe_torch"])
def test_examples_run_on_the_card_by_default(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _load(name).main([])
