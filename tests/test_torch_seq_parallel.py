"""PyTorch port, sequence-parallel Mamba2 (``models/mamba_sp.py``) on gloo
process groups of 2 and 4 ranks, reduced mamba2-780m (f32, ``ssm_chunk``
8, B 2 x S 64) with the reference's weights through ``load_jax_params``:
against the reference's ``seq_parallel_forward`` (run as
``tests/test_seq_parallel.py`` runs it, in a subprocess with 8 fabricated
devices) within 1e-3, the reference's own tolerance, and against the
port's single-process ``forward(...)[:, -1]`` within 1e-4.  A shard length
the chunk does not divide raises.

Each rank is a process of its own (``torch.set_num_threads(1)``, a
``FileStore`` under the test's tmp_path), joined with a timeout so that a
hang fails the test instead of eating the suite's time limit."""
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.configs.registry import get_config
from repro_torch.models.convert import load_jax_params
from repro_torch.models.registry import build_model

torch.set_num_threads(1)  # pytest -n: several processes share the cores

SRC = Path(__file__).resolve().parents[1] / "src"
RED = dict(dtype="float32", ssm_chunk=8)
B, S = 2, 64
JOIN_S = 240

# one rank: a gloo group over a FileStore, the port's model with the
# weights the parent saved, this rank's shard of the tokens
RANK = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.registry import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.models.mamba_sp import seq_parallel_forward
    store, rank, n, weights, tokens, out, chunk = sys.argv[1:8]
    rank, n, chunk = int(rank), int(n), int(chunk)
    dist.init_process_group("gloo", rank=rank, world_size=n,
                            store=dist.FileStore(store, n))
    cfg = get_config("mamba2-780m").reduced(dtype="float32",
                                            ssm_chunk=chunk)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(weights))
    tok = torch.from_numpy(np.load(tokens))
    s = tok.shape[1] // n
    try:
        logits = seq_parallel_forward(model, tok[:, rank * s:(rank + 1) * s])
    except ValueError as e:
        print("VALUEERROR", e, flush=True)
        raise SystemExit(3)
    if rank == 0:
        np.save(out, logits.numpy())
    dist.destroy_process_group()
""")

# the reference's sequence-parallel forward on 8 fabricated devices
REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from repro.configs.registry import get_config
    from repro.models.registry import build_model
    from repro.models.mamba_sp import seq_parallel_forward
    from repro.launch.mesh import _make_mesh
    shards, tokens, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    cfg = get_config("mamba2-780m").reduced(dtype="float32", ssm_chunk=8)
    params = build_model(cfg).init(jax.random.PRNGKey(0))
    mesh = _make_mesh((8 // shards, shards), ("data", "model"))
    with mesh:
        y = jax.jit(lambda p, t: seq_parallel_forward(p, t, cfg, mesh))(
            params, np.load(tokens))
    np.save(out, np.asarray(y))
""")


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1")


def _run_ranks(tmp: Path, n: int, weights: Path, tokens: Path,
               chunk: int = 8):
    """Start n ranks, join them within JOIN_S seconds (kill all on a
    hang); -> (rank 0's logits or None, return codes, outputs)."""
    run = Path(tempfile.mkdtemp(dir=tmp))     # a fresh store every run
    store, out = run / "store", run / "logits.npy"
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(store), str(r), str(n),
         str(weights), str(tokens), str(out), str(chunk)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{n} gloo ranks did not finish in {JOIN_S} s")
    rcs = [p.returncode for p in procs]
    return (np.load(out) if out.exists() else None), rcs, outs


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The reference's weights in the port's model, the tokens, and the
    port's single-process last-position logits."""
    tmp = tmp_path_factory.mktemp("seqpar")
    jcfg = jax_config("mamba2-780m").reduced(**RED)
    params = jax_build(jcfg).init(jax.random.PRNGKey(0))
    model = build_model(get_config("mamba2-780m").reduced(**RED),
                        device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    weights, tokens = tmp / "weights.pt", tmp / "tokens.npy"
    torch.save(model.state_dict(), weights)
    tok = np.random.default_rng(1).integers(0, jcfg.vocab_size, (B, S),
                                            dtype=np.int32)
    np.save(tokens, tok)
    with torch.no_grad():
        single = model(torch.from_numpy(tok))[0][:, -1].numpy()
    return tmp, weights, tokens, single


@pytest.mark.parametrize("ranks", [2, 4])
def test_matches_single_process_forward(setup, ranks):
    tmp, weights, tokens, single = setup
    logits, rcs, outs = _run_ranks(tmp, ranks, weights, tokens)
    assert rcs == [0] * ranks, outs
    assert logits.shape == single.shape
    np.testing.assert_allclose(logits, single, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ranks", [2, 4])
def test_matches_reference_seq_parallel(setup, ranks):
    tmp, weights, tokens, _ = setup
    ref_out = tmp / f"ref{ranks}.npy"
    res = subprocess.run([sys.executable, "-c", REFERENCE, str(ranks),
                          str(tokens), str(ref_out)], capture_output=True,
                         text=True, timeout=600, env=_env())
    assert res.returncode == 0, res.stderr[-2000:]
    logits, rcs, outs = _run_ranks(tmp, ranks, weights, tokens)
    assert rcs == [0] * ranks, outs
    np.testing.assert_allclose(logits, np.load(ref_out), atol=1e-3, rtol=0)


def test_shard_not_a_chunk_multiple_raises(setup):
    """Shards of 32 tokens under a chunk of 12: every rank raises (no
    padding), before any rank writes a result."""
    tmp, weights, tokens, _ = setup
    logits, rcs, outs = _run_ranks(tmp, 2, weights, tokens, chunk=12)
    assert logits is None
    assert rcs == [3, 3], outs
    assert all("not a multiple of the chunk 12" in o for o in outs), outs
