"""PyTorch port, training on a mesh (``launch/train.py::Trainer(mesh=...)``
over ``models/placement.py``) on gloo process groups of 4 and 2 ranks,
against the reference's ``Trainer`` on a 2 x 2 fake-device mesh (run in a
subprocess with 4 fabricated devices, as ``tests/test_seq_parallel.py``
runs the reference) and against the port's one-process ``Trainer``.

``tests/test_system.py``'s tiny trainer (llama3.2-3b and mixtral-8x7b, 2
layers, d 32, 2 / 2 x 16 heads, d_ff 64, vocab 128, B 4 x S 32) in f32,
from the reference's initial weights: the port starts from a step-0
checkpoint that holds them, so every mesh run also restores a one-host
checkpoint onto its mesh.  Cases:

(i) 4 ranks on (data 2, model 2), 4 AdamW steps: losses within 1e-4
relative of the reference's and of the one-process run, every parameter
laid out as ``param_pspecs(mode="train")`` says, the final whole tensors
within 1e-4 of the reference's;
(ii) 4 ranks on (pod 2, data 2, model 1): FSDP over the flattened
(pod x data) dim, with 2 microbatches (f32 accumulation), against the
reference's and the one-process run with 2 microbatches, same tolerances;
(iii) AdamW8bit with int8 gradient compression: three updates of the same
gradients on (data 2, model 2) and on (pod 2, data 2, model 1) and in one
process within 1e-5 (the int8 blocks are the global tensor's, each
quantized on the rank that holds its shard where the shards are runs of
whole blocks; a group of the reference's stacked leaves gathered whole),
and 3 ``Trainer`` steps on (data 2, model 2) against the one-process run
within 1e-5 relative and against the reference's within 1e-5 (steps 1-2)
and 1e-4 (step 3, past AdamW8bit's blow-up); its step-3 checkpoint
restored onto 2 ranks and onto none bit for bit;
(iv) elastic restart: the (2, 2) llama run checkpoints at step 4 (each
rank its own pieces); 2 ranks on ``make_mesh_from_plan(plan_mesh(2, 2))``
resume it to step 8 within 1e-4 of 8 uninterrupted one-process steps and
of the reference's 8 steps on its 2 x 2 mesh, a plain ``Trainer``
restores it bit for bit, and a ``meta.json`` that lost or shrank a piece
makes the restore raise;
(v) a mesh on the ``cuda`` device type with no card raises.

Each rank is a process of its own (``torch.set_num_threads(1)``, a
``FileStore`` under the test's tmp_path), joined with a timeout."""
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jax_config
from repro.models.registry import build_model as jax_build
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import Trainer
from repro_torch.models import sharding as SH
from repro_torch.models.convert import params_from_jax, stack_groups
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizer import QBLOCK

torch.set_num_threads(1)  # pytest -n: several processes share the cores

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("llama3.2-3b", "mixtral-8x7b")
TINY = dict(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
            head_dim=16, d_ff=64, vocab_size=128, dtype="float32")
B, S = 4, 32
RUN = dict(warmup_steps=2, total_steps=40, learning_rate=3e-3)
JOIN_S = 300

# the jobs of one group of ranks, in order: train a Trainer on the mesh
# from a checkpoint directory, or run three 8-bit updates of seeded
# gradients; rank 0 writes each job's whole tensors and record
RANK = textwrap.dedent("""
    import json, sys, time, numpy as np, torch, torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_mesh_from_plan
    from repro_torch.launch.train import Trainer
    from repro_torch.models import moe
    from repro_torch.models import placement as P
    from torch.distributed.tensor import DTensor
    grouped = moe.moe_grouped
    on_dtensors = []
    def counted(p, x, cfg):
        on_dtensors.append(isinstance(x, DTensor))
        return grouped(p, x, cfg)
    moe.moe_grouped = counted
    store, rank, n, jobs = sys.argv[1:5]
    rank, n = int(rank), int(n)
    dist.init_process_group("gloo", rank=rank, world_size=n,
                            store=dist.FileStore(store, n))
    TINY, RUN = json.loads(sys.argv[5]), json.loads(sys.argv[6])
    for job in json.loads(open(jobs).read()):
        t0 = time.time()
        on_dtensors.clear()
        cfg = get_config(job["arch"]).reduced(**TINY)
        mesh = make_mesh_from_plan(job["mesh"], device_type="cpu")
        if job["kind"] == "optim":
            from tests_optim import eight_bit_updates
            params, st, ef = eight_bit_updates(cfg, mesh)
            whole = {f"params/{k}": P.whole(v) for k, v in params.items()}
            whole.update({f"m_q/{k}": P.whole(v) for k, v in st.m_q.items()})
            whole.update({f"v_s/{k}": P.whole(v) for k, v in st.v_s.items()})
            whole.update({f"ef/{k}": P.whole(v) for k, v in ef.items()})
            rec = {"placements": {k: [str(p) for p in v.placements]
                                  for k, v in st.m_q.items()},
                   "param_placements": {k: [str(p) for p in v.placements]
                                        for k, v in params.items()},
                   "mesh_shape": list(P.layout_mesh(mesh).shape)}
        else:
            run = RunConfig(**RUN, optimizer=job.get("optimizer", "adamw"),
                            microbatch=job.get("microbatch", 0))
            tr = Trainer(cfg, ShapeConfig("tiny", job["S"], job["B"],
                                          "train"), run, mesh=mesh,
                         ckpt_dir=job["ckpt"],
                         grad_compress=job.get("grad_compress", False))
            if job["kind"] == "restore":      # the latest checkpoint only
                start, state = tr.restore_or_init()
                losses = []
            else:
                state, losses = tr.train(job["steps"],
                                         ckpt_every=job.get("ckpt_every", 0),
                                         log_every=0)
            whole = {f"params/{k}": P.whole(v)
                     for k, v in state["params"].items()}
            rec = {"losses": losses,
                   "grouped_calls": [len(on_dtensors), sum(on_dtensors)],
                   "placements": {k: [str(p) for p in v.placements]
                                  for k, v in state["params"].items()},
                   "layout": list(P.layout_mesh(mesh).mesh_dim_names)}
            if run.optimizer == "adamw8bit":  # the int8 state, whole
                for f in ("m_q", "m_s", "v_q", "v_s"):
                    whole.update({f"{f}/{k}": P.whole(v) for k, v in
                                  getattr(state["opt"], f).items()})
                rec["opt_placements"] = {
                    k: [str(p) for p in v.placements]
                    for k, v in state["opt"].m_q.items()}
                rec["step"] = int(state["opt"].step)
        rec["seconds"] = time.time() - t0
        if rank == 0:
            np.savez(job["out"] + ".npz",
                     **{k: v.detach().float().numpy()
                        for k, v in whole.items()})
            with open(job["out"] + ".json", "w") as f:
                json.dump(rec, f)
    dist.destroy_process_group()
""")

# the seeded gradients through three AdamW8bit updates with int8
# compression, on the mesh's layout (a module the ranks import)
OPTIM = textwrap.dedent("""
    import torch
    from repro_torch.models import placement as P
    from repro_torch.models import sharding as SH
    from repro_torch.models.convert import stack_groups
    from repro_torch.models.registry import build_model
    from repro_torch.optim.grad_compress import (
        compress_with_error_feedback, init_error_feedback)
    from repro_torch.optim.optimizer import (QBLOCK, make_optimizer,
                                             warmup_cosine)

    def eight_bit_updates(cfg, mesh=None):
        model = build_model(cfg, "cpu", seed=3)
        params = dict(model.named_parameters())
        gen = torch.Generator().manual_seed(4)
        grads = [{n: torch.randn(p.shape, generator=gen) * 1e-3
                  for n, p in params.items()} for _ in range(3)]
        params = {n: p.detach().clone() for n, p in params.items()}
        if mesh is not None:
            specs = SH.param_pspecs(cfg, params, mesh, mode="train")
            params = {n: P.distribute(p, mesh, specs[n])
                      for n, p in params.items()}
            grads = [{n: P.distribute(g[n], mesh, specs[n]) for n in g}
                     for g in grads]
        groups = stack_groups(params, QBLOCK)
        opt = make_optimizer("adamw8bit", warmup_cosine(3e-3, 2, 40),
                             groups=groups)
        st, ef = opt.init(params), init_error_feedback(params)
        for g in grads:
            g, ef = compress_with_error_feedback(g, ef, groups)
            params, st, _ = opt.update(g, st, params)
        return params, st, ef
""")

# the reference's Trainer on a 2 x 2 fake-device mesh: each arch 4 steps
# with and without 2 microbatches, llama also 8 steps; and llama's 3 steps
# of AdamW8bit with int8 compression on the mesh and on one device
REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, numpy as np
    from repro.configs.base import RunConfig, ShapeConfig
    from repro.configs.registry import get_config
    from repro.launch.mesh import _make_mesh
    from repro.launch.train import Trainer
    tiny, run, out = eval(sys.argv[1]), eval(sys.argv[2]), sys.argv[3]
    shape = ShapeConfig("tiny", 32, 4, "train")
    mesh = _make_mesh((2, 2), ("data", "model"))
    res = {}
    for arch in ("llama3.2-3b", "mixtral-8x7b"):
        for micro in (0, 2):
            tr = Trainer(get_config(arch).reduced(**tiny), shape,
                         RunConfig(**run, microbatch=micro), mesh=mesh)
            long = (arch, micro) == ("llama3.2-3b", 0)
            for steps in (4, 8) if long else (4,):
                state, losses = tr.train(steps, log_every=0)
                res[(arch, micro, steps)] = (losses, jax.tree.map(
                    np.asarray, state["params"]))
    for where, m in (("mesh", mesh), ("one", None)):
        tr = Trainer(get_config("llama3.2-3b").reduced(**tiny), shape,
                     RunConfig(**run, optimizer="adamw8bit"), mesh=m,
                     grad_compress=True)
        res[("8bit", where)] = tr.train(3, log_every=0)[1]
    with open(out, "wb") as f:
        pickle.dump(res, f)
""")


def _env(tmp: Path):
    return dict(os.environ, PYTHONPATH=f"{SRC}{os.pathsep}{tmp}",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")


def _start_ranks(tmp: Path, n: int, jobs):
    run = Path(tempfile.mkdtemp(dir=tmp))     # a fresh store every group
    (run / "jobs.json").write_text(json.dumps(jobs))
    return [subprocess.Popen(
        [sys.executable, "-c", RANK, str(run / "store"), str(r), str(n),
         str(run / "jobs.json"), json.dumps(TINY), json.dumps(RUN)],
        env=_env(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(n)]


def _join(procs, what: str):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=JOIN_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"{what} did not finish in {JOIN_S} s")
    rcs = [p.returncode for p in procs]
    assert rcs == [0] * len(procs), f"{what}: {rcs}\n" + "\n".join(
        o[-3000:] for o in outs)


def _cfg(arch):
    return get_config(arch).reduced(**TINY)


def _trainer(arch, ckpt=None, microbatch=0, optimizer="adamw",
             grad_compress=False):
    return Trainer(_cfg(arch), ShapeConfig("tiny", S, B, "train"),
                   RunConfig(**RUN, microbatch=microbatch,
                             optimizer=optimizer),
                   device="cpu", ckpt_dir=ckpt, grad_compress=grad_compress)


def _step0(arch, tree, d: Path, optimizer="adamw", grad_compress=False):
    """A step-0 checkpoint in ``d`` that holds the reference's initial
    weights and a fresh optimizer state."""
    tr = _trainer(arch, optimizer=optimizer, grad_compress=grad_compress)
    state = tr.init_state()
    with torch.no_grad():
        for name, t in params_from_jax(tree).items():
            state["params"][name].copy_(t)
    Checkpointer(str(d)).save(0, state, blocking=True)


def _load(out: Path):
    with np.load(str(out) + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(Path(str(out) + ".json").read_text()), arrays


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_mesh")
    (tmp / "tests_optim.py").write_text(OPTIM)
    ref_out = tmp / "reference.pkl"
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE, repr(TINY),
                            repr(RUN), str(ref_out)], env=_env(tmp),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                           text=True)
    init = {a: jax.tree.map(np.asarray, jax_build(jax_config(a).reduced(
        **TINY)).init(jax.random.PRNGKey(0))) for a in ARCHS}
    ck = {}
    for arch in ARCHS:
        ck[arch] = tmp / f"step0_{arch}"
        _step0(arch, init[arch], ck[arch])
    ck["8bit"] = tmp / "step0_8bit"
    _step0("llama3.2-3b", init["llama3.2-3b"], ck["8bit"],
           optimizer="adamw8bit", grad_compress=True)

    def job(name, arch, src, **kw):
        d = tmp / f"ckpt_{name}"
        shutil.copytree(ck[src], d)
        return {"kind": "train", "arch": arch, "ckpt": str(d), "B": B,
                "S": S, "out": str(tmp / name), **kw}
    square = {"data": 2, "model": 2}
    group_a = [job(f"i_{a}", a, a, mesh=square, steps=4,
                   ckpt_every=4 if a == "llama3.2-3b" else 0)
               for a in ARCHS]
    group_a += [job("iii", "llama3.2-3b", "8bit", mesh=square, steps=3,
                    ckpt_every=3, optimizer="adamw8bit", grad_compress=True),
                {"kind": "optim", "arch": "llama3.2-3b", "mesh": square,
                 "out": str(tmp / "iii_optim")}]
    pod = {"pod": 2, "data": 2, "model": 1}
    group_b = [job(f"ii_{a}", a, a, mesh=pod, steps=4, microbatch=2)
               for a in ARCHS]
    group_b.append({"kind": "optim", "arch": "llama3.2-3b", "mesh": pod,
                    "out": str(tmp / "iii_optim_pod")})
    procs_a = _start_ranks(tmp, 4, group_a)
    procs_b = _start_ranks(tmp, 4, group_b)

    single = {}                 # the port's one-process runs, meanwhile
    for arch in ARCHS:
        for micro in (0, 2):
            d = tmp / f"single_{arch}_{micro}"
            shutil.copytree(ck[arch], d)
            tr = _trainer(arch, str(d), microbatch=micro)
            state, losses = tr.train(8 if micro == 0 else 4, log_every=0)
            single[(arch, micro)] = (losses, {
                n: p.detach().numpy() for n, p in state["params"].items()})
    d = tmp / "single_8bit"
    shutil.copytree(ck["8bit"], d)
    single["8bit"] = _trainer("llama3.2-3b", str(d), optimizer="adamw8bit",
                              grad_compress=True).train(3, log_every=0)[1]
    sys.path.insert(0, str(tmp))
    try:
        from tests_optim import eight_bit_updates
        single["optim"] = eight_bit_updates(_cfg("llama3.2-3b"))
    finally:
        sys.path.remove(str(tmp))

    _join(procs_a, "the (data 2, model 2) ranks")
    # elastic restart: the step-4 checkpoint of 4 ranks onto 2
    from repro_torch.runtime.fault_tolerance import plan_mesh
    elastic = {"kind": "train", "arch": "llama3.2-3b",
               "ckpt": group_a[0]["ckpt"], "B": B, "S": S,
               "mesh": plan_mesh(2, 2), "steps": 8,
               "out": str(tmp / "iv")}
    # and the 8-bit run's step-3 checkpoint (grouped int8 state) onto 2
    restore = {"kind": "restore", "arch": "llama3.2-3b",
               "ckpt": group_a[2]["ckpt"], "B": B, "S": S,
               "mesh": plan_mesh(2, 2), "optimizer": "adamw8bit",
               "grad_compress": True, "out": str(tmp / "iv_8bit")}
    procs_c = _start_ranks(tmp, 2, [elastic, restore])
    _join(procs_b, "the (pod 2, data 2, model 1) ranks")
    _join(procs_c, "the 2 elastic ranks")
    try:
        ref_log = ref.communicate(timeout=JOIN_S)[0]
    except subprocess.TimeoutExpired:
        ref.kill()
        pytest.fail(f"the reference did not finish in {JOIN_S} s")
    assert ref.returncode == 0, ref_log[-3000:]
    with open(ref_out, "rb") as f:
        reference = {k: v if k[0] == "8bit" else (v[0], params_from_jax(v[1]))
                     for k, v in pickle.load(f).items()}
    return {"tmp": tmp, "reference": reference, "single": single,
            "ckpt_iv": group_a[0]["ckpt"], "ckpt_8bit": group_a[2]["ckpt"]}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _expected_placements(cfg, mesh: dict):
    """The placements ``param_pspecs(mode="train")`` gives each parameter
    on the layout mesh (pod and data flattened into one dim), as str."""
    model = build_model(cfg, device="meta")
    specs = SH.param_pspecs(cfg, dict(model.named_parameters()), mesh,
                            mode="train")
    layout = [("pod", "data") if "pod" in mesh else ("data",), ("model",)]
    out = {}
    for name, spec in specs.items():
        pl = []
        for axes in layout:
            dims = [d for d, a in enumerate(spec) if a is not None and
                    set((a,) if isinstance(a, str) else a) & set(axes)]
            pl.append(f"S({dims[0]})" if dims else "R")
        out[name] = pl
    return out


def _check_against(runs, name, arch, micro, mesh):
    rec, arrays = _load(runs["tmp"] / name)
    ref_losses, ref_params = runs["reference"][(arch, micro, 4)]
    one_losses, _ = runs["single"][(arch, micro)]
    assert _rel(rec["losses"], ref_losses) < 1e-4, (rec["losses"],
                                                    ref_losses)
    assert _rel(rec["losses"], one_losses[:4]) < 1e-4, (rec["losses"],
                                                        one_losses)
    assert rec["placements"] == _expected_placements(_cfg(arch), mesh)
    assert set(arrays) == {f"params/{n}" for n in ref_params}
    for n, want in ref_params.items():
        np.testing.assert_allclose(arrays[f"params/{n}"], want.numpy(),
                                   atol=1e-4, rtol=0, err_msg=n)
    return rec


@pytest.mark.parametrize("arch", ARCHS)
def test_square_mesh_matches_the_reference_and_one_process(runs, arch):
    rec = _check_against(runs, f"i_{arch}", arch, 0,
                         {"data": 2, "model": 2})
    assert rec["layout"] == ["data", "model"]
    # the capacity route ran on DTensors (each rank routing its own rows),
    # in both layers, forward and backward's recompute alike
    calls, on_dtensors = rec["grouped_calls"]
    if arch == "mixtral-8x7b":
        assert calls > 0 and on_dtensors == calls, rec
    else:
        assert calls == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_fsdp_over_flattened_pod_data_with_microbatches(runs, arch):
    rec = _check_against(runs, f"ii_{arch}", arch, 2,
                         {"pod": 2, "data": 2, "model": 1})
    assert rec["layout"] == ["pod_data", "model"]
    assert any(pl[0] == "S(0)" or pl[0] == "S(1)"
               for pl in rec["placements"].values())


def _block_placements(param_pl, shape, mesh_shape):
    """Where the int8 blocks of a parameter laid out as ``param_pl`` live:
    split as the parameter is where each rank's shard is a run of whole
    256-blocks of the flattened tensor (split along dim 0 only, evenly),
    else over every mesh dim."""
    pl = ["R" if n == 1 else p for p, n in zip(param_pl, mesh_shape)]
    k = int(np.prod([n for p, n in zip(pl, mesh_shape) if p != "R"]))
    if set(pl) <= {"R", "S(0)"} and (k == 1 or (
            shape[0] % k == 0 and shape[0] // k * int(np.prod(shape[1:]))
            % 256 == 0)):
        return pl
    return ["S(0)"] * len(mesh_shape)


@pytest.mark.parametrize("mesh", ["square", "pod"])
def test_eight_bit_blocks_are_the_global_tensors(runs, mesh):
    """Three AdamW8bit updates with int8 compression of the same seeded
    gradients (norm below the clip, so the clip scale is exactly 1) on the
    mesh and in one process.  A parameter whose shards are runs of whole
    blocks keeps its blocks where its shard is (quantized on its own rank,
    nothing gathered); any other's blocks are split over the mesh."""
    name = {"square": "iii_optim", "pod": "iii_optim_pod"}[mesh]
    rec, arrays = _load(runs["tmp"] / name)
    params, st, ef = runs["single"]["optim"]
    for kind, tree in (("params", params), ("m_q", st.m_q),
                       ("v_s", st.v_s), ("ef", ef)):
        for n, t in tree.items():
            np.testing.assert_allclose(arrays[f"{kind}/{n}"],
                                       t.float().numpy(), atol=1e-5,
                                       rtol=0, err_msg=f"{kind}/{n}")
    want = {n: _block_placements(rec["param_placements"][n],
                                 tuple(params[n].shape), rec["mesh_shape"])
            for n in params if n in st.m_q}
    # a group of the reference's stacked leaves (the norms, 32 a layer):
    # gathered whole, its blocks split over the mesh
    groups = stack_groups(params, QBLOCK)
    assert sorted(groups) == ["layers.*.ln1", "layers.*.ln2"]
    want.update({k: ["S(0)"] * len(rec["mesh_shape"]) for k in groups})
    assert rec["placements"] == want
    kept = [n for n, pl in want.items()
            if pl == rec["param_placements"].get(n)]
    assert kept and len(kept) < len(want)
    if mesh == "pod":           # a sharded weight quantized on its rank
        assert any("S(0)" in want[n] for n in kept), want


def test_eight_bit_trainer_matches_one_process(runs):
    """The Trainer's 3 steps of AdamW8bit + int8 compression on the mesh:
    every loss within 1e-5 relative of the one-process run's, the third
    (after AdamW8bit's second update, which divides by eps where a block's
    int8 second moment is 0, so every run blows up there: the reference's
    own arithmetic, ROADMAP Queue 3 item 9) too.  The reference's run on
    its 2 x 2 mesh is as close to its one-device run.  The port's losses
    are the reference's at every step, on the mesh and on one device:
    within 1e-5 at steps 1 and 2 and 1e-4 at step 3, past the blow-up
    (the port quantizes the reference's stacked [L, ...] leaves in the
    stack's own 256-blocks, ``convert.stack_groups``: this model's norms,
    32 a layer, are one group each)."""
    rec, _ = _load(runs["tmp"] / "iii")
    one = runs["single"]["8bit"]
    ref_mesh = runs["reference"][("8bit", "mesh")]
    ref_one = runs["reference"][("8bit", "one")]
    assert len(rec["losses"]) == len(one) == len(ref_mesh) == 3
    assert _rel(rec["losses"], one) < 1e-5, (rec["losses"], one)
    assert _rel(ref_mesh, ref_one) < 1e-5, (ref_mesh, ref_one)
    for got in (rec["losses"], one):
        for want in (ref_mesh, ref_one):
            assert _rel(got[:2], want[:2]) < 1e-5, (got, want)
            assert _rel(got[2:], want[2:]) < 1e-4, (got, want)
    assert rec["losses"][2] > 10 * rec["losses"][0] and \
        ref_mesh[2] > 10 * ref_mesh[0]


def test_eight_bit_checkpoint_restores_onto_another_mesh(runs):
    """The 8-bit run's step-3 checkpoint, written by 4 ranks on (data 2,
    model 2), holds the grouped int8 state under the groups' keys; 2 ranks
    on ``make_mesh_from_plan(plan_mesh(2, 2))`` and a plain Trainer each
    restore it bit for bit as the 4 ranks held it, the groups' blocks
    split over the new mesh."""
    rec4, at3 = _load(runs["tmp"] / "iii")
    rec2, got = _load(runs["tmp"] / "iv_8bit")
    assert rec4["step"] == rec2["step"] == 3
    for k in ("layers.*.ln1", "layers.*.ln2"):
        assert at3[f"m_q/{k}"].shape == (1, 256)     # 2 layers x 32
        assert rec4["opt_placements"][k] == ["S(0)", "S(0)"]
        assert rec2["opt_placements"][k] == ["S(0)", "S(0)"]
        assert f"m_q/{k.replace('*', '0')}" not in at3
    opt_keys = {k for k in at3 if not k.startswith("params/")}
    assert opt_keys == {k for k in got if not k.startswith("params/")}
    for k in opt_keys:
        np.testing.assert_array_equal(got[k], at3[k], err_msg=k)
    tr = _trainer("llama3.2-3b", optimizer="adamw8bit", grad_compress=True)
    saved = Checkpointer(runs["ckpt_8bit"]).restore(3, tr.init_state())
    for k in opt_keys:
        field, name = k.split("/", 1)
        t = getattr(saved["opt"], field)[name]
        assert not hasattr(t, "placements")
        np.testing.assert_array_equal(t.float().numpy(), at3[k], err_msg=k)


def _restore_iv(runs, d: Path):
    """The 4-rank step-4 checkpoint (copied to ``d``) restored whole into
    a plain Trainer."""
    tr = _trainer("llama3.2-3b")
    return Checkpointer(str(d)).restore(4, tr.init_state())


def test_elastic_restart_onto_two_ranks_and_onto_none(runs, tmp_path):
    rec, arrays = _load(runs["tmp"] / "iv")
    assert rec["layout"] == ["data", "model"]
    assert len(rec["losses"]) == 4              # steps 4..7
    one_losses, one_params = runs["single"][("llama3.2-3b", 0)]
    ref_losses, ref_params = runs["reference"][("llama3.2-3b", 0, 8)]
    for want in (one_losses, ref_losses):
        assert _rel(rec["losses"], want[4:8]) < 1e-4, (rec["losses"], want)
    for n, want in one_params.items():
        np.testing.assert_allclose(arrays[f"params/{n}"], want, atol=1e-4,
                                   rtol=0, err_msg=n)
        np.testing.assert_allclose(arrays[f"params/{n}"],
                                   ref_params[n].numpy(), atol=1e-4,
                                   rtol=0, err_msg=n)
    # the 4-rank checkpoint, restored whole into a plain Trainer
    _, at4 = _load(runs["tmp"] / "i_llama3.2-3b")
    ckpt = Checkpointer(runs["ckpt_iv"])
    assert ckpt.steps()[-1] == 4
    meta = json.loads((Path(runs["ckpt_iv"]) / "step_4" / "meta.json")
                      .read_text())
    assert meta["hosts"] == 4
    pieces = meta["tensors"]["params"]["layers.0.attn.wq"]["pieces"]
    assert len(pieces) == 4 and sorted(p["host"] for p in pieces) == \
        [0, 1, 2, 3]
    saved = _restore_iv(runs, runs["ckpt_iv"])
    assert int(saved["opt"].step) == 4
    for n, t in saved["params"].items():
        assert not hasattr(t, "placements")
        np.testing.assert_array_equal(t.numpy(), at4[f"params/{n}"],
                                      err_msg=n)


@pytest.mark.parametrize("fault", ["missing", "short"])
def test_restore_raises_where_the_pieces_miss_the_shard(runs, tmp_path,
                                                        fault):
    """A ``meta.json`` that lost one of a tensor's four pieces, or records
    one smaller than it was written, leaves part of the shard unwritten:
    the restore raises, naming the tensor, and never returns
    uninitialized memory."""
    d = tmp_path / "ckpt"
    shutil.copytree(runs["ckpt_iv"], d)
    meta_path = d / "step_4" / "meta.json"
    meta = json.loads(meta_path.read_text())
    pieces = meta["tensors"]["params"]["layers.0.attn.wq"]["pieces"]
    if fault == "missing":
        pieces.pop(1)
    else:
        pieces[1]["size"][0] -= 1
    meta_path.write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="layers.0.attn.wq"):
        _restore_iv(runs, d)


def test_a_cuda_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = types.SimpleNamespace(device_type="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_cfg("llama3.2-3b"), ShapeConfig("tiny", S, B, "train"),
                RunConfig(**RUN), mesh=mesh)
    with pytest.raises(ValueError, match="not the mesh's"):
        Trainer(_cfg("llama3.2-3b"), ShapeConfig("tiny", S, B, "train"),
                RunConfig(**RUN), mesh=types.SimpleNamespace(
                    device_type="cpu"), device="cuda")


def test_restore_onto_the_given_shardings(tmp_path):
    """``restore(step, like, shardings)``: a leaf's layout from
    ``shardings`` (a ``(mesh, placements)`` pair) in place of ``like``'s,
    None keeping ``like``'s; a 1-rank gloo mesh in this process."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import single_device_mesh
    state = {"params": {"w": torch.arange(12.0).reshape(4, 3),
                        "b": torch.ones(3, dtype=torch.bfloat16)}}
    Checkpointer(str(tmp_path)).save(2, state, blocking=True)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = single_device_mesh("cpu")
        got = Checkpointer(str(tmp_path)).restore(2, state, shardings={
            "params": {"w": (mesh, [Shard(1), Replicate()]), "b": None}})
        w = got["params"]["w"]
        assert isinstance(w, DTensor)
        assert tuple(w.placements) == (Shard(1), Replicate())
        assert torch.equal(w.full_tensor(), state["params"]["w"])
        assert torch.equal(got["params"]["b"], state["params"]["b"])
        assert got["params"]["b"].dtype == torch.bfloat16
    finally:
        dist.destroy_process_group()
