"""Multi-pod dry-run: one step of every (architecture x input shape) on the
production meshes, traced on DTensors over a fake process group, with its
memory, FLOPs, collectives and analytical roofline.  The port of
``repro/launch/dryrun.py``.

PyTorch has no GSPMD, so where the reference lowers and compiles each cell
for 512 fabricated host devices, this traces it as one rank of the mesh
would run it:

* ``main()`` (never the import) starts a fake process group of the mesh's
  size (``torch.testing._internal.distributed.fake_pg``: collectives
  return at once and move nothing) and builds the production
  ``DeviceMesh`` over it;
* under ``FakeTensorMode`` the parameters (from a model built on the meta
  device), optimizer state and inputs are made and laid out by the
  sharding rules (``models/sharding.py``) as DTensors;
* one step of the cell runs on them: ``train`` the port's train step
  (``models/train.py``) with AdamW and ``plan_microbatch``'s microbatch;
  ``prefill`` the forward's last-position logits, or for an ssm cell with
  ``--seq-parallel`` the sequence-parallel forward (``models/mamba_sp.py``,
  replicated weights, this rank's shard of the sequence, the collectives
  over the mesh's ``model`` group); ``decode`` one ``decode_step`` of
  ``--verify-block`` tokens at the end of a full cache.

Every tensor is laid out by ``models/placement.py``, the layout the
mesh ``Trainer`` trains with, so a record describes the step that trains:
on the 2 x 16 x 16 mesh the tensors live on the flattened (pod_data,
model) mesh, FSDP weights are gathered where they are read, the residual
stream is pinned to the batch sharding, and an op DTensor cannot place is
run on all-gathered inputs and counted under ``resharded_ops``.  What the
trace adds of its own: ``layers.mha`` runs per head (``_mha_per_head``:
the same values), since the grouped einsum turns a head sharding into a
strided one that DTensor's planner walks index by index.

The cells trace the kernels' plain versions: fake tensors live on the CPU
device, and the kernels go through ``ctypes`` and cannot take a fake
tensor.  The slot-grouped expert FFN's plain versions read the group
sizes back to the host, which no fake tensor can; they are traced as
grouped GEMMs (``_traced_slot_ffn``).

The record keeps the reference's keys.  ``memory``: ``argument_bytes`` is
the local shards of the step's arguments (parameters, optimizer state,
batch or cache and tokens); ``peak_per_device`` the rank's live bytes at
their peak (``_PerRank``: every local tensor the step's ops return, the
arguments included; not the buffers inside one op, such as a
redistribution's); ``mem_tracker_peak`` ``MemTracker``'s peak, which also
counts the whole-tensor stand-ins DTensor's sharding propagation computes
with; ``output_bytes`` the step's new local tensors (logits; for train
the metrics), ``alias_bytes`` what it updates in place (the cache; the
parameters and optimizer state for train), ``temp_bytes`` the peak less
the arguments.  ``xla_cost``: one rank's FLOPs (``FlopCounterMode`` over
the local ops on the rank's tensors); XLA's bytes-accessed figure has no
counterpart here and stays null.  ``hlo_collectives``: each collective
family's count (``CommDebugMode``) and the bytes of its local results.
``roofline``: ``models/costmodel.roofline_terms`` (the card's peaks).
``status`` is ``ok``, ``skipped`` (``shape_applicable``) or ``error``
(the exception and, where it names one, the op).

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b \
        --shape decode_32k --multi-pod both --out results.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import signal
import time
import traceback
import weakref
from contextlib import ExitStack, contextmanager
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from torch.distributed.tensor.experimental import (implicit_replication,
                                                  register_sharding)
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from repro_torch.configs.base import (ALL_SHAPES, SHAPES, RunConfig,
                                      shape_applicable)
from repro_torch.configs.registry import ASSIGNED, get_config
from repro_torch.kernels import ref as R
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import layers as L
from repro_torch.models import placement as P
from repro_torch.models import sharding as SH
from repro_torch.models.convert import stack_groups
from repro_torch.models.costmodel import roofline_terms
from repro_torch.models.mamba_sp import seq_parallel_forward
from repro_torch.models.registry import build_model, input_specs
from repro_torch.models.train import make_train_step
from repro_torch.optim.optimizer import (QBLOCK, make_optimizer,
                                         warmup_cosine)

# collective op name (functional or c10d) -> family, as costmodel names them
_FAMILIES = (("all_gather", "all_gather"), ("allgather", "all_gather"),
             ("reduce_scatter", "reduce_scatter"),
             ("all_reduce", "all_reduce"), ("allreduce", "all_reduce"),
             ("all_to_all", "all_to_all"), ("alltoall", "all_to_all"),
             ("broadcast", "broadcast"))
_COLL_NAMESPACES = ("_c10d_functional", "c10d_functional", "c10d")
# a cell whose trace runs longer ends as an error naming the op it was in:
# on the 2 x 16 x 16 mesh DTensor's redistribution planner searches a graph
# of placements for each gradient of a weight sharded over (pod, data), and
# a train cell can take hours
CELL_TIMEOUT_S = 900
_OP_RE = re.compile(r"\b(aten|_c10d_functional|c10d)\.[A-Za-z0-9_]+"
                    r"(?:\.[A-Za-z0-9_]+)?")


def _family(func) -> Optional[str]:
    name = str(func)
    if name.split(".")[0] not in _COLL_NAMESPACES:
        return None
    for key, fam in _FAMILIES:
        if key in name:
            return fam
    return None


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _has_dtensor(tree) -> bool:
    return any(isinstance(a, DTensor) for a in tree_leaves(tree))


def _local_bytes(tree) -> int:
    return sum(_local(t).numel() * _local(t).element_size()
               for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


class _RankTensors:
    """The tensors one rank holds: DTensor shards, plain tensors the step
    makes, and whatever local ops compute from them.  DTensor's sharding
    propagation computes with whole-tensor stand-ins that a mode under
    DTensor's dispatch also sees; they derive from none of these."""

    def __init__(self):
        self.ids = WeakIdKeyDictionary()

    def add(self, tree):
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self.ids[_local(t)] = True

    def any(self, tree) -> bool:
        return any(isinstance(t, torch.Tensor) and not isinstance(t, DTensor)
                   and t in self.ids for t in tree_leaves(tree))


class _LocalFlops(FlopCounterMode):
    """``FlopCounterMode`` counting one rank's FLOPs: the local ops on the
    rank's tensors, not the DTensor op itself (which it also sees) nor the
    propagation's whole-tensor stand-ins."""

    def __init__(self, rank: _RankTensors):
        super().__init__(display=False)
        self.rank = rank

    def _count_flops(self, func_packet, out, args, kwargs):
        if not self.rank.any((args, kwargs)):
            return out
        self.rank.add(out)
        return super()._count_flops(func_packet, out, args, kwargs)


class _PerRank(TorchDispatchMode):
    """Above DTensor's dispatch: marks the rank's tensors (every plain
    tensor an op takes or returns there, every DTensor's shard), and keeps
    the rank's live bytes and their peak: each storage of a local tensor
    the step's ops return, from its first appearance until it is freed.
    The temporaries inside one op (a redistribution's buffers) it does not
    see."""

    def __init__(self, rank: _RankTensors):
        super().__init__()
        self.rank = rank
        self.live: Dict[int, int] = {}
        self.now = self.peak = 0

    def track(self, tree):
        self.rank.add(tree)
        for t in tree_leaves(tree):
            if not isinstance(t, torch.Tensor):
                continue
            st = _local(t).untyped_storage()
            key = st._cdata
            if key in self.live:
                continue
            self.live[key] = st.nbytes()
            self.now += self.live[key]
            weakref.finalize(st, self._free, key)
        self.peak = max(self.peak, self.now)

    def _free(self, key):
        self.now -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.rank.add((args, kwargs))
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


def _group_size(args) -> Optional[int]:
    """The size of the process group a functional collective names (its
    last string argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in args if isinstance(a, str)]
    try:
        return _resolve_process_group(names[-1]).size()
    except Exception:
        return None


class _CollectiveBytes(TorchDispatchMode):
    """Sums the bytes of every collective's local result by family, and
    counts its calls by the size of the group they ran over."""

    def __init__(self):
        super().__init__()
        self.bytes: Dict[str, float] = {}
        self.groups: Dict[str, Dict[str, int]] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        fam = _family(func)
        if fam is not None and not _has_dtensor(args):
            self.bytes[fam] = self.bytes.get(fam, 0.0) + float(
                _local_bytes(out))
            size = str(_group_size(args))
            sizes = self.groups.setdefault(fam, {})
            sizes[size] = sizes.get(size, 0) + 1
        return out


def plan_microbatch(cfg, shape, mesh) -> int:
    """Gradient-accumulation depth so per-microbatch activations fit HBM."""
    dp = SH.mesh_axis_size(mesh, SH.data_axes(mesh))
    b_local = max(shape.global_batch // dp, 1)
    model = SH.mesh_axis_size(mesh, "model")
    seq_div = model if cfg.d_model % model == 0 else 1
    layers = cfg.num_layers + (cfg.encoder_layers or 0)
    per_sample = shape.seq_len * cfg.d_model * 2 * layers / seq_div
    budget = 4e9
    micro = 1
    while micro < b_local and (b_local / micro) * per_sample > budget:
        micro *= 2
    return micro


def _fake_inputs(specs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Meta input specs -> fake CPU tensors (call under the fake mode)."""
    return {k: torch.zeros(t.shape, dtype=t.dtype) for k, t in specs.items()}


def _grouped_ffn(x, w, grp_slot, grp_count):
    """x [P, d] (rows sorted by expert) through each row's expert of w
    [E, d, f] as one grouped GEMM."""
    counts = torch.zeros(w.shape[0], dtype=torch.int64).scatter_(
        0, grp_slot.long(), grp_count.long())
    return torch._grouped_mm(x, w, torch.cumsum(counts, 0).to(torch.int32))


@contextmanager
def _traced_slot_ffn():
    """The slot-grouped expert FFN's plain versions loop over the groups
    on the host (``tolist``), which no fake tensor can; while a cell is
    traced they are grouped GEMMs (``torch._grouped_mm``, the counterpart
    of the reference's ``lax.ragged_dot``): the same shapes and FLOPs."""
    def gate_up(x, row_tok, wg, wu, grp_slot, grp_start, grp_count):
        xr = x[row_tok.long()]
        return F.silu(_grouped_ffn(xr, wg, grp_slot, grp_count)) * \
            _grouped_ffn(xr, wu, grp_slot, grp_count)

    def up_gelu(x, row_tok, wu, grp_slot, grp_start, grp_count):
        return F.gelu(_grouped_ffn(x[row_tok.long()], wu, grp_slot,
                                   grp_count), approximate="tanh")

    def down(h, wd, grp_slot, grp_start, grp_count):
        return _grouped_ffn(h, wd, grp_slot, grp_count)

    saved = (R.slot_gate_up_ref, R.slot_up_gelu_ref, R.slot_down_ref)
    R.slot_gate_up_ref, R.slot_up_gelu_ref, R.slot_down_ref = \
        gate_up, up_gelu, down
    try:
        yield
    finally:
        R.slot_gate_up_ref, R.slot_up_gelu_ref, R.slot_down_ref = saved


def _mha_per_head(q, k, v, mask, softcap=None):
    """``layers.mha`` with the kv heads repeated to the q heads instead of
    the q heads grouped: the same scores, softmax and output.  Grouped,
    a head-sharded q reshaped to [.., Hkv, rep, ..] and flattened with the
    sequence by ``einsum`` becomes a strided sharding that DTensor's
    planner walks index by index (minutes a layer on a long sequence)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    if rep > 1:
        k, v = (t[:, :, :, None, :].expand(B, Skv, Hkv, rep, t.shape[-1])
                .reshape(B, Skv, H, t.shape[-1]) for t in (k, v))
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).float() / math.sqrt(D)
    if softcap is not None:
        scores = torch.tanh(scores / softcap) * softcap
    if mask is not None:        # [B|1, 1|Hkv, 1|rep, Sq, Skv]
        mask = mask[:, 0] if mask.shape[1] == mask.shape[2] == 1 else \
            mask.expand(mask.shape[0], Hkv, rep, Sq, Skv).reshape(
                mask.shape[0], H, Sq, Skv)
        scores = torch.where(mask, scores, torch.full(
            (), -1e30, dtype=torch.float32, device=scores.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


@contextmanager
def _traced_mha():
    """``layers.mha`` as ``_mha_per_head`` while a cell is traced."""
    saved = L.mha
    L.mha = _mha_per_head
    try:
        yield
    finally:
        L.mha = saved


_REGISTERED = []


def _register_grouped_mm():
    """Once per process: the grouped GEMM's FLOPs (2 per multiply-add of
    every row) and its tensor-parallel DTensor strategies (replicated; the
    output columns sharded with the weight's; the contraction sharded on
    both sides, a partial sum)."""
    if _REGISTERED:
        return

    @register_flop_formula(torch.ops.aten._grouped_mm)
    def _flops(a_shape, b_shape, *args, out_shape=None, **kwargs):
        return 2 * a_shape[0] * a_shape[1] * b_shape[-1]

    @register_sharding(torch.ops.aten._grouped_mm.default)
    def _sharding(x, w, offs=None, bias=None, out_dtype=None):
        rest = [Replicate(), None, None]
        return [([Replicate()], [Replicate(), Replicate()] + rest),
                ([Shard(1)], [Replicate(), Shard(2)] + rest),
                ([Partial()], [Shard(1), Shard(1)] + rest)]

    _REGISTERED.append(True)


def _error_op(e: BaseException) -> Optional[str]:
    m = _OP_RE.search(str(e))
    return m.group(0) if m else None


def lower_cell(arch: str, shape_name: str, mesh, *, optimizer: str = "adamw",
               weight_gather: Optional[bool] = None, verify_block: int = 1,
               capacity_factor: Optional[float] = None,
               remat_override: Optional[bool] = None,
               remat_policy: Optional[str] = None,
               seq_parallel: bool = False,
               extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Trace one (arch, shape, mesh) cell.  ``mesh``: a ``DeviceMesh`` over
    the fake process group.  The keyword knobs are the reference's:
    ``weight_gather`` (ZeRO-style serving), ``verify_block`` (the SD
    verification block of a decode cell), ``capacity_factor`` / ``remat_*``
    (training)."""
    cfg = get_config(arch)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    if remat_override is not None:
        cfg = dataclasses.replace(cfg, remat=remat_override)
    if remat_policy is not None:
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}
    _register_grouped_mm()
    t0 = time.time()
    mesh_shape = SH.mesh_shape(mesh)
    model = build_model(cfg, device="meta")
    meta_params = dict(model.named_parameters())
    mode = "train" if shape.kind == "train" else "serve"
    if weight_gather is None and mode == "serve":
        weight_gather = SH.serve_weight_gather(meta_params, mesh)
    weight_gather = bool(mode == "serve" and weight_gather)
    specs = SH.param_pspecs(cfg, meta_params, mesh, mode=mode,
                            weight_gather=weight_gather)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    with fake:
        sp = shape.kind == "prefill" and seq_parallel and \
            cfg.family == "ssm"
        fsdp = mode == "train" or weight_gather
        params = P.place_params(model, None if sp else specs, mesh,
                                requires_grad=shape.kind == "train",
                                fsdp=fsdp)
        if not sp:
            P.pin_residual(model, mesh)
        aliased: Any = []
        if shape.kind == "train":
            micro = plan_microbatch(cfg, shape, mesh)
            run = RunConfig(microbatch=micro, optimizer=optimizer)
            opt = make_optimizer(optimizer, warmup_cosine(3e-4, 100, 10000),
                                 groups=stack_groups(params, QBLOCK))
            # the step count is a host value the update reads: a Python int
            # here (a tensor made under the fake mode has no value)
            state = opt.init(params)._replace(step=0)
            batch = _fake_inputs(input_specs(cfg, shape))
            batch = P.distribute_microbatches(batch, mesh, micro)
            step_fn = make_train_step(model, cfg, run, opt)
            args, aliased = (params, state, batch), (params, state)

            def step():
                return step_fn(params, state, batch)[-1]
            fn_desc = f"train_step(micro={micro})"
        elif sp:
            tok = _fake_inputs(input_specs(cfg, shape))["tokens"]
            dp = SH._fit(tok.shape[0], mesh, SH.data_axes(mesh))
            b_loc = tok.shape[0] // SH.mesh_axis_size(mesh, dp)
            tok = tok[:b_loc, :tok.shape[1] // mesh_shape["model"]]
            group = mesh.get_group("model")
            args = (params, tok)

            def step():
                return seq_parallel_forward(model, tok, group)
            fn_desc = "prefill_forward(seq_parallel)"
        elif shape.kind == "prefill":
            inputs = _fake_inputs(input_specs(cfg, shape))
            inputs = P.distribute_batch(inputs, mesh)
            args = (params, inputs)

            def step():
                if cfg.family == "encdec":
                    logits, _ = model.forward(inputs["tokens"],
                                              inputs["frames"])
                elif cfg.family == "vlm":
                    logits, _ = model.forward(
                        inputs["tokens"], patch_embeds=inputs["patch_embeds"])
                else:
                    logits, _ = model.forward(inputs["tokens"])
                return logits[:, -1]
            fn_desc = "prefill_forward"
        else:
            B, S = shape.global_batch, shape.seq_len
            cache = model.init_cache(B, S)
            cache = P.distribute_tree(
                cache, SH.cache_pspecs(cfg, cache, mesh), mesh)
            pos = S - verify_block
            cache["written"] = pos
            tok = torch.zeros((B, verify_block), dtype=torch.int32)
            tok = P.distribute(tok, mesh, P.batch_spec(tok.shape, mesh))
            args, aliased = (params, cache, tok), cache

            def step():
                return model.decode_step(cache, tok, pos)[0]
            fn_desc = f"serve_step(block={verify_block})"

        tracker = MemTracker()
        tracker.track_external(*[t for t in tree_leaves(args)
                                 if isinstance(t, torch.Tensor)])
        rank = _RankTensors()
        flops = _LocalFlops(rank)
        coll_bytes = _CollectiveBytes()
        comm = CommDebugMode()
        reshard = P.Reshard(tracker)
        live = _PerRank(rank)
        live.track(args)
        with ExitStack() as stack:
            if shape.kind != "train":
                stack.enter_context(torch.no_grad())
            # the counters that read local ops go under CommDebugMode and
            # MemTracker (a mode entered later sits above and dispatches
            # first); the reshard sees each DTensor op first, and the live
            # bytes each op's results
            for ctx in (implicit_replication(), _traced_slot_ffn(),
                        _traced_mha(), flops, coll_bytes, comm, tracker,
                        reshard, live):
                stack.enter_context(ctx)
            try:
                out = step()
            except CellTimeout as e:
                raise CellTimeout(f"{e}; in {reshard.last_op}") from e
        tracked = max((snap.get("Total", 0) for snap in
                       tracker.get_tracker_snapshot("peak").values()),
                      default=0)
        peak = live.peak
    arg_bytes = _local_bytes(args)
    counts: Dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        fam = _family(op)
        if fam is not None:
            counts[fam] = counts.get(fam, 0) + n
    colls = {fam: {"count": counts.get(fam, 0),
                   "bytes": coll_bytes.bytes.get(fam, 0.0),
                   "calls_by_group_size": coll_bytes.groups.get(fam, {})}
             for fam in sorted(set(counts) | set(coll_bytes.bytes))}
    analytical = roofline_terms(cfg, shape, mesh_shape, mode,
                                weight_gather=weight_gather,
                                verify_block=verify_block,
                                capacity_factor=capacity_factor,
                                remat=remat_override)
    rec = {
        "arch": arch, "shape": shape_name, "status": "ok", "fn": fn_desc,
        "mesh": mesh_shape,
        "layout_mesh": SH.mesh_shape(P.layout_mesh(mesh)),
        "weight_gather": weight_gather,
        "verify_block": verify_block,
        "capacity_factor": capacity_factor,
        "remat_override": remat_override,
        "compile_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "output_bytes": _local_bytes(out),
            "temp_bytes": max(peak - arg_bytes, 0),
            "alias_bytes": _local_bytes(aliased),
            "peak_per_device": peak,
            "mem_tracker_peak": tracked,
        },
        "xla_cost": {"flops_per_device_body": float(flops.get_total_flops()),
                     "bytes_per_device_body": None},
        "hlo_collectives": colls,
        "resharded_ops": reshard.resharded,
        "roofline": analytical,
    }
    if extra:
        rec.update(extra)
    return rec


class CellTimeout(BaseException):
    """A cell's trace ran past CELL_TIMEOUT_S (a BaseException, so that no
    ``except Exception`` on the way, DTensor's or ``Reshard``'s, takes
    it for a failed op)."""


def _cell_timeout(signum, frame):
    raise CellTimeout(f"the trace ran past {CELL_TIMEOUT_S} s")


def start_fake_world(world_size: int):
    """(Re)start the default process group as a fake one of
    ``world_size`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", world_size=world_size, rank=0,
                            store=FakeStore())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"),
                    default="both")
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--weight-gather", choices=("auto", "on", "off"),
                    default="auto")
    ap.add_argument("--verify-block", type=int, default=1)
    ap.add_argument("--capacity-factor", type=float, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", choices=("full", "selective"),
                    default=None)
    ap.add_argument("--seq-parallel", action="store_true",
                    help="ssm prefill: sequence-parallel mamba (replicated "
                         "weights, sharded sequence, state handoff)")
    ap.add_argument("--tag", default=None, help="label stored in the record")
    args = ap.parse_args(argv)
    wg = {"auto": None, "on": True, "off": False}[args.weight_gather]

    archs = list(ASSIGNED) if args.arch == "all" else args.arch.split(",")
    shapes = ([s.name for s in ALL_SHAPES] if args.shape == "all"
              else args.shape.split(","))
    pods = {"no": [False], "yes": [True], "both": [False, True]}[
        args.multi_pod]

    signal.signal(signal.SIGALRM, _cell_timeout)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], json.dumps(r.get("mesh", {}),
                                               sort_keys=True), r.get("tag"))
            for r in results}
    try:
        for multi_pod in pods:
            start_fake_world(512 if multi_pod else 256)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            mesh_key = json.dumps(SH.mesh_shape(mesh), sort_keys=True)
            for arch in archs:
                for shape in shapes:
                    if (arch, shape, mesh_key, args.tag) in done:
                        continue
                    print(f"[dryrun] {arch} x {shape} x {mesh_key} ...",
                          flush=True)
                    signal.alarm(CELL_TIMEOUT_S)
                    try:
                        rec = lower_cell(
                            arch, shape, mesh, optimizer=args.optimizer,
                            weight_gather=wg,
                            verify_block=args.verify_block,
                            capacity_factor=args.capacity_factor,
                            remat_override=(False if args.no_remat
                                            else None),
                            remat_policy=args.remat_policy,
                            seq_parallel=args.seq_parallel,
                            extra={"tag": args.tag} if args.tag else None)
                    except (Exception, CellTimeout) as e:
                        rec = {"arch": arch, "shape": shape,
                               "mesh": SH.mesh_shape(mesh),
                               "status": "error",
                               "error": f"{type(e).__name__}: "
                                        f"{str(e)[:1000]}",
                               "op": _error_op(e),
                               "trace": traceback.format_exc()[-2000:]}
                        if args.tag:
                            rec["tag"] = args.tag
                    finally:
                        signal.alarm(0)
                    results.append(rec)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1, default=float)
                    status = rec["status"]
                    if status == "ok":
                        m = rec["memory"]["peak_per_device"] / 1e9
                        print(f"  OK peak/device={m:.2f} GB "
                              f"dominant={rec['roofline']['dominant']} "
                              f"({rec['compile_s']}s)", flush=True)
                    else:
                        print(f"  {status.upper()}: "
                              f"{rec.get('reason', rec.get('error'))[:300]}",
                              flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_err = sum(1 for r in results if r["status"] == "error")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
