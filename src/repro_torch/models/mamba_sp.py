"""Sequence-parallel Mamba2 (SSD) prefill on a ``torch.distributed``
process group.  The port of ``repro/models/mamba_sp.py``.

Tensor parallelism shards ``d_inner`` and pays two activation all-reduces
per layer, the dominant roofline term for a small-d_model arch.  Here
instead:

* the weights are REPLICATED on every rank (mamba2-780m is 1.6 GB);
* the SEQUENCE is sharded: each rank holds one contiguous shard, rank r
  the r-th, and every pointwise op (projections, norms, gating) is
  shard-local;
* the SSD recurrence crosses shards through two tiny collectives per
  layer:

  - the causal conv's halo: every rank's last W-1 pre-conv rows
    ``[B, W-1, conv_ch]`` are all-gathered and each rank takes its left
    neighbour's (rank 0 takes zeros);
  - the state prefix: each shard scans from a zero state with ``ops.ssd``
    (the hand-written kernel on the card, ``ref.ssd_ref`` on the CPU),
    then its end state ``[B, H, P, N]`` f32 and its total decay ``[B, H]``
    are all-gathered, each rank folds the shards before it into its
    incoming state, and adds it in closed form:
    ``y_t += C_t . (state_in * exp(dA_cum_t))``.

Collective bytes per layer are O(shards * B * H * P * N), not
O(tokens * d_model).

The collectives follow the group's backend, by a rule and never as a
fallback after a failure: under ``gloo``, which runs almost no collective
on CUDA tensors, the tiny payloads go through the host and back; under
any other backend (``nccl``, the dry-run's ``fake``) they stay where they
are.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import mamba as M


def all_gather(t: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """[n, *t.shape]: every rank's ``t``, in group rank order, on t's
    device.  Under a gloo group a CUDA tensor is copied to the host for
    the collective and back."""
    via_host = dist.get_backend(group) == "gloo" and t.device.type == "cuda"
    src = (t.cpu() if via_host else t).contiguous()
    n = dist.get_world_size(group)
    out = funcol.all_gather_tensor(src, 0, group)
    out = funcol.wait_tensor(out) if isinstance(
        out, funcol.AsyncCollectiveTensor) else out
    out = out.view(n, *t.shape)
    return out.to(t.device) if via_host else out


def _mamba_block_local(blk, x: torch.Tensor, cfg, group: dist.ProcessGroup,
                       idx: int) -> torch.Tensor:
    """One mamba block on this rank's sequence shard, x: [B, S_loc, d]."""
    Bsz, S, _ = x.shape
    d_in, H, N, _ = M.dims(cfg)
    p = blk.mamba
    h = L.rms_norm(x, blk.ln1, cfg.norm_eps)
    z, xs, Bm, Cm, dt = M._split(torch.einsum("bsd,dp->bsp", h, p.in_proj),
                                 cfg)
    xBC_pre = torch.cat([xs, Bm, Cm], dim=-1)

    # --- causal conv with the halo from the left neighbour ---
    W = cfg.ssm_conv_width
    halos = all_gather(xBC_pre[:, S - (W - 1):], group)   # [n, B, W-1, ch]
    halo = halos[idx - 1] if idx > 0 else torch.zeros_like(halos[0])
    xs, Bm, Cm = torch.split(M._causal_conv(xBC_pre, p.conv_w, p.conv_b,
                                            halo), [d_in, N, N], dim=-1)
    xh = xs.reshape(Bsz, S, H, cfg.ssm_head_dim)
    dtf = F.softplus(dt.float() + p.dt_bias)
    A = -torch.exp(p.A_log)

    # --- local SSD from a zero initial state ---
    chunk = min(cfg.ssm_chunk, S)
    if S % chunk:
        raise ValueError(f"shard length {S} is not a multiple of the chunk "
                         f"{chunk}")
    y_loc, state_loc = ops.ssd(xh.contiguous(), dtf.contiguous(), A,
                               Bm.contiguous(), Cm.contiguous(), chunk)

    # --- cross-shard state prefix ---
    dA_cum = torch.cumsum(dtf * A, dim=1)                  # [B, S, H]
    states = all_gather(state_loc, group)                  # [n, B, H, P, N]
    decays = all_gather(torch.exp(dA_cum[:, -1]), group)   # [n, B, H]
    state_in = torch.zeros_like(state_loc)
    for j in range(idx):
        state_in = state_in * decays[j][:, :, None, None] + states[j]
    # fold the incoming state: y_t += C_t . (state_in * exp(dA_cum_t))
    y_corr = torch.einsum("bsn,bhpn->bshp", Cm.float(), state_in) \
        * torch.exp(dA_cum)[..., None]
    y = y_loc.float() + y_corr + xh.float() * p.D[:, None]
    y = y.reshape(Bsz, S, d_in).to(x.dtype)
    y = L.rms_norm(y * F.silu(z), p.norm, cfg.norm_eps)
    return x + torch.einsum("bsp,pd->bsd", y, p.out_proj)


@torch.no_grad()
def seq_parallel_forward(model, tokens: torch.Tensor,
                         group: Optional[dist.ProcessGroup] = None
                         ) -> torch.Tensor:
    """The mamba2 LM forward with the sequence sharded over ``group``
    (default: the world).  ``model``: an ssm-family ``DecoderLM``, the same
    weights on every rank; ``tokens`` [B, S_loc]: this rank's contiguous
    shard of the sequence (group rank r holds the r-th).  Returns the
    last-position logits [B, V] (the last shard's), on every rank."""
    cfg = model.cfg
    if cfg.family != "ssm":
        raise ValueError(f"{cfg.name}: sequence-parallel prefill is for the "
                         f"ssm family, not {cfg.family!r}")
    group = dist.group.WORLD if group is None else group
    idx, n = dist.get_rank(group), dist.get_world_size(group)
    x = model.embed(tokens)
    for blk in model.layers:
        x = _mamba_block_local(blk, x, cfg, group, idx)
    x = L.rms_norm(x, model.ln_f, cfg.norm_eps)
    last = all_gather(x[:, -1], group)[n - 1]              # [B, d]
    if cfg.tie_embeddings:
        return torch.einsum("bd,vd->bv", last, model.wte)
    return torch.einsum("bd,dv->bv", last, model.head)
