"""Serving launcher for the unified request-level API (core/engine.py) of the
PyTorch port.  It runs on the card (``--device cuda``, the default) and
raises without one; ``--device cpu`` runs it on the CPU.

Policy is two-axis: ``--decode`` picks how tokens are committed (greedy |
sd | sd-adaptive), ``--offload`` picks where expert weights live (none |
spmoe | adapmoe | moe-infinity | on-demand).  Any combination is valid and
lossless; offload policies require an MoE target, and the ssm / hybrid
targets (``--arch mamba2-780m``, ``--arch zamba2-7b``) decode greedy only,
their default: their mamba layers step one token at a time, so they cannot
verify a draft block.  A dense target (``--arch llama3.2-3b``,
``command-r-35b``, ``granite-20b`` or ``nemotron-4-340b``) serves with
``--offload none`` (its default) under ``--decode greedy`` or ``sd`` /
``sd-adaptive`` with the derived half-depth draft.  phi-3.5-moe
(``--arch phi-3.5-moe``) serves like mixtral with its MoE draft
phi-mini-moe, and deepseek-v2-lite-16b (``--arch deepseek-v2-lite-16b``:
MLA, a leading dense layer, shared experts) with its MoE self-draft; an MoE
draft keeps its experts on the device and runs them through the expert-FFN
kernel.  Every arch is served reduced.  The legacy single-axis
``--policy`` flag is kept as a deprecated alias (``sd-only`` ->
``--decode sd --offload none``, ``spmoe`` -> ``--decode sd --offload
spmoe``, ...).

One Engine serves all ``--requests`` requests, so request 2+ hits a warm
expert cache (watch ``hit_rate`` climb).  ``--concurrency N`` decodes up to
N requests at once on that one cache: each scheduling round verifies the
ready sessions' blocks together (one expert-FFN launch per MoE layer, ≤2
host syncs per round); 1, the default, serves them one after another.
``--stream`` prints ``request_id:token`` pairs as each verify block commits;
``--stop-token`` ends a request early on every decode x offload combination
identically.

Chaos hardening: ``--chaos`` turns on the seeded fault injector
(core/chaos.py) against the expert I/O plane — transient fetch/insert
errors, latency spikes, payload corruption, prefetch-worker kills — tuned
with the ``--chaos-*`` rates.  Serving stays lossless (retry +
checksum-quarantine + the graceful-degradation ladder absorb every injected
fault); the per-request report grows the resilience counters
(``prefetch_errors`` / ``prefetch_retries`` / ``checksum_failures`` /
``worker_restarts`` / ``degraded_rounds`` / ``io_errors``) and the footer
prints the engine's final health.  ``--deadline-s`` arms a per-request
wall-clock budget (``finish_reason="deadline"`` when it expires).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
        --decode sd --offload spmoe --tokens 32 --requests 2

    # the same on the CPU; four requests, two decoded concurrently
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --requests 4 --concurrency 2

    # mamba2-780m, reduced, greedy (its default decode), on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch mamba2-780m --decode greedy --tokens 8

    # phi-3.5-moe, reduced, sd x spmoe with its MoE draft, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch phi-3.5-moe --tokens 8 --cache-slots 12

    # deepseek-v2-lite-16b, reduced, sd x spmoe on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch deepseek-v2-lite-16b --tokens 8 --cache-slots 12

    # llama3.2-3b, reduced, sd x none with its derived half-depth draft
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \
        --decode sd --tokens 16

    # granite-20b (MQA, gelu FFN), reduced, greedy, on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch granite-20b --decode greedy --tokens 8
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs.registry import get_config, get_draft_config
from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.engine import (DECODE_POLICIES, OFFLOAD_POLICIES,
                                     Engine, EngineConfig, Request,
                                     derive_draft_config)

# legacy --policy values -> (decode, offload)
LEGACY_POLICY = {
    "greedy": ("greedy", "none"),
    "sd-only": ("sd", "none"),
    "sd-adaptive": ("sd-adaptive", "none"),
    "spmoe": ("sd", "spmoe"),
    "adapmoe": ("sd", "adapmoe"),
    "moe-infinity": ("sd", "moe-infinity"),
    "on-demand": ("sd", "on-demand"),
}


def reduced_pair(arch: str):
    """The reduced target and its draft, paired as the reference's launcher
    pairs them: the registered Table 1 draft, reduced (mixtral's dense
    draft, phi-3.5-moe's MoE phi-mini-moe, and deepseek-v2-lite-16b's MoE
    self-draft: the registered draft is the unreduced target, whose name
    differs from the reduced one's), or the derived one
    (``derive_draft_config``) where none is registered."""
    cfg = get_config(arch).reduced(dtype="float32")
    draft = get_draft_config(arch)
    if draft is not None and draft.name != cfg.name:
        dcfg = draft.reduced(dtype="float32")
    else:
        dcfg = derive_draft_config(cfg)
    return cfg, dcfg


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--decode", default=None, choices=DECODE_POLICIES,
                    help="token-commit policy (default: sd; greedy for an "
                         "ssm / hybrid arch)")
    ap.add_argument("--offload", default=None, choices=OFFLOAD_POLICIES,
                    help="expert-weight policy (default: spmoe for MoE)")
    ap.add_argument("--policy", default=None, choices=sorted(LEGACY_POLICY),
                    help="DEPRECATED single-axis alias for --decode/--offload")
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--requests", type=int, default=1)
    ap.add_argument("--concurrency", type=int, default=1,
                    help="requests decoded concurrently on the one warm "
                         "cache (1 = one after another); each round "
                         "verifies the ready sessions' blocks together")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--draft-len", type=int, default=4)
    ap.add_argument("--cache-slots", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--stop-token", type=int, action="append", default=None)
    ap.add_argument("--stream", action="store_true",
                    help="print tokens as verify blocks commit")
    ap.add_argument("--deadline-s", type=float, default=None,
                    help="per-request wall-clock budget; an expired request "
                         "retires with finish_reason=deadline")
    chz = ap.add_argument_group(
        "chaos", "seeded fault injection against the expert I/O plane "
                 "(lossless by construction: retries, checksum quarantine "
                 "and the degradation ladder absorb every injected fault)")
    chz.add_argument("--chaos", action="store_true",
                     help="enable the fault injector (core/chaos.py)")
    chz.add_argument("--chaos-seed", type=int, default=0)
    chz.add_argument("--chaos-fetch-error-rate", type=float, default=0.1,
                     help="P(transient error) per HostExpertStore.fetch")
    chz.add_argument("--chaos-insert-error-rate", type=float, default=0.0,
                     help="P(transient error) per ExpertCache.insert")
    chz.add_argument("--chaos-spike-rate", type=float, default=0.0,
                     help="P(latency spike) per fetch")
    chz.add_argument("--chaos-spike-ms", type=float, default=10.0,
                     help="latency-spike duration (milliseconds)")
    chz.add_argument("--chaos-corrupt-rate", type=float, default=0.0,
                     help="P(staged-payload byte flip) per fetch — caught "
                          "by checksum verification, never inserted")
    chz.add_argument("--chaos-kill-every", type=int, default=0,
                     help="kill the prefetch worker every Nth task "
                          "(0 = never); the supervisor restarts it")
    args = ap.parse_args()

    decode, offload = args.decode, args.offload
    if args.policy is not None:
        if decode or offload:
            ap.error("--policy is an alias; don't mix with --decode/--offload")
        decode, offload = LEGACY_POLICY[args.policy]
        print(f"# --policy {args.policy} is deprecated; use "
              f"--decode {decode} --offload {offload}")
    cfg, dcfg = reduced_pair(args.arch)
    if decode is None:
        decode = "greedy" if cfg.family in ("ssm", "hybrid") else "sd"
    if offload is None:
        offload = "spmoe" if cfg.is_moe else "none"

    chaos = None
    if args.chaos:
        chaos = ChaosConfig(
            seed=args.chaos_seed,
            fetch_error_rate=args.chaos_fetch_error_rate,
            insert_error_rate=args.chaos_insert_error_rate,
            spike_rate=args.chaos_spike_rate,
            spike_s=args.chaos_spike_ms / 1e3,
            corrupt_rate=args.chaos_corrupt_rate,
            kill_worker_every=args.chaos_kill_every)
    max_seq = args.prompt_len + args.tokens + max(args.draft_len, 8) + 8
    config = EngineConfig(model=cfg, draft=dcfg, decode=decode,
                          offload=offload, cache_slots=args.cache_slots,
                          draft_len=args.draft_len, max_seq=max_seq,
                          chaos=chaos)
    prompts = [torch.randint(0, cfg.vocab_size, (1, args.prompt_len),
                             generator=torch.Generator().manual_seed(2 + i))
               for i in range(args.requests)]
    reqs = [Request(prompt=prompt, max_new_tokens=args.tokens,
                    stop_tokens=args.stop_token or (),
                    deadline_s=args.deadline_s,
                    request_id=f"req-{i}")
            for i, prompt in enumerate(prompts)]

    def report(res):
        print(f"[{res.request_id}] finish={res.finish_reason}")
        for k, v in sorted(res.metrics.as_dict().items()):
            print(f"    {k}: {v}")

    with Engine(config, device=args.device) as eng:
        if args.stream:
            for rid, tok in eng.serve(reqs, concurrency=args.concurrency):
                print(f"{rid}:{tok}", end=" ", flush=True)
            print()
            results = eng.last_batch
        else:
            results = eng.serve_all(reqs, concurrency=args.concurrency)
        for res in results:
            if not args.stream:
                print(f"[{res.request_id}] tokens: {res.tokens}")
            report(res)
        cum = eng.metrics()
        print(f"cumulative: requests={cum.requests} tokens={cum.tokens} "
              f"hit_rate={cum.hit_rate:.3f} tpot={cum.tpot_wall * 1e3:.1f}ms")
        if eng.runtime is not None:
            # runtime counters, not the Metrics ledger: worker-thread
            # increments landing between turn windows still show up here
            c = eng.runtime.counters()
            print(f"health: {eng.runtime.health()} "
                  f"(prefetch_errors={c['prefetch_errors']} "
                  f"retries={c['prefetch_retries']} "
                  f"checksum_failures={c['checksum_failures']} "
                  f"worker_restarts={c['worker_restarts']} "
                  f"degraded_rounds={c['degraded_rounds']} "
                  f"io_errors={c['io_errors']})")
            if args.chaos and eng.runtime.chaos is not None:
                inj = eng.runtime.chaos.injected
                print("chaos injected:", " ".join(
                    f"{k}={v}" for k, v in sorted(inj.items())))


if __name__ == "__main__":
    main()
