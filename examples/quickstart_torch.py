"""Quickstart, PyTorch port: SP-MoE serving a (reduced) Mixtral with
speculative decoding and drafting-stage expert prefetching — the paper's
full pipeline, end to end, through the unified request API of
``repro_torch``.  Runs on the card (``--device cuda``, the default, which
raises without one) or on the CPU (``--device cpu``).  The one-for-one
counterpart of ``examples/quickstart.py``; it imports nothing of JAX.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.engine import Engine, EngineConfig, Request
from repro_torch.core.sd import greedy_generate
from repro_torch.models.registry import build_model


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--tokens", type=int, default=24)
    args = ap.parse_args(argv)
    n = args.tokens

    # reduced Mixtral-8x7B (same family: 8 experts, top-2, SWA) in f32
    cfg = get_config("mixtral-8x7b").reduced(dtype="float32")
    print(f"target: {cfg.name}  ({cfg.num_layers}L, {cfg.num_experts} "
          f"experts, top-{cfg.num_experts_per_tok}) on {args.device}")

    target = build_model(cfg, args.device, seed=0)
    gen = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)

    # reference: plain target-only greedy decoding
    t0 = time.perf_counter()
    ref = greedy_generate(target, prompt.to(target.device), n, 64).tolist()
    print(f"\ngreedy reference ({time.perf_counter() - t0:.1f}s): {ref}")

    # SP-MoE: decode axis = speculative decoding, offload axis = drafting-
    # stage prefetch into a fixed-slot LRU expert cache (the draft is
    # derived from the target and drawn from seed 1)
    config = EngineConfig(model=cfg, decode="sd", offload="spmoe",
                          cache_slots=8, draft_len=4, max_seq=64)
    with Engine(config, target) as eng:
        # stream the first request token by token (per committed block)
        t0 = time.perf_counter()
        print("SP-MoE stream:    ", end="", flush=True)
        for tok in eng.stream(Request(prompt=prompt, max_new_tokens=n)):
            print(tok, end=" ", flush=True)
        res = eng.last_result
        print(f" ({time.perf_counter() - t0:.1f}s)")
        print(f"\nlossless: {res.tokens == ref}")
        for k in ("hit_rate", "prefetched", "on_demand_loads",
                  "acceptance_rate", "cutoff_layer", "evictions"):
            print(f"  {k}: {res.metrics[k]}")
        # request 2 reuses the warm expert cache — hit rate climbs
        res2 = eng.submit(Request(prompt=prompt, max_new_tokens=n))
        print(f"request 2 (warm cache) hit_rate: {res2.metrics.hit_rate:.2%} "
              f"(request 1: {res.metrics.hit_rate:.2%})")

        # two sessions decoded concurrently on the same warm cache: each
        # scheduling round verifies the ready sessions' draft blocks in ONE
        # fused dispatch (one routing pass, one expert-FFN launch per MoE
        # layer, ≤2 host syncs per round instead of 2 per session), and
        # each stream stays bit-identical to serving it alone
        prompt2 = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)
        batch = eng.serve_all([Request(prompt=prompt, max_new_tokens=n),
                               Request(prompt=prompt2, max_new_tokens=n)],
                              concurrency=2)
        print(f"concurrent sessions lossless: {batch[0].tokens == ref} | "
              f"per-request hit_rate: "
              f"{[f'{r.metrics.hit_rate:.2%}' for r in batch]}")

    # chaos drill: the same engine config under seeded fault injection —
    # transient I/O errors, payload corruption (checksum-quarantined) and
    # prefetch-worker kills.  Retries + the supervised worker + the
    # graceful-degradation ladder absorb every injected fault; the stream
    # stays bit-identical, only slower.  (CLI: repro_torch.launch.serve
    # --chaos; counters: prefetch_errors / retries / checksum_failures /
    # worker_restarts / degraded_rounds / io_errors.)
    chaos_cfg = EngineConfig(model=cfg, decode="sd", offload="spmoe",
                             cache_slots=8, draft_len=4, max_seq=64,
                             chaos=ChaosConfig(seed=7, fetch_error_rate=0.2,
                                               corrupt_rate=0.1,
                                               kill_worker_every=5))
    with Engine(chaos_cfg, target) as eng:
        chaos_res = eng.submit(Request(prompt=prompt, max_new_tokens=n))
        c = eng.runtime.counters()
        print(f"chaos drill lossless: {chaos_res.tokens == ref} "
              f"(retries={c['prefetch_retries']} "
              f"checksum_failures={c['checksum_failures']} "
              f"worker_restarts={c['worker_restarts']} "
              f"health={eng.runtime.health()})")
    return {"reference": ref, "stream": res.tokens, "warm": res2.tokens,
            "concurrent": [r.tokens for r in batch],
            "chaos": chaos_res.tokens}


if __name__ == "__main__":
    main()
