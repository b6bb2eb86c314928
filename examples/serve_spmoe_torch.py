"""End-to-end serving driver, PyTorch port: compares the four offloading
policies (the paper's frameworks) on the same reduced MoE model and prompt
set through the unified request API of ``repro_torch`` (one Engine per
policy serving all requests against a warm expert cache), reporting
per-policy hit rate / prefetch / eviction stats and checking that every
policy emits the identical (lossless) token stream.  With
``--concurrency > 1`` the requests are decoded concurrently (one fused
verify round per scheduling round on the shared cache), and the
losslessness column must stay True.  Runs on the card (``--device cuda``,
the default, which raises without one) or on the CPU (``--device cpu``).
The one-for-one counterpart of ``examples/serve_spmoe.py``; it imports
nothing of JAX.

    PYTHONPATH=src python examples/serve_spmoe_torch.py [--arch deepseek-v2-lite-16b]
    PYTHONPATH=src python examples/serve_spmoe_torch.py --requests 3 --concurrency 3
    PYTHONPATH=src python examples/serve_spmoe_torch.py --device cpu
"""
import argparse

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.engine import (Engine, EngineConfig, OffloadPolicy,
                                     Request, derive_draft_config)
from repro_torch.core.sd import greedy_generate
from repro_torch.models.registry import build_model

OFFLOAD_POLICIES = [p.value for p in OffloadPolicy if p != OffloadPolicy.NONE]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--tokens", type=int, default=20)
    ap.add_argument("--requests", type=int, default=2)
    ap.add_argument("--cache-slots", type=int, default=8)
    ap.add_argument("--concurrency", type=int, default=1,
                    help="sessions decoded concurrently per engine "
                         "(fused rounds on the shared cache; 1 = serial)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced(dtype="float32")
    assert cfg.is_moe, "pick an MoE arch"
    dcfg = derive_draft_config(cfg)
    target = build_model(cfg, args.device, seed=0)
    draft = build_model(dcfg, args.device, seed=1)

    prompts = [torch.randint(0, cfg.vocab_size, (1, 8),
                             generator=torch.Generator().manual_seed(10 + i))
               for i in range(args.requests)]
    refs = [greedy_generate(target, p.to(target.device), args.tokens,
                            64).tolist() for p in prompts]

    print(f"{'policy':14s} {'lossless':9s} {'hit_rate':9s} {'prefetched':11s} "
          f"{'on_demand':10s} {'evict':6s} {'wall_s':7s}")
    lossless = {}
    for policy in OFFLOAD_POLICIES:
        config = EngineConfig(model=cfg, draft=dcfg, decode="sd",
                              offload=policy, cache_slots=args.cache_slots,
                              draft_len=4, max_seq=64)
        with Engine(config, target, draft) as eng:
            reqs = [Request(prompt=p, max_new_tokens=args.tokens)
                    for p in prompts]
            if args.concurrency > 1:
                results = eng.serve_all(reqs, concurrency=args.concurrency)
            else:
                results = [eng.submit(r) for r in reqs]
            ok = all(res.tokens == ref for res, ref in zip(results, refs))
            m = eng.metrics()    # cumulative across the request stream
        lossless[policy] = ok
        print(f"{policy:14s} {str(ok):9s} {m.hit_rate:9.2%} "
              f"{m.prefetched:<11d} {m.on_demand_loads:<10d} "
              f"{m.evictions:<6d} {m.wall_s:7.1f}")
    return lossless


if __name__ == "__main__":
    main()
