"""Train a small MoE LM with the full substrate, PyTorch port: synthetic
data pipeline, AdamW + cosine schedule, per-layer remat, microbatching,
async checkpointing, and a mid-run simulated failure + restart from the
latest checkpoint (the fault-tolerance path).  Runs on the card
(``--device cuda``, the default, which raises without one) or on the CPU
(``--device cpu``).  The one-for-one counterpart of
``examples/train_lm.py``; it imports nothing of JAX.

    PYTHONPATH=src python examples/train_lm_torch.py [--steps 200] [--big]
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu

``--big`` uses a ~100M-param config (slow on the CPU: ~seconds/step).
``main(argv)`` returns the step it failed at, the checkpoint it resumed
from and the losses of the resumed run.
"""
import argparse
import tempfile
import time

from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch.train import Trainer
from repro_torch.models.costmodel import count_params


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--big", action="store_true",
                    help="~100M params instead of the tiny default")
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a failure at this step to demo restart")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    if args.big:   # ~100M: 8L x 512d x 8 experts(256 ffn) top-2
        cfg = get_config("mixtral-8x7b").reduced(
            num_layers=8, d_model=512, num_heads=8, num_kv_heads=4,
            head_dim=64, moe_d_ff=1024, d_ff=1024, vocab_size=32000,
            num_experts=8, num_experts_per_tok=2, sliding_window=None)
        shape = ShapeConfig("ex", 256, 8, "train")
    else:
        cfg = get_config("mixtral-8x7b").reduced(sliding_window=None)
        shape = ShapeConfig("ex", 64, 8, "train")
    total, active = count_params(cfg)
    print(f"model: {total/1e6:.1f}M params ({active/1e6:.1f}M active/token) "
          f"on {args.device}")

    run = RunConfig(microbatch=2, learning_rate=1e-3, warmup_steps=20,
                    total_steps=args.steps)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tr = Trainer(cfg, shape, run, device=args.device, ckpt_dir=ckpt_dir)
        t0 = time.time()
        fail_at = args.fail_at if args.fail_at else args.steps // 2
        resumed = None
        try:
            _, losses = tr.train(args.steps, ckpt_every=25, fail_at=fail_at,
                                 log_every=20)
        except RuntimeError as e:
            resumed = tr.ckpt.latest_step()
            print(f"!! {e} — restarting from checkpoint step {resumed}")
            tr2 = Trainer(cfg, shape, run, device=args.device,
                          ckpt_dir=ckpt_dir)
            _, losses = tr2.train(args.steps, ckpt_every=25, log_every=20)
            print(f"recovered; final loss {losses[-1]:.4f} "
                  f"({time.time()-t0:.0f}s total)")
    return {"failed_at": fail_at if resumed is not None else None,
            "resumed_from": resumed, "losses": losses}


if __name__ == "__main__":
    main()
