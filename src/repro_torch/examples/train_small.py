"""Train a small dense model on the synthetic pipeline for a few hundred
steps, checkpointing at the end: the port's twin of
``examples/train_small.py``.

  PYTHONPATH=src python -m repro_torch.examples.train_small \\
      [--steps 200] [--arch qwen3-4b] [--device cpu]

Runs the smoke (reduced) configuration of the architecture in f32 with
random weights from seed 0. Without ``--device`` it runs on the CUDA
device, where attention's forward and backward go through the port's
kernels. The checkpoint is the JAX package's npz format: either package
loads it.
"""
import argparse
import os
import tempfile

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.training import (AdamWConfig, DataConfig, SyntheticTokens,
                                  train)
from repro_torch.training.checkpoint import save


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b", choices=list_archs())
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "repro_torch_ckpt"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    n_params = cfg.param_count()
    print(f"training {cfg.name}: {n_params/1e6:.1f}M params, "
          f"{args.steps} steps @ [{args.batch}x{args.seq_len}]")
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.batch, seed=0)
    opt = AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                      total_steps=args.steps)
    params = init_params(cfg, 0, device=dev)
    res = train(cfg, opt, iter(SyntheticTokens(dc)), args.steps,
                params=params, log_every=max(1, args.steps // 10),
                device=dev)
    print(f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
          f"in {res.wall_s:.0f}s ({res.steps/res.wall_s:.2f} steps/s)")
    save(args.out, res.params, {"arch": cfg.name, "steps": res.steps})
    print(f"checkpoint written to {args.out}.npz")


if __name__ == "__main__":
    main()
