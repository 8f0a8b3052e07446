"""Quickstart: build a small model, serve a batch of prompts (prefill +
greedy decode over the dense cache), and show the selectable
architecture configs.

  PYTHONPATH=src python -m repro_torch.examples.quickstart \\
      [--arch hymba-1.5b] [--device cpu]

Runs the smoke (reduced) configuration of the architecture in f32, with
random weights from seed 0 and prompt tokens from a numpy seed. Without
``--device`` it runs on the CUDA device, where attention goes through
the port's prefill and dense decode kernels.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke_config, list_archs
from repro_torch.models import decode_step, init_params, prefill
from repro_torch.models.transformer import resolve_device


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-7b", choices=list_archs())
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch).replace(dtype="float32")
    print(f"arch={cfg.name} ({cfg.arch_type}) layers={cfg.n_layers} "
          f"d_model={cfg.d_model} vocab={cfg.vocab_size} device={dev}")
    params = init_params(cfg, 0, device=dev)

    toks = torch.as_tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), dtype=np.int64),
        device=dev)
    t0 = time.time()
    logits, cache = prefill(params, cfg, toks,
                            max_len=args.prompt_len + args.gen)
    sync(dev)
    print(f"prefill [{args.batch}x{args.prompt_len}]: {time.time()-t0:.2f}s")

    tok = logits[:, -1].argmax(dim=-1).to(torch.int32)
    outs = [tok]
    t0 = time.time()
    for _ in range(args.gen - 1):
        lg, cache = decode_step(params, cfg, tok, cache)
        tok = lg.argmax(dim=-1).to(torch.int32)
        outs.append(tok)
    sync(dev)
    dt = time.time() - t0
    print(f"decode {args.gen} tokens: {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s)")
    gen = torch.stack(outs, dim=1).cpu()
    for b in range(args.batch):
        print(f"  req{b}: {gen[b].tolist()}")


if __name__ == "__main__":
    main()
