"""Time the two prefill attention kernels of several checkouts in turn on
one card, and print one JSON line per run with the CUDA-event median of
15 calls (L2 evicted before each) of every case, SDPA's time on the same
inputs (``scaled_dot_product_attention``, causal, GQA; over the gathered
rows for the paged kernel) and the card's name and power limit.

Cases, at the shapes the serving paths give the kernels:
  qwen_f32 / qwen_bf16  ``ops.flash_attention``, Qwen2.5-7B heads: q
                        [8,544,28,128] over 544 rows, causal (the main
                        path's largest call, f32 since the recovery of a
                        bf16 model runs in f32; and in bf16);
  qwen_r0_bf16          the same at S 224 in bf16 (round 0's prefill);
  hymba_bf16 / _f32     Hymba-1.5B heads: q [8,544,25,64] over
                        [8,544,5,64], causal (the hybrid path's call);
  paged_f32 / _bf16     ``ops.flash_prefill_paged``, q [8,256,28,128]
                        over 7 pages of 32 and 32 tail rows a sequence
                        from a pool of 72 pages (the main path's round-2
                        history pool), causal.

    python3 scripts/ab_prefill_kernel.py PARENT . . PARENT

Each argument is the root of a checkout with ``src/repro_torch``; each run
is a process of its own that builds that checkout's kernels. Give the
runs in turns (A B B A) so that drift of the card shows.
"""
from __future__ import annotations

import json
import subprocess
import sys

CODE = r"""
import json, statistics, subprocess, sys, torch
import torch.nn.functional as F
sys.path.insert(0, 'src')
from repro_torch.kernels import ops
dev = torch.device('cuda')
flush = torch.empty(16 * 2 ** 20, device=dev)
def timer(fn, reps=15):
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
def sdpa(q, k, v):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)
g = torch.Generator(device=dev).manual_seed(0)
out = {}
dense = {'qwen_f32': (544, 28, 4, 128, torch.float32),
         'qwen_bf16': (544, 28, 4, 128, torch.bfloat16),
         'qwen_r0_bf16': (224, 28, 4, 128, torch.bfloat16),
         'hymba_bf16': (544, 25, 5, 64, torch.bfloat16),
         'hymba_f32': (544, 25, 5, 64, torch.float32)}
for name, (S, H, KV, hd, dt) in dense.items():
    B = 8
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    out[name] = timer(lambda: ops.flash_attention(q, k, v, q_pos=pos, window=S))
    out[name + '_sdpa'] = timer(sdpa(q, k, v))
B, P, bt, nbh, T, H, KV, hd = 8, 72, 32, 7, 32, 28, 4, 128
span = nbh * bt
pidx = torch.randperm(P, generator=g, device=dev)[: B * nbh].reshape(
    B, nbh).to(torch.int32).contiguous()
for dt in (torch.float32, torch.bfloat16):
    name = 'paged_' + ('f32' if dt == torch.float32 else 'bf16')
    pk = torch.randn(P, bt, KV, hd, generator=g, device=dev).to(dt)
    pv = torch.randn(P, bt, KV, hd, generator=g, device=dev).to(dt)
    tk = torch.randn(B, T, KV, hd, generator=g, device=dev).to(dt)
    tv = torch.randn(B, T, KV, hd, generator=g, device=dev).to(dt)
    q = torch.randn(B, span + T, H, hd, generator=g, device=dev).to(dt)
    out[name] = timer(lambda: ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv,
                                                      span_len=span))
    kd = torch.cat([pk[pidx.long()].reshape(B, span, KV, hd), tk], 1)
    vd = torch.cat([pv[pidx.long()].reshape(B, span, KV, hd), tv], 1)
    out[name + '_sdpa'] = timer(sdpa(q, kd, vd))
out['card'] = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip()
print(json.dumps(out))
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: rc {out.returncode}\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return {"root": root, **json.loads(out.stdout.strip().splitlines()[-1])}


def main() -> int:
    for root in sys.argv[1:]:
        print(json.dumps(run(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
