"""Time the dense prefill attention kernel (``ops.flash_attention``) of
several checkouts in turn on one card, at the main path's largest call
(Qwen2.5-7B heads: q [8,544,28,128] over 544 rows, causal, f32) and at
the hybrid path's (Hymba-1.5B heads: q [8,544,25,64] over [8,544,5,64],
bf16), and print one JSON line per run with the CUDA-event median of 15
calls (L2 evicted before each) and the card's name and power limit.

    python3 scripts/ab_prefill_kernel.py PARENT . . PARENT

Each argument is the root of a checkout with ``src/repro_torch``; each run
is a process of its own that builds that checkout's kernel. Give the runs
in turns (A B B A) so that drift of the card shows.
"""
from __future__ import annotations

import json
import subprocess
import sys

CODE = r"""
import json, statistics, subprocess, sys, torch
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
g = torch.Generator(device=dev).manual_seed(0)
out = {}
for name, (H, KV, hd, dt) in {'qwen_f32': (28, 4, 128, torch.float32),
                              'hymba_bf16': (25, 5, 64, torch.bfloat16)}.items():
    B, S = 8, 544
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S).contiguous()
    out[name] = timer(lambda: ops.flash_attention(q, k, v, q_pos=pos, window=S))
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
