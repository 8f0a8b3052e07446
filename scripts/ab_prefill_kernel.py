"""Time the two prefill attention kernels of several checkouts in turn on
one card, and print one JSON line per run with the CUDA-event median of
15 calls (L2 evicted before each) of every case, SDPA's time on the same
inputs (``scaled_dot_product_attention``, GQA, causal or with a boolean
mask of the allowed pairs; over the gathered rows for the paged kernel),
a hash of every case's output bits (``<case>_bits``: two trees that give
the same bits give the same hash), each case's bounds and the card's
name and power limit.

Cases, at the shapes the serving paths give the kernels:
  qwen_f32 / qwen_bf16  ``ops.flash_attention``, Qwen2.5-7B heads: q
                        [8,544,28,128] over 544 rows, causal (the main
                        path's largest call, f32 since the recovery of a
                        bf16 model runs in f32; and in bf16);
  qwen_sel_f32          the recovery's selective call in round 2: q
                        [8,128,28,128] at 128 selected positions over 544
                        rows, f32 (``SEL_BLOCKS``: 4 blocks of 32 a
                        sequence, as round 2 of ``chip_smoke.py``'s main
                        path selects them);
  qwen_r0_bf16          the same heads at S 224 in bf16 (round 0's prefill);
  hymba_bf16 / _f32     Hymba-1.5B heads: q [8,544,25,64] over
                        [8,544,5,64], causal (the hybrid path's call);
  paged_f32 / _bf16     ``ops.flash_prefill_paged``, q [8,256,28,128]
                        over 7 pages of 32 and 32 tail rows a sequence
                        from a pool of 72 pages (the main path's round-2
                        history pool), causal.

Bounds (``<case>_bound``): bytes (each input read once, the output
written once) over 3.35 TB/s, and the two products over the allowed
pairs at the card's peak: bf16 at 989 TFLOP/s; f32 as three TF32
products a pair at 495 TFLOP/s (``tf32x3``, the f32 path's design) and,
beside it, plain f32 on the CUDA cores at 67 TFLOP/s (``f32``).

    python3 scripts/ab_prefill_kernel.py PARENT . . PARENT

Each argument is the root of a checkout with ``src/repro_torch``; each run
is a process of its own that builds that checkout's kernels. Give the
runs in turns (A B B A) so that drift of the card shows.
"""
from __future__ import annotations

import json
import subprocess
import sys

# the 32-token blocks that round 2's recovery selects on the main path of
# chip_smoke.py (8 agents, prompt 544, n_sel 128): the 7 distinct sets it
# printed on an H100 for the 8 sequences, the first taken twice
SEL_BLOCKS = [[8, 9, 10, 16], [8, 9, 10, 16], [8, 9, 11, 16], [8, 9, 14, 16],
              [8, 9, 15, 16], [8, 10, 11, 16], [8, 12, 13, 16],
              [9, 10, 13, 16]]

CODE = r"""
import hashlib, json, statistics, subprocess, sys, torch
import torch.nn.functional as F
sys.path.insert(0, 'src')
from repro_torch.kernels import ops
SEL_BLOCKS = %s
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
def bits(x):
    return hashlib.sha1(x.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()[:16]
def bounds(nbytes, pairs, H, hd, dt):
    ops_ = 4 * hd * H * pairs
    t_b = nbytes / 3.35e12 * 1e3
    if dt == torch.bfloat16:
        return {'bytes': t_b, 'bf16': ops_ / 989e12 * 1e3}
    return {'bytes': t_b, 'tf32x3': 3 * ops_ / 495e12 * 1e3,
            'f32': ops_ / 67e12 * 1e3}
def sdpa(q, k, v, mask=None):
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if mask is None:
        return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True,
                                                      enable_gqa=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                  attn_mask=mask[:, None],
                                                  enable_gqa=True)
g = torch.Generator(device=dev).manual_seed(0)
out = {}
dense = {'qwen_f32': (544, 544, 28, 4, 128, torch.float32),
         'qwen_sel_f32': (128, 544, 28, 4, 128, torch.float32),
         'qwen_bf16': (544, 544, 28, 4, 128, torch.bfloat16),
         'qwen_r0_bf16': (224, 224, 28, 4, 128, torch.bfloat16),
         'hymba_bf16': (544, 544, 25, 5, 64, torch.bfloat16),
         'hymba_f32': (544, 544, 25, 5, 64, torch.float32)}
for name, (Sq, S, H, KV, hd, dt) in dense.items():
    B = 8
    q = torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dt)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev).to(dt)
    if Sq == S:
        pos = torch.arange(S, device=dev, dtype=torch.int32).expand(B, S)
        mask = None
    else:
        blk = torch.tensor(SEL_BLOCKS, device=dev)
        pos = (blk[:, :, None] * 32 + torch.arange(32, device=dev)).reshape(
            B, Sq).clamp(max=S - 1)
        mask = pos[:, :, None] >= torch.arange(S, device=dev)
    pos = pos.to(torch.int32).contiguous()
    fn = lambda: ops.flash_attention(q, k, v, q_pos=pos, window=S)
    out[name] = timer(fn)
    out[name + '_bits'] = bits(fn())
    out[name + '_sdpa'] = timer(sdpa(q, k, v, mask))
    pairs = int((pos.long()[:, :, None] >= torch.arange(S, device=dev))
                .sum().item())
    n_bytes = 2 * q.numel() * q.element_size() + 2 * k.numel() * \
        k.element_size() + pos.numel() * 4
    out[name + '_bound'] = bounds(n_bytes, pairs, H, hd, dt)
B, P, bt, nbh, T, H, KV, hd = 8, 72, 32, 7, 32, 28, 4, 128
span = nbh * bt
S = span + T
pidx = torch.randperm(P, generator=g, device=dev)[: B * nbh].reshape(
    B, nbh).to(torch.int32).contiguous()
for dt in (torch.float32, torch.bfloat16):
    name = 'paged_' + ('f32' if dt == torch.float32 else 'bf16')
    pk = torch.randn(P, bt, KV, hd, generator=g, device=dev).to(dt)
    pv = torch.randn(P, bt, KV, hd, generator=g, device=dev).to(dt)
    tk = torch.randn(B, T, KV, hd, generator=g, device=dev).to(dt)
    tv = torch.randn(B, T, KV, hd, generator=g, device=dev).to(dt)
    q = torch.randn(B, S, H, hd, generator=g, device=dev).to(dt)
    fn = lambda: ops.flash_prefill_paged(q, pk, pv, pidx, tk, tv,
                                         span_len=span)
    out[name] = timer(fn)
    out[name + '_bits'] = bits(fn())
    kd = torch.cat([pk[pidx.long()].reshape(B, span, KV, hd), tk], 1)
    vd = torch.cat([pv[pidx.long()].reshape(B, span, KV, hd), tv], 1)
    out[name + '_sdpa'] = timer(sdpa(q, kd, vd))
    pages = torch.unique(pidx).numel()
    n_bytes = (2 * q.numel() + 2 * (pages * bt + B * T) * KV * hd) * \
        q.element_size() + pidx.numel() * 4
    out[name + '_bound'] = bounds(n_bytes, B * S * (S + 1) // 2, H, hd, dt)
out['card'] = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True).stdout.strip()
print(json.dumps(out))
""" % json.dumps(SEL_BLOCKS)


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
