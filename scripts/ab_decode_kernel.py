"""Time the two decode attention kernels of several checkouts in turn on
one card, and print one JSON line per run with the CUDA-event median of
15 calls (L2 evicted before each, and the device held ~0.1 ms by a spin
so that the host has enqueued the call before its start event fires:
device time, not the wrapper's host time) of every case, the host time
of one call (``_host_us``: 200 calls enqueued back to back, without
waiting for the device), the same kernel time with L2 left warm
(``_warm``: the inputs and the kernel's code still cached from the last
call), the timer's floor (``noop``: a one-element add, ~5.6 us on an
H100), the host time split into its parts (``_host_busy_us``: the same
200 calls with the device held busy by a spin that outlasts them, so no
launch finds it idle; ``_launch_us`` / ``_launch_busy_us``: the C launch
function alone, called through ctypes with the arguments of one wrapper
call, device idle / busy; ``_stream_us``: the current-stream query
every wrapper makes; ``_split_us``: the decode wrappers' scratch and
ticket set-up, that query included, where the checkout has it), SDPA's
time on the same
inputs (``scaled_dot_product_attention`` with a boolean mask, GQA; over
the gathered rows for the paged kernel), a hash of every case's output
bits (``_bits``: two trees that give the same bits give the same hash)
and the card's name and power limit.

Cases, at the shapes the serving paths give the kernels (8 sequences at
the first decode step of round 2, 545 rows valid of 576):
  paged_bf16 / _f32   ``ops.flash_decode_paged``, Qwen2.5-7B heads: q
                      [8,28,128] over 18 pages of 32 a sequence from a
                      shuffled pool (the main path: bf16 in round 0, f32
                      from round 1 on);
  qwen_bf16 / _f32    ``ops.flash_decode``, q [8,28,128] over
                      [8,576,4,128] (the ``[dense]`` loop);
  hymba_bf16 / _f32   ``ops.flash_decode``, q [8,25,64] over
                      [8,576,5,64] (the ``[hybrid]`` path, bf16);
  gemma_bf16 / _f32   ``ops.flash_decode``, Gemma3-12B heads (16 over 8,
                      head dim 256), q [8,16,256] over [8,576,8,256];
  paged_gemma_bf16 / _f32  ``ops.flash_decode_paged`` at those heads over
                      18 pages of 32 a sequence (the Gemma3-12B path);
  smoke_bf16 / _f32, paged_smoke_bf16 / _f32  the two kernels at the
                      smoke Qwen2.5-7B's heads (8 over 2, head dim 32: the
                      CPU parity tests' layout), q [8,8,32] over
                      [8,576,2,32] and over 18 pages of 32.

    python3 scripts/ab_decode_kernel.py PARENT . . PARENT

Each argument is the root of a checkout with ``src/repro_torch``; each run
is a process of its own that builds that checkout's kernels. Give the
runs in turns (A B B A) so that drift of the card shows.
"""
from __future__ import annotations

import json
import subprocess
import sys

CODE = r"""
import hashlib, json, statistics, subprocess, sys, time, torch
import torch.nn.functional as F
sys.path.insert(0, 'src')
from repro_torch.kernels import ops
dev = torch.device('cuda')
flush = torch.empty(16 * 2 ** 20, device=dev)
SPIN = 200_000   # device cycles (~0.1 ms) that hide the host's enqueue
def timer(fn, reps=15, cold=True):
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        if cold:
            flush.zero_()
        torch.cuda._sleep(SPIN)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
def host_us(fn, n=200, busy=False):
    torch.cuda.synchronize()
    if busy:
        torch.cuda._sleep(50_000_000)   # ~25 ms: longer than the n calls
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6
def raw_launch(fn):
    # the C launch of one wrapper call, with its arguments, alone (the
    # scratch it writes stays in the caching allocator, unused meanwhile)
    from repro_torch.kernels.build import launcher
    got, orig = {}, ops._launch
    def spy(kernel, *args):
        got['fn'], got['args'] = launcher(kernel), args
        orig(kernel, *args)
    ops._launch = spy
    try:
        got['out'] = fn()
    finally:
        ops._launch = orig
    return lambda: got['fn'](*got['args'])
def host_parts(key, fn, q, n_tiles, KV):
    out[f'{key}_host_us'] = host_us(fn)
    out[f'{key}_host_busy_us'] = host_us(fn, busy=True)
    raw = raw_launch(fn)
    out[f'{key}_launch_us'] = host_us(raw)
    out[f'{key}_launch_busy_us'] = host_us(raw, busy=True)
    out[f'{key}_stream_us'] = host_us(lambda: ops._stream(q))
    if hasattr(ops, '_split_operands'):
        out[f'{key}_split_us'] = host_us(
            lambda: ops._split_operands(q, n_tiles, KV))
def bits(x):
    return hashlib.sha1(x.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()[:16]
def sdpa(q, k, v, kv_len):
    mask = (torch.arange(k.shape[1], device=dev)[None] < kv_len[:, None])
    q4, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    m4 = mask[:, None, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kt, vt, attn_mask=m4,
                                                  enable_gqa=True)
g = torch.Generator(device=dev).manual_seed(0)
B, Sk, L = 8, 576, 545
kv_len = torch.full((B,), L, device=dev, dtype=torch.int32)
out = {}
for name, (H, KV, hd) in {'qwen': (28, 4, 128), 'hymba': (25, 5, 64),
                          'gemma': (16, 8, 256),
                          'smoke': (8, 2, 32)}.items():
    for dt, tag in ((torch.bfloat16, 'bf16'), (torch.float32, 'f32')):
        q = torch.randn(B, H, hd, generator=g, device=dev).to(dt)
        k = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dt)
        v = torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dt)
        dense = lambda: ops.flash_decode(q, k, v, kv_len, Sk)
        out[f'{name}_{tag}'] = timer(dense)
        out[f'{name}_{tag}_bits'] = bits(dense())
        out[f'{name}_{tag}_warm'] = timer(dense, cold=False)
        host_parts(f'{name}_{tag}', dense, q, Sk // 32, KV)
        out[f'{name}_{tag}_sdpa'] = timer(sdpa(q, k, v, kv_len))
        if name == 'hymba':
            continue
        key = 'paged' if name == 'qwen' else f'paged_{name}'
        nbt, P = Sk // 32, B * Sk // 32 + 16
        pidx = torch.randperm(P, generator=g, device=dev)[: B * nbt].reshape(
            B, nbt).to(torch.int32).contiguous()
        pk = torch.randn(P, 32, KV, hd, generator=g, device=dev).to(dt)
        pv = torch.randn(P, 32, KV, hd, generator=g, device=dev).to(dt)
        paged = lambda: ops.flash_decode_paged(q, pk, pv, pidx, kv_len)
        out[f'{key}_{tag}'] = timer(paged)
        out[f'{key}_{tag}_bits'] = bits(paged())
        out[f'{key}_{tag}_warm'] = timer(paged, cold=False)
        host_parts(f'{key}_{tag}', paged, q, nbt, KV)
        kd = pk[pidx.long()].reshape(B, Sk, KV, hd)
        vd = pv[pidx.long()].reshape(B, Sk, KV, hd)
        out[f'{key}_{tag}_sdpa'] = timer(sdpa(q, kd, vd, kv_len))
one = torch.zeros(1, device=dev)
out['noop'] = timer(lambda: one.add_(1))      # the timer's floor
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
