"""Time the store-side kernels, ``block_diff`` and ``rope_align``, and the
two restore kernels of several checkouts in turn on one card, and print one JSON line per run
with the CUDA-event median of 15 calls of every case (L2 evicted before
each, and the device held ~0.1 ms by a spin so that the host has
enqueued the call before its start event fires: device time, not the
wrapper's host time), the host time of one call (``_host_us``: 200 calls
enqueued back to back, without waiting for the device), a hash of each
case's output bits on seeded inputs (``_bits``: two trees that give the
same bits give the same hash), each case's bytes bound (``_bound``:
every input read once and the output written once, over 3.35 TB/s), the
timer's floor (``noop``: a one-element add), the card's name and
power limit, and how the f32 ``rope_align`` rounds its two outputs
(``rope_fma_x1cos`` / ``rope_fma_x1sin``: the share of elements equal to
fma(x1, cos, -x2·sin) and to fma(x1, sin, x2·cos), against the other
contraction, fma(-x2, sin, x1·cos) and fma(x2, cos, x1·sin); cos and sin
are the kernel's own, read off a call on unit keys).

Cases, at the shapes the main path (Qwen2.5-7B, 8 agents) gives them:
  block_diff_f32 / _bf16     ``ops.block_diff`` over a family of 8
                             members [8,28,544,4,128] in K and in V,
                             Master 3, blocks of 32 (17 blocks; f32 from
                             round 1 on, bf16 in round 0);
  block_diff16_f32           the same with 16 members (more than one
                             chunk of members a thread);
  rope_align_f32 / _bf16     ``ops.rope_align`` of the shared blocks' keys
                             [28,544,4,128] by one delta row;
  rope_tail_f32 / _bf16      the decode tails' call, [8,28,32,4,128] by
                             one delta row a request (D = 8);
  restore_family_f32 / _bf16 ``fused_family_restore`` at the storage
                             walkthrough's family [7,28,33,32,4,128]
                             (Master [28,33,32,4,128], 4 changed blocks a
                             mirror, aligned frames), ONE launch;
  restore_mirror_f32 / _bf16 ``fused_diff_restore`` on the same family,
                             the 7 per-mirror launches summed.

    python3 scripts/ab_store_kernels.py PARENT . . PARENT

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
sys.path.insert(0, 'src')
from repro_torch.kernels import ops
dev = torch.device('cuda')
flush = torch.empty(16 * 2 ** 20, device=dev)
SPIN = 200_000   # device cycles (~0.1 ms) that hide the host's enqueue
HBM = 3.35e12    # bytes/s, H100 SXM data sheet
def timer(fn, reps=15):
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record(); fn(); e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)
def host_us(fn, n=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6
def bits(x):
    return hashlib.sha1(x.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes()).hexdigest()[:16]
def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)
def case(key, fn, n_bytes):
    out[key] = timer(fn)
    out[f'{key}_host_us'] = host_us(fn)
    out[f'{key}_bits'] = bits(fn())
    out[f'{key}_bound'] = n_bytes / HBM * 1e3
g = torch.Generator(device=dev).manual_seed(0)
out = {}
L, S, KV, hd, bt, theta = 28, 544, 4, 128, 32, 1e6
nb = -(-S // bt)
for N, tag in ((8, 'block_diff'), (16, 'block_diff16')):
    for dt in (torch.float32, torch.bfloat16):
        if N == 16 and dt == torch.bfloat16:
            continue
        ks = torch.randn(N, L, S, KV, hd, generator=g, device=dev).to(dt)
        vs = torch.randn(N, L, S, KV, hd, generator=g, device=dev).to(dt)
        ks[1], vs[1] = ks[3], vs[3]          # one member equal to the Master
        ks[2, :, :bt], vs[2, :, :bt] = ks[3, :, :bt], vs[3, :, :bt]
        name = f"{tag}_{'f32' if dt == torch.float32 else 'bf16'}"
        case(name, lambda: ops.block_diff(ks, vs, 3, bt),
             nbytes(ks, vs) + 4 * N * nb)
        del ks, vs
for dt in (torch.float32, torch.bfloat16):
    tag = 'f32' if dt == torch.float32 else 'bf16'
    k = torch.randn(L, S, KV, hd, generator=g, device=dev).to(dt)
    d = torch.randint(-600, 600, (S,), generator=g, device=dev,
                      dtype=torch.int32)
    case(f'rope_align_{tag}', lambda: ops.rope_align(k, d, theta),
         2 * nbytes(k) + nbytes(d))
    kt = torch.randn(8, L, 32, KV, hd, generator=g, device=dev).to(dt)
    dt8 = torch.randint(0, 600, (8, 32), generator=g, device=dev,
                        dtype=torch.int32)
    case(f'rope_tail_{tag}', lambda: ops.rope_align(kt, dt8, theta),
         2 * nbytes(kt) + nbytes(dt8))
# the restore kernels at the walkthrough's family (launches only: the
# maps are checked and uploaded once, by ops.restore_launcher)
import numpy as np
r = np.random.default_rng(0)
M, nbr, ndb = 7, 33, 4
slot = np.full((M, nbr), -1, np.int32)
for m in range(M):
    slot[m, r.choice(nbr, ndb, replace=False)] = np.arange(ndb)
pages = r.permutation(M * nbr).reshape(M, nbr).astype(np.int32)
delta = np.zeros((M, nbr, bt), np.int32)
for dt in (torch.float32, torch.bfloat16):
    tag = 'f32' if dt == torch.float32 else 'bf16'
    mk, mv = (torch.randn(L, nbr, bt, KV, hd, generator=g, device=dev).to(dt)
              for _ in range(2))
    dk, dv = (torch.randn(M, L, ndb, bt, KV, hd, generator=g,
                          device=dev).to(dt) for _ in range(2))
    pk = torch.zeros(L, M * nbr, bt, KV, hd, device=dev, dtype=dt)
    pv = torch.zeros_like(pk)
    fam = ops.restore_launcher('fused_family_restore', mk, mv, dk, dv, slot,
                               pages, delta, theta, pk, pv)
    per = [ops.restore_launcher(
        'fused_diff_restore', mk, mv, dk[m:m + 1], dv[m:m + 1],
        slot[m:m + 1], pages[m:m + 1], delta[m:m + 1], theta, pk, pv)
        for m in range(M)]
    blk = L * bt * KV * hd * mk.element_size()
    need = int((slot < 0).any(axis=0).sum()) + int((slot >= 0).sum())
    case(f'restore_family_{tag}', lambda: fam()[0],
         2 * blk * (need + M * nbr))
    case(f'restore_mirror_{tag}', lambda: [f() for f in per][-1][0],
         M * 2 * blk * 2 * nbr)
    del mk, mv, dk, dv, pk, pv, fam, per
# the f32 products' rounding, from the kernel's own cos and sin
k = torch.randn(L, S, KV, hd, generator=g, device=dev)
d = torch.randint(-600, 600, (S,), generator=g, device=dev, dtype=torch.int32)
h = hd // 2
unit = torch.zeros_like(k)
unit[..., :h] = 1
o = ops.rope_align(unit, d, theta).double()
cs, sn = o[..., :h], o[..., h:]
x1, x2 = k[..., :h].double(), k[..., h:].double()
r = ops.rope_align(k, d, theta).double()
f = lambda t: t.float().double()
for key, got, fused, other in (
        ('rope_fma_x1cos', r[..., :h], x1 * cs - f(x2 * sn),
         f(x1 * cs) - x2 * sn),
        ('rope_fma_x1sin', r[..., h:], x1 * sn + f(x2 * cs),
         x2 * cs + f(x1 * sn))):
    out[key] = (got == f(fused)).double().mean().item()
    out[key + '_other'] = (got == f(other)).double().mean().item()
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
