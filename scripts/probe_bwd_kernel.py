"""Build the attention backward kernel alone and hold it on one card.

    python3 scripts/probe_bwd_kernel.py
    python3 scripts/probe_bwd_kernel.py --ab PARENT . . PARENT

Without ``--ab``: builds ``csrc/flash_prefill.cu`` and the backward's
sources (``csrc/flash_prefill_bwd.cu`` and, where the checkout splits its
f32 instances out, ``csrc/flash_prefill_bwd_f32.cu``; not the other
sources) and prints the
registers, spill stores and loads, and shared memory ptxas gives each
instance of ``dq_kernel`` and ``dkv_kernel`` (element type, head dim,
capped or not). Then runs ``ops.flash_attention_bwd`` against
``ref.flash_attention_bwd_ref`` in f32 and bf16 at head dims 32 / 64 /
80 / 96 / 112 / 128 / 256 with G 1 / 2 / 4 / 8, binding windows, ragged
``kv_len`` and a soft cap of 30, each call twice for the same bits, and
at Qwen3-4B's training layer, q [1, 4096, 32, 128] and k/v [1, 4096, 8,
128], causal, times it: the whole call (CUDA events, median of 7 calls
with the L2 cache evicted before each), each of its two kernels alone
(device time from ``torch.profiler``, mean of 5 calls), the achieved rate
of the whole call against its bound (five products a pair over the causal
pairs, 2.5 x the forward's, at 989 TFLOP/s in bf16 and, in f32, three
TF32 products at 495) and SDPA's backward on the same inputs. A quick
check of a change to the kernel before ``chip_smoke.py``: a few minutes
on the card.

With ``--ab``: each argument is the root of a checkout with
``src/repro_torch``; each runs as a process of its own that builds that
checkout's two prefill sources and prints one JSON line with the backward's
CUDA-event time at the training shape in bf16 and f32, a hash of the bits
of its three outputs, and (where the run built the kernel, not the
earlier run of the same checkout) the most registers an instance takes
and the instances that spill. Give the runs in turns (A B B A) so that drift
of the card shows.
"""
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}
# (B, Sq, Sk, H, KV, hd, window, kv_len, softcap)
CASES = [(2, 70, 70, 4, 2, 32, None, None, 0.0),
         (2, 100, 130, 8, 1, 64, 37, [130, 101], 0.0),
         (1, 90, 90, 8, 8, 128, None, None, 30.0),
         (2, 77, 77, 16, 2, 256, 40, [77, 60], 30.0),
         (1, 200, 200, 8, 8, 256, None, None, 0.0),
         (1, 1024, 1024, 16, 4, 128, None, None, 0.0),
         # head dims 80 / 96 / 112: f32 splits the output columns over two
         # warps in 40 / 48 / 56 columns (a last half step at 80 and 112)
         (2, 141, 141, 4, 4, 80, None, None, 0.0),
         (2, 100, 130, 8, 2, 80, 37, [130, 101], 30.0),
         (1, 141, 141, 8, 8, 96, None, None, 30.0),
         (2, 200, 200, 8, 2, 96, 70, [200, 151], 0.0),
         (2, 141, 141, 8, 2, 112, None, None, 0.0),
         (2, 100, 130, 4, 4, 112, 37, [130, 101], 30.0),
         (1, 1024, 1024, 16, 4, 112, None, None, 30.0)]
TRAIN = (1, 4096, 4096, 32, 8, 128)      # B, Sq, Sk, H, KV, hd: Qwen3-4B


def sources(kb) -> tuple:
    """The sources this script builds in a checkout: the dense prefill
    and the backward's (one, or one an element type)."""
    return tuple(s for s in kb.SOURCES
                 if s == "flash_prefill" or s.startswith("flash_prefill_bwd"))


def logs(kb) -> str:
    """The ptxas reports of the backward's sources, joined."""
    return "\n".join(kb.BUILD_LOGS[s] for s in sources(kb)
                     if s != "flash_prefill")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def instances(log: str) -> list:
    """(kernel, type, head dim, capped, dkv_kernel's outputs, registers,
    spill stores, spill loads, static shared memory bytes) of every kernel
    instance in a ptxas log."""
    rows, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(dkv_kernel|dq_kernel)I(13__nv_bfloat16|f)"
                          r"Li(\d+)ELb([01])E(?:Li(\d)E)?", m.group(1))
            cur = None if k is None else {
                "kernel": k.group(1),
                "type": "bf16" if k.group(2) != "f" else "f32",
                "hd": int(k.group(3)), "capped": k.group(4) == "1"}
            if k is not None and k.group(5):   # dkv_kernel's outputs
                cur["outputs"] = {"1": "dV", "2": "dK", "3": "dK, dV"}[
                    k.group(5)]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
            rows.append(cur)
            cur = None
    return rows


def inputs(dev, dt, B, Sq, Sk, H, KV, hd, window=None, kv_len=None,
           cap=0.0, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dt)
            for _ in range(2))
    kw = dict(q_pos=(torch.arange(Sq, device=dev) + (Sk - Sq)).expand(B, Sq)
              .to(torch.int32).contiguous(), window=window or Sk,
              kv_len=None if kv_len is None else torch.tensor(
                  kv_len, dtype=torch.int32, device=dev), softcap=cap)
    return q, k, v, do, kw


def case(dev, dt, B, Sq, Sk, H, KV, hd, window, kv_len, cap):
    from repro_torch.kernels import ops, ref

    q, k, v, do, kw = inputs(dev, dt, B, Sq, Sk, H, KV, hd, window, kv_len,
                             cap)
    out = ops.flash_attention(q, k, v, **kw)
    got = ops.flash_attention_bwd(q, k, v, out, do, **kw)
    same = all(torch.equal(a, b) for a, b in
               zip(got, ops.flash_attention_bwd(q, k, v, out, do, **kw)))
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, **kw)
    atol, rtol = TOL[dt]
    errs, ok = [], same
    for a, b in zip(got, want):
        e = (a.float() - b.float()).abs()
        errs.append(e.max().item())
        ok &= bool((e <= atol + rtol * b.float().abs()).all())
    print(f"B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} window {window} kv_len "
          f"{kv_len} softcap {cap} {dt}: max abs err dq {errs[0]:.3g} dk "
          f"{errs[1]:.3g} dv {errs[2]:.3g}; two calls bit-equal {same}; "
          f"held {ok}", flush=True)
    return ok


def timed(fn, flush, reps=7):
    """CUDA-event median of reps calls, the L2 cache evicted before each."""
    for _ in range(2):
        fn()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def kernel_ms(fn, n=5):
    """Mean device time a call of each of the backward's two kernels
    (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {"dq_kernel": 0.0, "dkv_kernel": 0.0}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for name in out:
            if name in e.name:
                out[name] += (e.time_range.end - e.time_range.start) / 1e3
    return {k: v / n for k, v in out.items()}


def train_shape(dev, dt, flush):
    from repro_torch.kernels import ops

    B, Sq, Sk, H, KV, hd = TRAIN
    q, k, v, do, kw = inputs(dev, dt, B, Sq, Sk, H, KV, hd, seed=24)
    out = ops.flash_attention(q, k, v, **kw)
    fn = lambda: ops.flash_attention_bwd(q, k, v, out, do, **kw)  # noqa: E731
    ms = timed(fn, flush)
    split = kernel_ms(fn)
    pairs = H * Sq * (Sq + 1) // 2
    flops = 2.5 * 4 * hd * pairs
    peak = 989e12 if dt == torch.bfloat16 else 495e12 / 3
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))

    def sdpa_fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=True)

    def sdpa_both():
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                           enable_gqa=True)
        return torch.autograd.grad(o, (qt, kt, vt), do.transpose(1, 2))

    sdpa = timed(sdpa_both, flush) - timed(sdpa_fwd, flush)
    bits = hashlib.sha1(b"".join(x.contiguous().view(torch.uint8).cpu()
                                 .numpy().tobytes() for x in fn())) \
        .hexdigest()[:16]
    return {"ms": ms, **{f"{k}_ms": v for k, v in split.items()},
            "tflops": flops / ms / 1e9, "bound_ms": flops / peak * 1e3,
            "sdpa_bwd_ms": sdpa, "bits": bits}


def ab_run(root: str) -> dict:
    """One checkout's backward at the training shape, in a process of its
    own (this script's functions, that checkout's kernels)."""
    code = ("import json, sys; "
            f"sys.path[:0] = ['src', {str(ROOT / 'scripts')!r}]; "
            "import torch, probe_bwd_kernel as p; "
            "from repro_torch.kernels import build as kb; "
            "kb.build_all(p.sources(kb)); "
            "dev = torch.device('cuda'); "
            "flush = torch.empty(16 * 2 ** 20, device=dev); "
            "out = {str(dt).split('.')[-1]: p.train_shape(dev, dt, flush) "
            "for dt in (torch.bfloat16, torch.float32)}; "
            "rows = p.instances(p.logs(kb)); "
            "out.update(rows and {"
            "'max_registers': max(r['registers'] for r in rows), "
            "'spilled': [r for r in rows if r['spill_stores']]}); "
            "print(json.dumps(out))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=1200)
    if out.returncode != 0:
        raise RuntimeError(f"{root}: rc {out.returncode}\n"
                           f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    return {"root": root, **json.loads(out.stdout.strip().splitlines()[-1])}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bwd_kernel: no CUDA device", file=sys.stderr)
        return 2
    print(card(), flush=True)
    if sys.argv[1:2] == ["--ab"]:
        for root in sys.argv[2:]:
            print(json.dumps(ab_run(root)), flush=True)
        return 0
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build as kb

    t0 = time.perf_counter()
    kb.build_all(sources(kb))
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for r in instances(logs(kb)):
        print(json.dumps(r))
    dev = torch.device("cuda")
    ok = all([case(dev, dt, *c) for dt in (torch.float32, torch.bfloat16)
              for c in CASES])
    flush = torch.empty(16 * 2 ** 20, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        print(f"train shape {list(TRAIN)} causal {dt}: "
              f"{json.dumps(train_shape(dev, dt, flush))}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
