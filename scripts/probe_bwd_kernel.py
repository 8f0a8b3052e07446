"""Build the attention backward kernel alone and hold it on one card.

    python3 scripts/probe_bwd_kernel.py

Builds ``csrc/flash_prefill.cu`` and ``csrc/flash_prefill_bwd.cu`` (not
the other sources), then runs ``ops.flash_attention_bwd`` against
``ref.flash_attention_bwd_ref`` in f32 and bf16 at head dims 32 / 64 /
128 / 256 with G 1 / 2 / 8, binding windows, ragged ``kv_len`` and a soft
cap of 30, each call twice for the same bits, and times it (CUDA events,
mean of 3 calls after 2) at Qwen3-4B's training layer, q [1, 4096, 32,
128] and k/v [1, 4096, 8, 128], causal. A quick check of a change to the
kernel before ``chip_smoke.py``: under a minute on the card.
"""
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build as kb  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}
# (B, Sq, Sk, H, KV, hd, window, kv_len, softcap, timed)
CASES = [(2, 70, 70, 4, 2, 32, None, None, 0.0, False),
         (2, 100, 130, 8, 1, 64, 37, [130, 101], 0.0, False),
         (1, 90, 90, 8, 8, 128, None, None, 30.0, False),
         (2, 77, 77, 16, 2, 256, 40, [77, 60], 30.0, False),
         (1, 200, 200, 8, 8, 256, None, None, 0.0, False),
         (1, 4096, 4096, 32, 8, 128, None, None, 0.0, True)]


def case(dev, dt, B, Sq, Sk, H, KV, hd, window, kv_len, cap, timed):
    g = torch.Generator(device=dev).manual_seed(0)
    q, do = (torch.randn(B, Sq, H, hd, generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, Sk, KV, hd, generator=g, device=dev).to(dt)
            for _ in range(2))
    kw = dict(q_pos=(torch.arange(Sq, device=dev) + (Sk - Sq)).expand(B, Sq)
              .to(torch.int32).contiguous(), window=window or Sk,
              kv_len=None if kv_len is None else torch.tensor(
                  kv_len, dtype=torch.int32, device=dev), softcap=cap)
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
    line = (f"B{B} Sq{Sq} Sk{Sk} H{H} KV{KV} hd{hd} window {window} kv_len "
            f"{kv_len} softcap {cap} {dt}: max abs err dq {errs[0]:.3g} dk "
            f"{errs[1]:.3g} dv {errs[2]:.3g}, within tolerance and two calls "
            f"bit-equal: {ok}")
    if timed:
        for _ in range(2):
            ops.flash_attention_bwd(q, k, v, out, do, **kw)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(3):
            ops.flash_attention_bwd(q, k, v, out, do, **kw)
        e.record()
        torch.cuda.synchronize()
        line += f"; {s.elapsed_time(e) / 3:.3f} ms a call"
    print(line, flush=True)
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_bwd_kernel: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    kb.build_all(("flash_prefill", "flash_prefill_bwd"))
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in kb.BUILD_LOGS["flash_prefill_bwd"].splitlines():
        if "Used" in line or "spill" in line:
            print(line.strip())
    dev = torch.device("cuda")
    ok = all([case(dev, dt, *c) for dt in (torch.float32, torch.bfloat16)
              for c in CASES])
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
