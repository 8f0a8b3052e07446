"""Compare ways of forming the capped f32 prefill's scores S = Q K^T on one
card: error against the plain version and time.

The capped f32 instance of ``prefill::attend`` (``csrc/prefill_attn.cuh``)
forms each k-step's split-TF32 products in a fresh zero fragment and adds
that to the scores in f32 (``Tf32Op::scores<true>``). This script builds
the two prefill kernels once per variant, from a copy of ``csrc/`` whose
capped f32 instance forms the scores another way, and runs each variant
on the same inputs:

  fresh         the shipped code: lo*hi + hi*lo, then hi*hi, into a
                fresh fragment each k-step (three TF32 products);
  fresh_x4      the same with lo*lo first (four TF32 products);
  running       ``Tf32Op::scores<false>``, as the uncapped instance: every
                k-step's three products into the running score fragment;
  running_x4    the same with lo*lo first;
  fma           Q K^T by plain f32 FMAs on the CUDA cores, each lane its
                own four scores of a slice (the capped instance's product
                before the fresh fragment).

(``running_x4`` changes the uncapped f32 instance's product too; only
capped calls are made.)

Cases, every one f32 with a soft cap of 30:
  test_*     the prefill half of ``tests/test_torch_kernels.py::
             test_gpu_attention_kernels_capped`` with its seeds: hd
             64/128/256 x G 1/6/7/8 x unit-scale q (``c30``) and q x 300
             (``saturating``): ``flash_attention`` fresh (S 150) and at
             64 selected rows with a ragged ``kv_len``, and
             ``flash_prefill_paged`` (5 pages of 32 + 32 tail rows);
  grok_*     Grok-1's calls on ``chip_smoke.py``'s path: q [8,544,48,128]
             over [8,544,8,128], causal (fresh), and q [8,128,48,128] at
             round 2's selected rows (``SEL_BLOCKS``), unit scale;
  edge_paged the main path's pool shape, q [8,256,28,128] x 300 over 7
             pages of 32 + 32 tail rows from a pool of 72.

Each case is held to the card's f32 tolerance (atol 1e-4 + rtol 1e-4, as
``torch.testing.assert_close``); the Grok calls are timed (CUDA-event
median of 15, L2 evicted before each). Prints one JSON line per variant,
each with the ptxas report of its capped f32 entry points and the card's
name and power limit; writes nothing else.

    python3 scripts/probe_capped_scores.py
"""
from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import build, ops, ref  # noqa: E402

SEL_BLOCKS = [[8, 9, 10, 16], [8, 9, 10, 16], [8, 9, 11, 16], [8, 9, 14, 16],
              [8, 9, 15, 16], [8, 10, 11, 16], [8, 12, 13, 16],
              [9, 10, 13, 16]]

# the capped f32 instance's score product, as shipped
DISPATCH = "      op.template scores<true>(s, Ks, lane);\n"
# one score slice's products into the fresh fragment / the running one
FRESH = "          mma_3xtf32(t, ah, al, bh0, bh1, bl0, bl1);\n"
RUNNING = "          mma_3xtf32(s[j], ah, al, bh0, bh1, bl0, bl1);\n"
PV = ("  // acc += P V over this warp's kOut output columns (Vs points at the\n"
      "  // first). k-step kk")
FMA = """  __device__ __forceinline__ void scores_fma(float (&s)[kBK / 8][4],
                                             const T* Ks, int lane) const {
    const int g = lane >> 2, tg = lane & 3;
    const float* const q0 = qw + g * kPQ;
    const float* const q1 = q0 + 8 * kPQ;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float* const k0 = Ks + (8 * j + 2 * tg) * kPK;
      const float* const k1 = k0 + kPK;
      float a00 = 0.f, a01 = 0.f, a10 = 0.f, a11 = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; d += 4) {
        const float4 x0 = *reinterpret_cast<const float4*>(q0 + d);
        const float4 x1 = *reinterpret_cast<const float4*>(q1 + d);
        const float4 y0 = *reinterpret_cast<const float4*>(k0 + d);
        const float4 y1 = *reinterpret_cast<const float4*>(k1 + d);
        a00 = fmaf(x0.x, y0.x, a00); a00 = fmaf(x0.y, y0.y, a00);
        a00 = fmaf(x0.z, y0.z, a00); a00 = fmaf(x0.w, y0.w, a00);
        a01 = fmaf(x0.x, y1.x, a01); a01 = fmaf(x0.y, y1.y, a01);
        a01 = fmaf(x0.z, y1.z, a01); a01 = fmaf(x0.w, y1.w, a01);
        a10 = fmaf(x1.x, y0.x, a10); a10 = fmaf(x1.y, y0.y, a10);
        a10 = fmaf(x1.z, y0.z, a10); a10 = fmaf(x1.w, y0.w, a10);
        a11 = fmaf(x1.x, y1.x, a11); a11 = fmaf(x1.y, y1.y, a11);
        a11 = fmaf(x1.z, y1.z, a11); a11 = fmaf(x1.w, y1.w, a11);
      }
      s[j][0] += a00;
      s[j][1] += a01;
      s[j][2] += a10;
      s[j][3] += a11;
    }
  }

"""


def x4(line, frag):
    return line.replace("mma_3xtf32(" + frag + ", ah, al, bh0, bh1, bl0, bl1)",
                        "mma_tf32(" + frag + ", al, bl0, bl1)") + line


# each variant: (old, new) replacements in prefill_attn.cuh
VARIANTS = {
    "fresh": [],
    "fresh_x4": [(FRESH, x4(FRESH, "t"))],
    "running": [(DISPATCH, "      op.scores(s, Ks, lane);\n")],
    "running_x4": [(DISPATCH, "      op.scores(s, Ks, lane);\n"),
                   (RUNNING, x4(RUNNING, "s[j]"))],
    "fma": [(DISPATCH, "      op.scores_fma(s, Ks, lane);\n"),
            (PV, FMA + PV)],
}
SOURCES = ("flash_prefill", "flash_prefill_paged")
OUT = ROOT / "build" / "probe_capped_scores"


def make_copies():
    """One patched copy of ``csrc/`` per variant; returns their paths."""
    header = (build.CSRC / "prefill_attn.cuh").read_text()
    dirs = {}
    for name, edits in VARIANTS.items():
        d = OUT / name
        if d.exists():
            shutil.rmtree(d)
        shutil.copytree(build.CSRC, d)
        text = header
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        (d / "prefill_attn.cuh").write_text(text)
        dirs[name] = d
    return dirs


def compile_all(dirs):
    """One nvcc a source and variant, all started together; returns the
    libraries' paths and the ptxas lines of the capped f32 entry points."""
    procs = {}
    for name, d in dirs.items():
        for src in SOURCES:
            out = d / f"{src}.so"
            cmd = [build.nvcc(), *build.flags(), "-o", str(out),
                   str(d / f"{src}.cu")]
            procs[name, src] = (out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs, ptxas = {}, {}
    for (name, src), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}/{src}: nvcc rc {proc.returncode}\n"
                               f"{log[-4000:]}")
        libs[name, src] = out
        lines = log.splitlines()
        keep = []
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "capped" in line \
                    and "IfLi" in line:
                hd = line.split("IfLi")[1].split("E")[0]
                rep = " | ".join(x.split("ptxas info    :")[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "spill" in x or "Used" in x)
                keep.append(f"{src} hd {hd}: {rep}")
        ptxas[name, src] = keep
    return libs, ptxas


def use(name, libs):
    """Route the two prefill wrappers to one variant's libraries."""
    build._FNS.clear()
    for src in SOURCES:
        build._LIBS[src] = ctypes.CDLL(str(libs[name, src]))


def held(got, want):
    """(max abs err, worst share of the tolerance, within it)."""
    err = (got - want).abs()
    share = (err / (1e-4 + 1e-4 * want.abs())).max().item()
    return err.max().item(), share, share <= 1.0


def test_cases(dev):
    """The prefill calls of the capped gpu test, with its seeds, as
    (name, kernel call, plain call)."""
    cases = []
    for hd in (64, 128, 256):
        for G in (1, 6, 7, 8):
            for case in ("c30", "saturating"):
                KV, B, S, c = 2, 2, 150, 30.0
                H = G * KV
                g = torch.Generator(device=dev).manual_seed(hd * G + len(case))
                mult = 300.0 if case == "saturating" else 1.0

                def rnd(*shape, m=1.0, g=g):
                    return m * torch.randn(*shape, generator=g, device=dev)

                q, k, v = rnd(B, S, H, hd, m=mult), rnd(B, S, KV, hd), rnd(
                    B, S, KV, hd)
                full = torch.arange(S, device=dev, dtype=torch.int32).expand(
                    B, S).contiguous()
                sel = torch.sort(torch.randperm(S, generator=g, device=dev)[
                    :64]).values.to(torch.int32).expand(B, 64).contiguous()
                kl = torch.tensor([S, 100], device=dev, dtype=torch.int32)
                tag = f"test_{case}_hd{hd}_G{G}"
                for qq, qp, kv_len, what in ((q, full, None, "fresh"),
                                             (q[:, :64].contiguous(), sel, kl,
                                              "sel")):
                    kw = dict(q_pos=qp, window=S, kv_len=kv_len, softcap=c)
                    cases.append((
                        f"{tag}_{what}",
                        lambda qq=qq, kw=kw, k=k, v=v: ops.flash_attention(
                            qq, k, v, **kw),
                        lambda qq=qq, kw=kw, k=k, v=v: ref.flash_attention_ref(
                            qq, k, v, **kw)))
                nbh, bt, T = 5, 32, 32
                P = B * nbh + 3
                pk, pv = rnd(P, bt, KV, hd), rnd(P, bt, KV, hd)
                pidx = torch.randperm(P, generator=g, device=dev)[
                    :B * nbh].reshape(B, nbh).to(torch.int32)
                tk, tv = rnd(B, T, KV, hd), rnd(B, T, KV, hd)
                qp_ = rnd(B, nbh * bt + T, H, hd, m=mult)
                args = (qp_, pk, pv, pidx, tk, tv)
                cases.append((
                    f"{tag}_paged",
                    lambda args=args, s=nbh * bt: ops.flash_prefill_paged(
                        *args, span_len=s, softcap=30.0),
                    lambda args=args, s=nbh * bt: ref.flash_attention_paged_ref(
                        *args, span_len=s, softcap=30.0)))
    return cases


def path_cases(dev):
    """Grok-1's two f32 recovery calls and the saturating pool-shape edge,
    as (name, kernel call, plain call)."""
    g = torch.Generator(device=dev).manual_seed(23)
    B, S, H, KV, hd = 8, 544, 48, 8, 128
    q = torch.randn(B, S, H, hd, generator=g, device=dev)
    k = torch.randn(B, S, KV, hd, generator=g, device=dev)
    v = torch.randn(B, S, KV, hd, generator=g, device=dev)
    full = torch.arange(S, device=dev, dtype=torch.int32).expand(
        B, S).contiguous()
    blk = torch.tensor(SEL_BLOCKS, device=dev)
    sel = (blk[:, :, None] * 32 + torch.arange(32, device=dev)).reshape(
        B, 128).to(torch.int32).contiguous()
    qs = q[:, :128].contiguous()
    cases = [
        ("grok_fresh", lambda: ops.flash_attention(
            q, k, v, q_pos=full, window=S, softcap=30.0),
         lambda: ref.flash_attention_ref(q, k, v, q_pos=full, window=S,
                                         softcap=30.0)),
        ("grok_sel", lambda: ops.flash_attention(
            qs, k, v, q_pos=sel, window=S, softcap=30.0),
         lambda: ref.flash_attention_ref(qs, k, v, q_pos=sel, window=S,
                                         softcap=30.0))]
    P, bt, nbh, T, H, KV = 72, 32, 7, 32, 28, 4
    span = nbh * bt
    pk = torch.randn(P, bt, KV, hd, generator=g, device=dev)
    pv = torch.randn(P, bt, KV, hd, generator=g, device=dev)
    pidx = torch.randperm(P, generator=g, device=dev)[:B * nbh].reshape(
        B, nbh).to(torch.int32).contiguous()
    tk = torch.randn(B, T, KV, hd, generator=g, device=dev)
    tv = torch.randn(B, T, KV, hd, generator=g, device=dev)
    qp = 300.0 * torch.randn(B, span + T, H, hd, generator=g, device=dev)
    args = (qp, pk, pv, pidx, tk, tv)
    cases.append(("edge_paged", lambda: ops.flash_prefill_paged(
        *args, span_len=span, softcap=30.0),
        lambda: ref.flash_attention_paged_ref(*args, span_len=span,
                                              softcap=30.0)))
    return cases


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_capped_scores: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    t0 = time.perf_counter()
    libs, ptxas = compile_all(make_copies())
    print(f"[build] {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    flush = torch.empty(16 * 2 ** 20, device=dev)

    def timer(fn, reps=15):
        for _ in range(2):
            fn()
        pairs = []
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)

    cases = test_cases(dev) + path_cases(dev)
    plain = {name: want() for name, _, want in cases}
    for name in VARIANTS:
        use(name, libs)
        res = {"variant": name, "card": card,
               "ptxas": [x for src in SOURCES for x in ptxas[name, src]]}
        worst, failed = ("", 0.0), []
        for case, fn, _ in cases:
            got = fn()
            assert torch.equal(fn(), got), (name, case, "two calls differ")
            err, share, ok = held(got, plain[case])
            if share > worst[1]:
                worst = (case, share)
            if not ok:
                failed.append(f"{case} {err:.3g}")
            if not case.startswith("test_"):
                res[case + "_err"] = err
        res["worst"] = {"case": worst[0], "share_of_tolerance": worst[1]}
        res["failed"] = failed
        for case, fn, _ in cases:
            if case.startswith("grok_"):
                res[case + "_ms"] = timer(fn)
        print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
