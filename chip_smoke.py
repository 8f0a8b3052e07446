"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. the card (``nvidia-smi`` name and power limit, torch's device name);
  2. the build of the four CUDA kernels from ``src/repro_torch/kernels/csrc``
     (one ``nvcc`` per source, all at once), with ptxas' registers, shared
     memory and spills;
  3. the main path: Qwen2.5-7B at full width (28 layers, bf16, random
     weights from seed 0) served by ``ServingEngine`` +
     ``TokenDancePolicy(incremental=False)`` on the 8-agent, 3-round
     ``agent_society`` trace. Kernel launch counts are zeroed just before
     and read just after; every kernel must have launched and no plain
     version may have run. Inputs of each kernel's largest call are kept;
  4. each kernel against its plain PyTorch version on those main-path
     inputs (bf16, and cast to f32) and on edge cases, with CUDA-event
     times of kernel, plain version and one PyTorch library call;
  5. the f32 smoke configuration served on the card against the same
     engine on the CPU: greedy tokens equal, logits within atol 1e-3.
The line before the last is the kernel table as JSON; the last line is
the result as JSON.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM, data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,           # dense tensor-core bf16
              torch.float32: 67e12}             # f32 outside tensor cores
REPLACES = {
    "rope_align": "src/repro/kernels/rope_align.py:47",
    "block_diff": "src/repro/kernels/block_diff.py:43",
    "flash_prefill": "src/repro/kernels/flash_prefill.py:130",
    "flash_decode_paged": "src/repro/kernels/flash_decode.py:231",
}
SOURCES = {k: f"src/repro_torch/kernels/csrc/{k}.cu" for k in REPLACES}
# kernel vs plain version on the same inputs: f32 results differ by
# summation order / FMA contraction; bf16 results by one or two bf16 ulps
# of rounding the same f32 value
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1.6e-2)}


def say(*a):
    print(*a, flush=True)


# ------------------------------------------------------------ measurement
class Timer:
    """Median CUDA-event time of one call, with the L2 cache evicted
    before every timed call (64 MB written; the card's L2 is 50 MB)."""

    def __init__(self, dev):
        self.flush = torch.empty(16 * 2 ** 20, dtype=torch.float32,
                                 device=dev)

    def __call__(self, fn, reps=15, warm=2):
        for _ in range(warm):
            fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in pairs)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bound(n_bytes, flops, dtype):
    t_b = n_bytes / HBM_BYTES_PER_S
    t_f = flops / PEAK_FLOPS[dtype]
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def check(name, got, want, dtype):
    atol, rtol = TOL[dtype] if name != "block_diff" else (0.0, 0.0)
    err = (got.float() - want.float()).abs()
    ok = bool((err <= atol + rtol * want.float().abs()).all())
    if not ok or not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name} ({dtype}) disagrees with its plain "
                             f"version: max abs err {err.max().item()}")
    return err.max().item()


# ------------------------------------------------------------- phase 1
def card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    say(f"[card] nvidia-smi: {smi}")
    say(f"[card] torch: {torch.cuda.get_device_name(0)}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}  "
        f"devices {torch.cuda.device_count()}")
    return smi


# ------------------------------------------------------------- phase 2
def build():
    from repro_torch.kernels import build as kb

    t0 = time.perf_counter()
    logs = kb.build_all()
    say(f"[build] {len(logs)} libraries in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line or "Compiling" in line:
                say(f"[build] {name}: {line.strip()}")


# ------------------------------------------------------------- phase 3
class Recorder:
    """Wraps the ops wrappers during the main path and keeps a clone of
    the inputs of each kernel's largest call (and, for attention, of the
    largest call with selected query positions)."""

    def __init__(self, ops):
        self.ops = ops
        self.kept = {}
        self.orig = {}

    def _keep(self, key, size, args, kwargs):
        # ``size`` orders calls by their work, read from shapes only (no
        # device sync on the served path)
        if key not in self.kept or self.kept[key][0] < size:
            clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa
            self.kept[key] = (size, [clone(a) for a in args],
                              {k: clone(v) for k, v in kwargs.items()})

    def __enter__(self):
        for name in ("rope_align", "block_diff", "flash_attention",
                     "flash_decode_paged"):
            fn = getattr(self.ops, name)
            self.orig[name] = fn

            def wrapped(*args, _fn=fn, _name=name, **kwargs):
                key, size = _name, args[0].numel()
                if _name == "flash_attention":
                    size *= args[1].shape[1]
                    if args[0].shape[1] != args[1].shape[1]:
                        key = "flash_attention_selected"
                elif _name == "flash_decode_paged":
                    size = args[3].numel()        # pages in the table
                self._keep(key, size, args, kwargs)
                return _fn(*args, **kwargs)

            setattr(self.ops, name, wrapped)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def main_path(dev):
    from repro_torch.configs import get_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine, TokenDancePolicy

    cfg = get_config("qwen2.5-7b")
    say(f"[main] {cfg.name}: {cfg.n_layers} of {cfg.n_layers} layers (no "
        f"depth cut), d {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}"
        f", head_dim {cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, ~{cfg.param_count() / 1e9:.2f} B "
        f"params")
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    say(f"[main] init_params(seed 0) {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    trace = generate_trace("agent_society", 8, 3, cfg.vocab_size, seed=0,
                           jitter_hist=False)
    engine = ServingEngine(params, cfg, TokenDancePolicy(incremental=False),
                           keep_logits=True)
    torch.cuda.reset_peak_memory_stats()
    with Recorder(ops) as rec:
        ops.reset_launches()
        t0 = time.perf_counter()
        stats = engine.serve(trace)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        plain = dict(ops.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for st in stats:
        rs = st.reuse.get("restore", {})
        comp = st.reuse.get("compression", {})
        say(f"[main] round {st.round_idx}: prompt {st.prompt_len}, "
            f"round {st.t_round * 1e3:.1f} ms (recover "
            f"{st.t_recover * 1e3:.1f}, restore {st.t_restore * 1e3:.1f}, "
            f"decode {st.t_decode * 1e3:.1f}, store {st.t_store * 1e3:.1f}), "
            f"restore pool pages {rs.get('pool_pages', 0)} of "
            f"{rs.get('full_write_pages', 0)} unshared, compression "
            f"{comp.get('compression_ratio', float('nan')):.3f}, "
            f"persistent {st.persistent_bytes} B")
        assert st.outputs.shape == (8, engine.gen_len), st.outputs.shape
        assert ((st.outputs >= 0) & (st.outputs < cfg.vocab_size)).all()
        assert np.isfinite(st.first_logits).all(), st.round_idx
        assert st.first_logits.shape == (8, cfg.vocab_size)
        if st.round_idx:
            # shared blocks make the family compress from round 1 on
            # (round 0's prompts share nothing)
            assert comp["compression_ratio"] > 1.0, comp
            assert 0 < rs["pool_pages"] <= rs["full_write_pages"], rs
    say(f"[main] serve {wall:.2f} s for {len(stats)} rounds, peak device "
        f"memory {peak:.2f} GiB")
    say(f"[main] launches {launches}  plain-version calls {plain}")
    missing = [k for k, n in launches.items() if n == 0]
    assert not missing, f"kernels never launched on the main path: {missing}"
    assert not any(plain.values()), f"plain versions ran: {plain}"
    del engine, params
    torch.cuda.empty_cache()
    return launches, rec.kept


# ------------------------------------------------------------- phase 4
def kernels(dev, launches, kept):
    from repro_torch.kernels import ops, ref

    timer = Timer(dev)
    rows = []

    # ---- rope_align -------------------------------------------------
    _, (k, delta, theta), _ = kept["rope_align"]
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        kk = k.to(dt)
        errs[dt] = check("rope_align", ops.rope_align(kk, delta, theta),
                         ref.rope_delta_ref(kk, delta, theta), dt)
    # edge: per-request deltas over [B, L, T] (the decode-tail alignment)
    kb = torch.stack([k] * 4)
    d2 = torch.randint(-700, 700, (4, k.shape[1]), device=dev,
                       dtype=torch.int32)
    check("rope_align", ops.rope_align(kb, d2, theta),
          ref.rope_delta_ref(kb, d2, theta), kb.dtype)
    bms, by = bound(2 * nbytes(k) + nbytes(delta), 7 * k.numel() // 2,
                    k.dtype)
    rows.append(dict(
        name="rope_align", shape=list(k.shape), max_abs_err=errs[k.dtype],
        max_abs_err_f32=errs[torch.float32],
        ms=timer(lambda: ops.rope_align(k, delta, theta)),
        plain_ms=timer(lambda: ref.rope_delta_ref(k, delta, theta)),
        bound_ms=bms, bound_by=by, library_ms=None))

    # ---- block_diff -------------------------------------------------
    _, (ks, vs, master, bt), _ = kept["block_diff"]
    for dt in (torch.bfloat16, torch.float32):
        a, b = ks.to(dt), vs.to(dt)
        errs[dt] = check("block_diff", ops.block_diff(a, b, master, bt),
                         ref.block_diff_ref(a, b, master, bt), dt)
    same = ks[:3].clone()
    same[1:] = same[0]
    assert (ops.block_diff(same, same, 0, bt) == 0).all(), "zero diffs"
    alld = same.clone()
    alld[1:] += 1.0
    out = ops.block_diff(alld, same, 0, bt)
    assert (out[1:] > 0).all() and (out[0] == 0).all(), "all diffs"
    ragged = ks[:, :, : ks.shape[2] - 5].contiguous()
    rv = vs[:, :, : vs.shape[2] - 5].contiguous()
    check("block_diff", ops.block_diff(ragged, rv, master, bt),
          ref.block_diff_ref(ragged, rv, master, bt), ks.dtype)
    bms, by = bound(nbytes(ks, vs) + 4 * ks.shape[0] * (-(-ks.shape[2] // bt)),
                    3 * (ks.numel() + vs.numel()), ks.dtype)
    rows.append(dict(
        name="block_diff", shape=list(ks.shape), max_abs_err=errs[ks.dtype],
        max_abs_err_f32=errs[torch.float32],
        ms=timer(lambda: ops.block_diff(ks, vs, master, bt)),
        plain_ms=timer(lambda: ref.block_diff_ref(ks, vs, master, bt)),
        bound_ms=bms, bound_by=by, library_ms=None))

    # ---- flash_prefill ----------------------------------------------
    def attn_case(key):
        _, (q, k, v), kw = kept[key]
        return q, k, v, kw["q_pos"], kw["window"], kw.get("kv_len")

    def allowed_cols(q_pos, window, Sk, kv_len=None):
        lim = q_pos.long() + 1
        lim = torch.minimum(lim, torch.full_like(lim, Sk))
        if kv_len is not None:
            lim = torch.minimum(lim, kv_len.long()[:, None])
        lo = torch.clamp(q_pos.long() - window + 1, min=0)
        return torch.clamp(lim - lo, min=0).sum().item()

    for key in ("flash_attention", "flash_attention_selected"):
        q, k, v, q_pos, window, kv_len = attn_case(key)
        for dt in (torch.bfloat16, torch.float32):
            qq, kk, vv = q.to(dt), k.to(dt), v.to(dt)
            errs[(key, dt)] = check(
                "flash_prefill",
                ops.flash_attention(qq, kk, vv, q_pos=q_pos, window=window,
                                    kv_len=kv_len),
                ref.flash_attention_ref(qq, kk, vv, q_pos=q_pos,
                                        window=window, kv_len=kv_len), dt)
    # edge: a kv_len that cuts a tile, and a sliding window
    q, k, v, q_pos, window, _ = attn_case("flash_attention_selected")
    kl = torch.full((q.shape[0],), k.shape[1] - 45, device=dev,
                    dtype=torch.int32)
    for w in (window, 100):
        check("flash_prefill",
              ops.flash_attention(q, k, v, q_pos=q_pos, window=w, kv_len=kl),
              ref.flash_attention_ref(q, k, v, q_pos=q_pos, window=w,
                                      kv_len=kl), q.dtype)
    q, k, v, q_pos, window, kv_len = attn_case("flash_attention")
    B, Sq, H, hd = q.shape
    cols = allowed_cols(q_pos, window, k.shape[1], kv_len)
    bms, by = bound(nbytes(q, k, v, q_pos, kv_len) + nbytes(q),
                    4 * hd * H * cols, q.dtype)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    causal = bool(Sq == k.shape[1] and torch.equal(
        q_pos, torch.arange(Sq, device=dev, dtype=torch.int32).expand(B, Sq)))
    assert causal, "the largest main-path prefill call is a causal prefill"
    rows.append(dict(
        name="flash_prefill", shape=list(q.shape) + [k.shape[1]],
        max_abs_err=errs[("flash_attention", q.dtype)],
        max_abs_err_selected=errs[("flash_attention_selected", q.dtype)],
        max_abs_err_f32=errs[("flash_attention", torch.float32)],
        ms=timer(lambda: ops.flash_attention(q, k, v, q_pos=q_pos,
                                             window=window, kv_len=kv_len)),
        plain_ms=timer(lambda: ref.flash_attention_ref(
            q, k, v, q_pos=q_pos, window=window, kv_len=kv_len)),
        bound_ms=bms, bound_by=by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))))

    # ---- flash_decode_paged -----------------------------------------
    _, args, kw = kept["flash_decode_paged"]
    q, pk, pv, pidx, span = args[:5]
    for dt in (torch.bfloat16, torch.float32):
        a = [q.to(dt), pk.to(dt), pv.to(dt), pidx, span]
        errs[dt] = check("flash_decode_paged", ops.flash_decode_paged(*a),
                         ref.flash_decode_paged_ref(*a), dt)
    # edges: ragged last pages (span not a page multiple), then a tail
    B, H, hd = q.shape
    KV = pk.shape[2]
    rag = torch.clamp(span - torch.arange(1, B + 1, device=dev,
                                          dtype=torch.int32) * 7, min=1)
    tk = torch.randn(B, 64, KV, hd, device=dev).to(q.dtype)
    tv = torch.randn(B, 64, KV, hd, device=dev).to(q.dtype)
    for extra in ((), (tk, tv, 45)):
        check("flash_decode_paged",
              ops.flash_decode_paged(q, pk, pv, pidx, rag, *extra),
              ref.flash_decode_paged_ref(q, pk, pv, pidx, rag, *extra),
              q.dtype)
    bt = pk.shape[1]
    pages = int(((span.long() + bt - 1) // bt).sum().item())
    page_bytes = bt * KV * hd * pk.element_size()
    cols = int(span.long().sum().item())
    bms, by = bound(nbytes(q, pidx, span) + nbytes(q) + 2 * pages * page_bytes,
                    4 * hd * H * cols, q.dtype)
    nbt = pidx.shape[1]
    kd = pk[pidx.long()].reshape(B, nbt * bt, KV, hd).transpose(1, 2)
    vd = pv[pidx.long()].reshape(B, nbt * bt, KV, hd).transpose(1, 2)
    mask = (torch.arange(nbt * bt, device=dev)[None] < span[:, None])
    mask = mask[:, None, None, :]
    q4 = q[:, :, None]
    rows.append(dict(
        name="flash_decode_paged", shape=list(q.shape) + [nbt * bt],
        max_abs_err=errs[q.dtype], max_abs_err_f32=errs[torch.float32],
        ms=timer(lambda: ops.flash_decode_paged(q, pk, pv, pidx, span)),
        plain_ms=timer(lambda: ref.flash_decode_paged_ref(q, pk, pv, pidx,
                                                          span)),
        bound_ms=bms, bound_by=by,
        library_ms=timer(lambda: F.scaled_dot_product_attention(
            q4, kd, vd, attn_mask=mask, enable_gqa=True))))

    table = []
    for r in rows:
        r.update(route="cuda", source=SOURCES[r["name"]],
                 replaces=REPLACES[r["name"]], launches=launches[r["name"]])
        say(f"[kernel] {r['name']}: shape {r['shape']}, {r['ms']:.4f} ms "
            f"(plain {r['plain_ms']:.4f}, library {r['library_ms']}, bound "
            f"{r['bound_ms']:.4f} by {r['bound_by']}), max abs err "
            f"{r['max_abs_err']:.3g} bf16 / {r['max_abs_err_f32']:.3g} f32, "
            f"{r['launches']} launches on the main path")
        table.append({k: r[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    return table


# ------------------------------------------------------------- phase 5
def smoke_parity(dev):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.rounds import generate_trace
    from repro_torch.models import init_params
    from repro_torch.serving import ServingEngine, TokenDancePolicy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    cpu_params = init_params(cfg, 0, device="cpu")

    def to_dev(tree):
        if isinstance(tree, dict):
            return {k: to_dev(v) for k, v in tree.items()}
        return tree.to(dev)

    gpu_params = to_dev(cpu_params)
    out = {}
    for name, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        eng = ServingEngine(params, cfg, TokenDancePolicy(), gen_len=32,
                            recompute_ratio=0.1, keep_logits=True)
        out[name] = eng.serve(generate_trace(
            "generative_agents", 3, 3, cfg.vocab_size, seed=11,
            jitter_hist=False))
    worst = 0.0
    for c, g in zip(out["cpu"], out["cuda"]):
        np.testing.assert_array_equal(g.outputs, c.outputs)
        err = float(np.abs(g.first_logits - c.first_logits).max())
        assert err <= 1e-3, (c.round_idx, err)
        worst = max(worst, err)
        assert json.dumps(g.reuse, sort_keys=True, default=str) == \
            json.dumps(c.reuse, sort_keys=True, default=str), c.round_idx
    say(f"[smoke] f32 smoke engine, cuda vs cpu: greedy tokens and reuse "
        f"ledgers equal in {len(out['cpu'])} rounds x 3 agents, max |logit "
        f"diff| {worst:.3g} (atol 1e-3)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = card()
    build()
    launches, kept = main_path(dev)
    table = kernels(dev, launches, kept)
    smoke_parity(dev)
    say(smi)
    print(json.dumps({"kernels": table}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
