"""Trace Grok-1's decode step on one card: what the MoE layers' host sync
costs in it.

Grok-1 (``grok-1-314b`` at its published widths, cut to 4 of 64 layers as
``chip_smoke.py`` serves it, bf16 weights random from seed 0) prefills 8
random prompts of 544 tokens; its cache is widened to f32, the type the
engine decodes in from round 1 (the recovered KV is f32), and it takes
greedy steps through ``models.decode_step`` (the dense loop). In each MoE
layer ``layers.moe_block`` reads back to the host which experts tokens
reached (a boolean index and ``torch.unique(...).tolist()``, where the
host waits for the device) and loops over those. Printed, as one JSON
line with the card's name and power limit:

  shipped_ms   host clock of each of 10 steps (device synced after each);
  all_ms       the same steps with the loop over every expert instead, no
               readback (an expert no token reached computes zero rows,
               so the logits must be bit-equal, which is checked); the two
               run in turns, shipped / all / all / shipped;
  reached      experts that tokens reached a MoE layer, over 3 steps;
  profile      ``torch.profiler`` over 5 shipped steps: their wall time
               on the host clock, the device's busy time (the union of
               its kernels' and copies' intervals) and so its idle share,
               device time by kind (dtype casts and other copies, matrix
               products, the attention kernel, the rest), the host time of
               the synchronising calls and of the ops that make them, and
               the 12 device operations that take the most time.

    python3 scripts/trace_moe_decode.py
"""
from __future__ import annotations

import inspect
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402

LOOP = "for e in torch.unique(flat_slot[flat_slot < E * C] // C).tolist():"
SYNC_OPS = ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaDeviceSynchronize",
            "aten::nonzero", "aten::_unique2", "aten::unique_dim",
            "aten::_local_scalar_dense", "aten::item")


def every_expert():
    """``layers.moe_block`` with its loop over every expert, no readback."""
    src = inspect.getsource(layers.moe_block)
    assert src.count(LOOP) == 1
    ns = dict(vars(layers))
    exec(compile(textwrap.dedent(src.replace(LOOP, "for e in range(E):")),
                 "moe_block_every_expert", "exec"), ns)
    return ns["moe_block"]


def kind(name):
    """The device operation's kind, by its kernel name."""
    low = name.lower()
    if "flash" in low:
        return "attention kernel"
    if "copy" in low or "memcpy" in low:
        return "casts and copies"
    if any(w in low for w in ("gemm", "gemv", "cutlass", "cublas")):
        return "matrix products"
    return "rest"


def busy_ms(events):
    """Union of the device events' intervals, in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_moe_decode: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    cfg = get_config("grok-1-314b").replace(n_layers=4)
    params = transformer.init_params(cfg, 0, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(cfg.vocab_size, (8, 544), generator=g, device=dev)
    logits, base = transformer.prefill(params, cfg, tokens, max_len=576,
                                       logits_last_only=True)
    base["k"], base["v"] = base["k"].float(), base["v"].float()
    first = logits[:, -1].argmax(-1)
    shipped, every = layers.moe_block, every_expert()

    def steps(fn, n, keep=None):
        layers.moe_block = fn
        cache = {k: v.clone() for k, v in base.items()}
        tok, times = first, []
        try:
            for _ in range(n):
                t0 = time.perf_counter()
                lg, cache = transformer.decode_step(params, cfg, tok, cache)
                tok = lg.argmax(-1)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                if keep is not None:
                    keep.append(lg)
        finally:
            layers.moe_block = shipped
        return times

    steps(shipped, 3)
    steps(every, 3)
    out = {"card": card, "layers": cfg.n_layers, "batch": 8, "prompt": 544}
    got = {"shipped": [], "all": []}
    runs = {"shipped": [], "all": []}
    for mode in ("shipped", "all", "all", "shipped"):
        keep = [] if not got[mode] else None
        runs[mode] += steps(shipped if mode == "shipped" else every, 10, keep)
        if keep is not None:
            got[mode] = keep
    assert all(torch.equal(a, b) for a, b in zip(got["shipped"], got["all"]))
    out["shipped_ms"] = runs["shipped"]
    out["all_ms"] = runs["all"]
    out["shipped_median_ms"] = sorted(runs["shipped"])[10]
    out["all_median_ms"] = sorted(runs["all"])[10]
    out["logits_bit_equal"] = True
    print(json.dumps(out), flush=True)

    reached = []

    def counting(x, p, cfg_, **kw):
        _, _, topi = layers.moe_route(x.reshape(1, -1, x.shape[-1]),
                                      p["router"], cfg_.top_k)
        reached.append(torch.unique(topi).numel())
        return shipped(x, p, cfg_, **kw)

    steps(counting, 3)
    out = {"card": card, "reached": reached}

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(shipped, 5)
        wall = (time.perf_counter() - t0) * 1e3
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = busy_ms(on_dev)
    by_kind = {}
    for e in on_dev:
        k = kind(e.name)
        by_kind[k] = by_kind.get(k, 0.0) + (e.time_range.end -
                                            e.time_range.start) / 1e3
    ka = prof.key_averages()
    sync = {e.key: {"count": e.count,
                    "self_cpu_ms": e.self_cpu_time_total / 1e3,
                    "cpu_ms": e.cpu_time_total / 1e3}
            for e in ka if e.key in SYNC_OPS}
    top = sorted((e for e in ka if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.self_device_time_total, reverse=True)[:12]
    out["profile"] = {
        "steps": 5, "wall_ms": wall, "device_busy_ms": busy,
        "device_idle_share": 1 - busy / wall, "device_ms_by_kind": by_kind,
        "sync": sync,
        "top_device": [{"op": e.key[:120], "count": e.count,
                        "device_ms": e.self_device_time_total / 1e3}
                       for e in top]}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
