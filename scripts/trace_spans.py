"""Run one cell of the benchmark (``tdbench/``) on the card with the
port's spans (``repro_torch.spans``) off and on, and read them with
``tdbench/spanview.py``.

    python3 scripts/trace_spans.py --workload <cell> --seed <n> [--pairs 2]

Set-up as ``tdbench/run.py``: the kernels, the weights from the seed, the
traffic, one warm episode. Then, printed as one JSON line with the card's
name and power limit:

  cost      ``--pairs`` pairs of episodes with tracing off and on in turns
            (off, on, on, off, ...), run as a ``--trace 0`` run runs them
            (no profiler, no benchmark ranges): the median round wall time
            of each, and each round index's mean on / off;
  spans     from the traced episodes: the six per-layer quantities beside
            the phase timers' metrics of the same rounds,
            ``model.mixed_bytes`` an output token and its share of the
            weight bytes cast or read by the mixed-precision kernel, each
            round's share of host time in the direct children of
            ``engine.round``, and each batch's time to its first token as
            its spans add it
            up over the benchmark's CUDA-event reading;
  profile   one more episode as a ``--trace 1`` run makes it (the
            benchmark's ranges; rounds 1-2 under ``torch.profiler``) with
            tracing on: ``summarize`` with the benchmark's names and the
            program's (its device operations and idle gaps), the fields the
            benchmark's metrics read against ``summarize`` of the same
            events with the program's ranges taken out and against
            ``summarize`` without the program's names, idle time inside
            each span name and by the innermost range open on the host,
            ``decode_idle_pct``, the share of idle time that no program span
            or kernel wrapper explains, and the benchmark's per-layer
            metrics of that episode.

``--rehearse`` runs the same on the CPU at a tiny bf16 size (the harness
tests' widths), with no profile of the device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
TINY = {"name": "tiny", "source": "test", "hidden_size": 128,
        "intermediate_size": 256, "num_attention_heads": 4,
        "num_hidden_layers": 2, "num_key_value_heads": 2, "vocab_size": 1024,
        "rope_theta": 1e6, "rms_norm_eps": 1e-6,
        "tie_word_embeddings": False, "torch_dtype": "bfloat16"}


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def without(prof, names):
    """A stand-in for ``prof`` whose events leave out ``names``' ranges,
    as a profile of the same rounds without the program's spans."""
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name() not in names]
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: evs)))


def mixed_counters(spanview, traced) -> dict:
    """``model.mixed_bytes`` (the bf16 weight bytes the mixed-precision
    kernel read) as GiB an output token over the rounds
    ``cast_gib_per_token`` reads, and its share of ``mixed_bytes +
    cast_bytes`` (the kernel's engagement), in %."""
    rs = spanview._outside(traced)
    tokens = sum(t.rec.n_agents * t.rec.G for t in rs)
    mixed = sum(t.counters.get("model.mixed_bytes", 0) for t in rs)
    cast = sum(t.counters.get("model.cast_bytes", 0) for t in rs)
    return {"mixed_gib_per_token": mixed / 2**30 / tokens if tokens else None,
            "mixed_share_pct": 100 * mixed / (mixed + cast)
            if mixed + cast else None}


def read_fields(summary: dict) -> dict:
    """What the benchmark's profile metrics read of a summary."""
    if not summary:
        return {}
    return {"window_s": summary["window_s"], "busy_s": summary["busy_s"],
            "unlinked_by_kernel": summary["unlinked_by_kernel"],
            "ops": {k: v for k, v in summary["range_device_s"].items()
                    if k.startswith("ops.")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--rehearse", action="store_true")
    a = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from torch.autograd import DeviceType

    from repro_torch import spans
    from tdbench import episode, flops, run, spanview
    from tdbench.trace import summarize
    from tdbench.traffic import Traffic, make_episode
    from tdbench.weights import (load_config, make_weights, program_params,
                                 sizes)

    t_start = time.perf_counter()
    if a.rehearse:
        dev, c = torch.device("cpu"), TINY
        traffic = Traffic("tiny", {32: 2, 64: 2}, 8, 32, 3)
        card = "cpu (rehearsal)"
    else:
        if not torch.cuda.is_available():
            log("trace_spans: needs a CUDA device")
            return 2
        from repro_torch.kernels import build
        dev = torch.device("cuda")
        spec = run.manifest_cell(a.workload)
        c, traffic = load_config(spec["config"]), Traffic.load(spec["traffic"])
        build.build_all(("rope_align", "block_diff", "flash_prefill",
                         "flash_decode_paged", "diff_restore",
                         "mixed_matmul"))
        card = f"{torch.cuda.get_device_name(0)}; {run.card_line()}"
    s = sizes(c)
    cfg = episode.model_config(c)
    clock = episode.Clock(dev)
    params = program_params(make_weights(s, a.seed, dev))

    def one(e, hooks=None, ranges=False):
        recs = episode.run_episode(params, cfg, traffic,
                                   make_episode(traffic, s["V"], a.seed, e),
                                   e, clock, ranges=ranges, hooks=hooks)
        for rr in recs:
            rr.flops = sum(flops.batch_flops(
                s, len(b.aids), b.S, rr.G,
                None if b.sel is None else [b.sel[x] for x in b.aids])
                for b in rr.batches)
        return recs

    one(-1)
    clock.sync()
    setup_s = time.perf_counter() - t_start
    log(f"[set-up] {setup_s:.3f} s on {card}")

    # ---- the cost of tracing: off, on, on, off, ... ----------------------
    hooks = spanview.SpanHooks()
    runs = {"off": [], "on": []}
    e = 1
    for p in range(a.pairs):
        for on in ((False, True) if p % 2 == 0 else (True, False)):
            runs["on" if on else "off"].append(one(e, hooks if on else None))
            e += 1
    walls = {k: [rr.wall_s for recs in v for rr in recs]
             for k, v in runs.items()}
    by_round = {}
    for r in range(traffic.rounds if a.pairs else 0):
        mean = {k: statistics.fmean(rr.wall_s for recs in v for rr in recs
                                    if rr.r == r) for k, v in runs.items()}
        by_round[r] = mean["on"] / mean["off"]
    cost = {k: statistics.median(v) for k, v in walls.items() if v}
    cost["on_over_off_by_round"] = by_round
    log(f"[cost] {cost}")

    # ---- the spans of the traced episodes --------------------------------
    recs = [rr for v in runs["on"] for rr in v]
    traced = hooks.traced(recs)
    record = run.RunRecord(recs, traffic, sum(rr.wall_s for rr in recs),
                           setup_s, 0, None, {})
    out_spans = {m: getattr(spanview, m)(traced) for m in (
        "recover_warm_ms", "recover_fresh_ms", "recover_recompute_ms",
        "decode_gap_p95_ms", "cast_gib_per_token")}
    out_spans["decode_gap_samples"] = len(spanview.decode_gaps_ms(traced))
    out_spans.update(mixed_counters(spanview, traced))
    for m in ("recover_ms", "restore_ms", "decode_step_ms", "store_ms"):
        out_spans[m] = run.reader(m)(record)
    cover = [x for t in traced for x in spanview.coverage(t.spans)] or [0]
    ttft = [(t.rec.r, i, got, b.ttft_ms) for t in traced
            for i, (got, b) in enumerate(zip(
                spanview.ttft_from_spans(t.spans), t.rec.batches))]
    out_spans["coverage_min"] = min(cover)
    out_spans["coverage_median"] = statistics.median(cover)
    out_spans["ttft_spans_over_events"] = {
        f"batch{i}": sorted(round(got / ms, 5) for r, j, got, ms in ttft
                            if j == i and r >= 1 and ms > 0)
        for i in sorted({j for _, j, _, _ in ttft})}
    log(f"[spans] {out_spans}")

    # ---- one episode as a traced run makes it, tracing on ----------------
    oplog = episode.OpLog()
    episode.install_ranges(oplog)
    ph = run.ProfileHooks(oplog)
    hooks = spanview.SpanHooks(inner=ph)
    recs = one(0, hooks, ranges=True)
    out_prof = {}
    if ph.prof is not None and dev.type == "cuda":
        prof = ph.prof
        bench = set(spanview.BENCH) | {f"ops.{n}" for n in episode.WRAPPED_OPS}
        names = bench | set(spans.NAMES)
        summary = summarize(prof, names)
        plain = summarize(without(prof, spans.NAMES), bench)
        unnamed = summarize(prof, bench)
        view = spanview.idle_view(*spanview.profile_events(prof, names))
        record = run.RunRecord(recs, traffic, sum(rr.wall_s for rr in recs),
                               setup_s, torch.cuda.max_memory_allocated(dev),
                               summary, oplog.bounds())
        bench_json = run.manifest()
        copies, events = {}, {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CPU and e.name() in spans.NAMES:
                n, t = copies.get(e.name(), (0, 0.0))
                copies[e.name()] = (n + 1, t + e.duration_ns() / 1e9)
        for (ep, r), (done, _) in hooks.drained.items():
            for sp in done:
                if r in (1, 2) and sp.name.startswith(("pic.", "engine.d")):
                    n, t, h = events.get(sp.name, (0, 0.0, 0.0))
                    events[sp.name] = (n + 1, t + sp.device_s, h + sp.host_s)
        out_prof = {
            "window_s": summary["window_s"], "busy_s": summary["busy_s"],
            "device_ops": summary["device_ops"],
            "idle_gaps": summary["idle_gaps"],
            "fields_equal_without_program_ranges":
                read_fields(summary) == read_fields(plain),
            "busy_s_without_program_names": unnamed.get("busy_s"),
            "idle_inside": view["inside"],
            "device_copies_n_s": copies,
            "span_events_n_device_host_s": events,
            "idle_by_range": dict(sorted(view["by_range"].items(),
                                         key=lambda kv: -kv[1])),
            "decode_idle_pct": spanview.decode_idle_pct(view),
            "unattributed_idle_share":
                spanview.unattributed_idle_share(view),
            "metrics": {m["name"]: run.reader(m["name"])(record)
                        for m in bench_json["per_layer"]},
        }
        record.profile = plain
        out_prof["profile_metrics_without_program_ranges"] = {
            m: run.reader(m)(record) for m in (
                "decode_attn_roofline", "prefill_attn_roofline",
                "device_idle_pct")}
        log(f"[profile] {out_prof}")
    out = {"cell": a.workload, "seed": a.seed, "card": card,
           "setup_s": setup_s, "cost": cost, "spans": out_spans,
           "profile": out_prof}
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
