"""Reading the port's own spans and counters (``repro_torch.spans``)
beside the benchmark's round records: six per-layer quantities, how much
of each round the spans cover, and, from a ``torch.profiler`` profile of
rounds run with tracing on, the device's idle time inside each span name
and by the innermost range open on the host.

A traced round is a :class:`Traced`: the harness's ``RoundRec`` with the
spans and counters drained after it (:class:`SpanHooks`, hooks of
``tdbench.episode.run_episode`` that trace each round). The quantities
read the rounds outside the profile, as the harness's metrics do:

  recover_warm_ms       host seconds of ``policy.recover.warm`` (the
                        untimed first run of a new shape), rounds >= 1,
                        a batch
  recover_fresh_ms      device seconds of ``pic.fresh`` outside a warm-up
                        run, rounds >= 1, a batch
  recover_recompute_ms  the same of ``pic.recompute``
  decode_gap_p95_ms     p95 of the device seconds of ``engine.decode.step``
                        (the gap between two tokens of a batch)
  cast_gib_per_token    ``model.cast_bytes`` over the output tokens

and from the profile, ``decode_idle_pct``: the device-idle share of the
union of the ``engine.decode`` spans. Profiling slows the host, so it
overstates the idle share of a round run without the profiler.

A profile of rounds with tracing on holds each span's range on the host
and, where kernels ran inside it, a copy on the device's timeline. Pass
the program's names (:data:`repro_torch.spans.NAMES`) to
``tdbench.trace.summarize`` beside the benchmark's, which drops those
copies; without them they count as device work."""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from torch.autograd import DeviceType

from repro_torch import spans as program_spans
from tdbench.trace import _owners, _union

#: the benchmark's own range names (``tdbench/episode.py``)
BENCH = ("round", "plan", "recover", "decode", "store")


@dataclass
class Traced:
    rec: object                          # tdbench.episode.RoundRec
    spans: list                          # repro_torch.spans.Span
    counters: Dict[str, int] = field(default_factory=dict)


class SpanHooks:
    """``run_episode`` hooks: tracing on from each round's start to its
    end (``on``), the round's spans and counters drained after it, and
    ``inner`` hooks (a profile) called around them."""

    def __init__(self, on: bool = True, inner=None):
        self.on, self.inner = on, inner
        self.drained: Dict[tuple, tuple] = {}

    def before(self, e: int, r: int) -> bool:
        prof = bool(self.inner and self.inner.before(e, r))
        if self.on:
            program_spans.start()
        return prof

    def after(self, e: int, r: int) -> None:
        program_spans.stop()
        done, counters = program_spans.drain()
        for s in done:          # the round has synchronised: read them now
            s.device_s
        self.drained[(e, r)] = (done, counters)
        if self.inner:
            self.inner.after(e, r)

    def traced(self, recs) -> List[Traced]:
        return [Traced(rr, *self.drained.get((rr.ep, rr.r), ([], {})))
                for rr in recs]


def _outside(rounds: List[Traced], first: int = 0) -> List[Traced]:
    return [t for t in rounds if not t.rec.profiled and t.rec.r >= first]


def _per_batch(rounds: List[Traced], total: float) -> Optional[float]:
    n = sum(len(t.rec.batches) for t in rounds)
    return 1e3 * total / n if n else None


def _warm_ids(spans) -> set:
    """Ids of the spans that run inside a ``policy.recover.warm``."""
    parent = {s.id: s.parent for s in spans}
    warm = {s.id for s in spans if s.name == "policy.recover.warm"}
    out = set()
    for s in spans:
        p = s.parent
        while p is not None and p not in warm:
            p = parent.get(p)
        if p is not None:
            out.add(s.id)
    return out


def recover_warm_ms(rounds: List[Traced]) -> Optional[float]:
    rs = _outside(rounds, 1)
    return _per_batch(rs, sum(s.host_s for t in rs for s in t.spans
                              if s.name == "policy.recover.warm"))


def _stage_ms(rounds: List[Traced], name: str) -> Optional[float]:
    rs = _outside(rounds, 1)
    total = 0.0
    for t in rs:
        warm = _warm_ids(t.spans)
        total += sum(s.device_s for s in t.spans
                     if s.name == name and s.id not in warm)
    return _per_batch(rs, total)


def recover_fresh_ms(rounds: List[Traced]) -> Optional[float]:
    return _stage_ms(rounds, "pic.fresh")


def recover_recompute_ms(rounds: List[Traced]) -> Optional[float]:
    return _stage_ms(rounds, "pic.recompute")


def decode_gaps_ms(rounds: List[Traced]) -> List[float]:
    return [1e3 * s.device_s for t in _outside(rounds) for s in t.spans
            if s.name == "engine.decode.step"]


def decode_gap_p95_ms(rounds: List[Traced]) -> Optional[float]:
    gaps = decode_gaps_ms(rounds)
    if len(gaps) < 20:
        return None
    return statistics.quantiles(gaps, n=20, method="inclusive")[18]


def cast_gib_per_token(rounds: List[Traced]) -> Optional[float]:
    rs = _outside(rounds)
    tokens = sum(t.rec.n_agents * t.rec.G for t in rs)
    cast = sum(t.counters.get("model.cast_bytes", 0) for t in rs)
    return cast / 2**30 / tokens if tokens else None


def coverage(spans) -> List[float]:
    """Each ``engine.round``'s share of host time inside its direct
    children."""
    out = []
    for root in (s for s in spans if s.name == "engine.round"):
        inner = sum(s.t1 - s.t0 for s in spans if s.parent == root.id)
        out.append(inner / (root.t1 - root.t0))
    return out


def ttft_from_spans(spans) -> List[float]:
    """Each batch's first token as the spans see it, in ms: the host time
    of the round's batches before it, and of its own spans up to the end
    of its timed ``policy.recover``."""
    out = []
    for root in (s for s in spans if s.name == "engine.round"):
        before = 0
        for b in sorted((s for s in spans if s.parent == root.id
                         and s.name == "engine.batch"), key=lambda s: s.t0):
            kids = [s for s in spans if s.parent == b.id]
            rec = next(s for s in kids if s.name == "policy.recover")
            own = sum(s.t1 - s.t0 for s in kids if s.t1 <= rec.t1)
            out.append((before + own) / 1e6)
            before += b.t1 - b.t0
    return out


# ---- the profile ------------------------------------------------------
def profile_events(prof, names) -> Tuple[list, list]:
    """(host ranges ``(t0, t1, name)`` of ``names``, device intervals
    ``(t0, t1)``) of a profile, in ns: every device event whose name is
    not in ``names`` is device work, as ``tdbench.trace.summarize``
    counts it."""
    host, dev = [], []
    for e in prof.profiler.kineto_results.events():
        n, t0 = e.name(), e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if n in names:
                host.append((t0, t1, n))
        elif n not in names:
            dev.append((t0, t1))
    return host, dev


def _overlap(a: List[Tuple[int, int]], b: List[Tuple[int, int]]) -> int:
    """Length of the intersection of two sorted disjoint interval lists."""
    i = j = out = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        out += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def idle_view(host, dev) -> dict:
    """Seconds. The window runs from the first ``round`` range's start to
    the last one's end. ``inside``: for each name, [device-idle seconds,
    wall seconds] inside the union of its ranges; ``by_range``: the idle
    seconds under the innermost range open on the host (``host``: none),
    every range counted."""
    rounds = [(a, b) for a, b, n in host if n == "round"]
    if not rounds:
        return {}
    w0, w1 = min(a for a, _ in rounds), max(b for _, b in rounds)
    busy = _union([(max(a, w0), min(b, w1)) for a, b in dev
                   if b > w0 and a < w1])
    inside = {}
    for name in sorted({n for *_, n in host}):
        iv = _union([(max(a, w0), min(b, w1)) for a, b, n in host
                     if n == name and b > w0 and a < w1])
        wall = sum(b - a for a, b in iv)
        inside[name] = [(wall - _overlap(iv, busy)) / 1e9, wall / 1e9]
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    by_range: Dict[str, float] = {}
    for (a, b), who in zip(gaps, _owners(host, [(a + b) // 2
                                                for a, b in gaps])):
        who = who or "host"
        by_range[who] = by_range.get(who, 0.0) + (b - a) / 1e9
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "inside": inside, "by_range": by_range}


def decode_idle_pct(view: dict) -> Optional[float]:
    idle, wall = view.get("inside", {}).get("engine.decode", (0.0, 0.0))
    return 100.0 * idle / wall if wall > 0 else None


def unattributed_idle_share(view: dict) -> Optional[float]:
    """Share of the window's idle seconds under a benchmark range or no
    range at all: the idle time no program span or kernel wrapper
    explains."""
    by = view.get("by_range", {})
    total = sum(by.values())
    if total <= 0:
        return None
    return sum(v for k, v in by.items() if k in BENCH or k == "host") / total
