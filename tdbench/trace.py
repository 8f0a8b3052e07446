"""Reading a ``torch.profiler`` profile of whole rounds from its raw
events: the device's busy time, the device time of the kernels each named
range launched, the device operations that took most time, and the idle
gaps by what the host was doing.

A kernel belongs to the innermost named range that was open on the host
when its launch call ran (the launch's CUDA runtime event, found by the
kernel's correlation id). The port's own kernels are launched from
libraries with their own CUDA runtime, whose launch calls the profiler
does not see: those kernels are left unlinked and are kept by name, for
the readers to claim by their kernel names. The profiler also puts the
named ranges on the device's timeline; those spans are not device work
and are left out."""
from __future__ import annotations

from typing import Dict, List, Tuple

from torch.autograd import DeviceType

TOP = 10


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _owners(ranges, times):
    """The innermost named range (start, end, name) open on the host at
    each of ``times`` (ranges nest), or None."""
    marks = [(s, 0, i) for i, (s, _, _) in enumerate(ranges)]
    marks += [(t, 1, j) for j, t in enumerate(times)]
    marks += [(e, 2, i) for i, (_, e, _) in enumerate(ranges)]
    marks.sort()
    out: List = [None] * len(times)
    stack: List[int] = []
    for _, kind, i in marks:
        if kind == 0:
            stack.append(i)
        elif kind == 1:
            out[i] = ranges[stack[-1]][2] if stack else None
        elif stack and stack[-1] == i:
            stack.pop()
        else:
            stack.remove(i)
    return out


def summarize(prof, names) -> dict:
    """``names``: the benchmark's range names. Seconds; the window runs
    from the first ``round`` range's start to the last one's end on the
    profile's clock."""
    evs = prof.profiler.kineto_results.events()
    host_ranges, kernels, launches = [], [], {}
    for e in evs:
        n = e.name()
        t0 = e.start_ns()
        t1 = t0 + e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if n in names:
                host_ranges.append((t0, t1, n))
            elif "aunch" in n and n.startswith("cu"):
                launches[e.correlation_id()] = t0
        elif n not in names:
            kernels.append((t0, t1, n, e.linked_correlation_id()))
    rounds = [(s, t) for s, t, n in host_ranges if n == "round"]
    if not rounds or not kernels:
        return {}
    w0, w1 = min(s for s, _ in rounds), max(t for _, t in rounds)
    window_ns = w1 - w0
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in kernels
                   if b > w0 and a < w1])
    range_s: Dict[str, float] = {}
    ops: Dict[str, float] = {}
    unlinked = 0.0
    by_name: Dict[str, float] = {}
    owner = _owners(host_ranges, [launches.get(c, -1) for *_, c in kernels])
    for (a, b, n, corr), who in zip(kernels, owner):
        ops[n[:96]] = ops.get(n[:96], 0.0) + (b - a) / 1e9
        if who is None:
            unlinked += (b - a) / 1e9
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        else:
            range_s[who] = range_s.get(who, 0.0) + (b - a) / 1e9
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    spans = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for (a, b), who in zip(spans, _owners(host_ranges,
                                          [(a + b) // 2 for a, b in spans])):
        who = who or "host"
        gaps[who] = gaps.get(who, 0.0) + (b - a) / 1e9
    return {"window_s": window_ns / 1e9,
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "range_device_s": range_s, "unlinked_device_s": unlinked,
            "unlinked_by_kernel": by_name,
            "device_ops": sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:TOP]}
