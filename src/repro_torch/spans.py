"""Spans and counters of the port: where the serving path spends its time
and how much work it moves, recorded where the work happens.

    from repro_torch import spans
    spans.start()
    stats = engine.run_round(rnd)
    spans.stop()
    finished, counters = spans.drain()

A span (:func:`span`) is a named region: a host start and end
(``time.perf_counter_ns``), an id and its parent's id (the innermost span
open when it began), its attributes, and a request id it inherits from its
enclosing spans (the ``engine`` serial, ``round`` and ``gid`` attributes
that ``engine.round`` and ``engine.batch`` carry). A span given the device
its work runs on also records a CUDA event at entry and at exit on that
device's current stream; it never synchronises, and its device duration is
read once the caller has synchronised (on the CPU it is the host duration).
While tracing is on, every span also opens a ``torch.profiler`` range of
its own name, so a profile holds the program's spans on the clock of the
device's kernels. A counter (:func:`count`) adds up a quantity by name.

Tracing is off until :func:`start`; there is no other switch. Off, a span
records nothing and only reads the clock when the caller asks for its
duration (``timed=True``: the ``RoundStats.t_*`` phase timers), and
:func:`count` is one attribute check. Everything is kept in memory until
:func:`drain`.

Span names (``NAMES``) and what each covers:

  engine.round          ``ServingEngine.run_round``
  engine.batch          one equal-length batch of a gather group (``gid``,
                        ``N``, ``S``): plan, recover, decode, store
  policy.plan           the policy's host-side plan (restores included)
  policy.restore        TokenDance's Master-Mirror restores (``t_restore``)
  policy.recover.warm   the untimed first run of a new (batch, length) shape
  policy.recover        the timed recovery, ending in a synchronise
                        (``t_recover``)
  pic.align, pic.fresh, pic.select, pic.recompute, pic.logits
                        the five stages of ``core.pic.pic_prefill`` (device)
  engine.decode         the greedy decode of a batch (``t_decode``), made of
  engine.decode.begin   the decode cache built from the recovered KV,
  engine.decode.step    one model step a token (device), and
  engine.decode.finish  the tokens read back to the host
  policy.store          the batch's post-round storage (``t_store``)

Counters (``COUNTERS``):

  model.cast_bytes      bytes of parameters, in their own dtype, cast to a
                        wider dtype where they are used (a norm scale, or a
                        bf16 weight meeting f32 activations in a product
                        ``models.layers.mixed_ok`` refuses)
  model.mixed_bytes     bf16 bytes of the weights the mixed-precision
                        kernel read as stored (``ops.mixed_matmul``: a
                        bf16 weight meeting the f32 activations of a
                        recovered round, with no cast); its share of
                        ``mixed_bytes + cast_bytes`` is the kernel's
                        engagement
"""
from __future__ import annotations

import itertools
import time
from typing import Dict, List, Optional, Tuple

import torch

NAMES = ("engine.round", "engine.batch", "policy.plan", "policy.restore",
         "policy.recover.warm", "policy.recover", "pic.align", "pic.fresh",
         "pic.select", "pic.recompute", "pic.logits", "engine.decode",
         "engine.decode.begin", "engine.decode.step", "engine.decode.finish",
         "policy.store")
COUNTERS = ("model.cast_bytes", "model.mixed_bytes")
#: the attributes a span's request id is made of, outermost first
REQUEST = ("engine", "round", "gid")


class _Tracer:
    on = False

    def __init__(self) -> None:
        self.stack: List[Span] = []
        self.done: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.ids = itertools.count(1)


_T = _Tracer()


class Span:
    """One region; see the module doc. ``host_s`` and ``device_s`` are
    read after the region has ended."""

    __slots__ = ("name", "attrs", "device", "id", "parent", "request", "t0",
                 "t1", "_events", "_range", "_device_s")

    def __init__(self, name: str, device: Optional[torch.device],
                 attrs: dict):
        self.name = name
        self.attrs = attrs
        self.device = device
        self.id = self.parent = None
        self.request: Tuple = ()
        self._events = self._range = self._device_s = None

    def __enter__(self) -> "Span":
        if _T.on:
            up = _T.stack[-1] if _T.stack else None
            self.id = next(_T.ids)
            self.parent = up.id if up else None
            self.request = self._request(up)
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            if self.device is not None and self.device.type == "cuda":
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(self.device))
                self._events = (ev, None)
            _T.stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        if self.id is not None:
            if self._events is not None:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record(torch.cuda.current_stream(self.device))
                self._events = (self._events[0], ev)
            self._range.__exit__(*exc)
            self._range = None
            _T.stack.pop()             # spans nest: this one is the top
            _T.done.append(self)
        return False

    def _request(self, up: Optional["Span"]) -> Tuple:
        own = [self.attrs.get(k) for k in REQUEST]
        if up is None:
            return tuple(own)
        return tuple(o if o is not None else u
                     for o, u in zip(own, up.request))

    @property
    def host_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def device_s(self) -> float:
        """Seconds between the entry and exit events on the device (waits
        for the exit event); the host duration where no event was
        recorded."""
        if self._device_s is None:
            if self._events is None:
                return self.host_s
            a, b = self._events
            b.synchronize()
            self._device_s = a.elapsed_time(b) / 1e3
            self._events = None
        return self._device_s

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, attrs={self.attrs})")


class _Null:
    """The span of a region nobody times while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()


def span(name: str, device: Optional[torch.device] = None,
         timed: bool = False, **attrs):
    """A context manager over one region (module doc). ``device``: the
    device the region's work runs on, for its device duration; ``timed``:
    the caller reads ``host_s`` even with tracing off."""
    if not (_T.on or timed):
        return _NULL
    return Span(name, device, attrs)


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on."""
    if _T.on:
        _T.counters[name] = _T.counters.get(name, 0) + n


def start() -> None:
    """Turn tracing on."""
    _T.on = True


def stop() -> None:
    """Turn tracing off; what was recorded stays until :func:`drain`."""
    _T.on = False


def drain() -> Tuple[List[Span], Dict[str, int]]:
    """The spans finished and the counters since the last drain, in the
    order the spans ended; both are cleared."""
    done, counters = _T.done, _T.counters
    _T.done, _T.counters = [], {}
    return done, counters
