"""Deterministic step scheduler: a virtual clock in model-step slots.

Every tick models one global model step with ``slots_per_step`` token
slots of batch capacity. The decode lane goes first — each DECODE-phase
committee takes one step (one slot per agent) — and PREFILL/RESTORE
work from other committees drains into whatever budget is left, so
committee A's gather/restore for round r+1 overlaps committee B's
decode for round r. No wall-clock anywhere: the makespan is the tick
count, a counted quantity the CI can gate.

The scheduler is policy-free. All real work lives behind the executor
protocol:

* ``phase_begin(item) -> PhaseCost`` — runs the phase's host and model work
  eagerly (admission, restores, the recovery pass, decode warmup, the
  store) and returns its *counted* cost; the item then occupies the
  virtual clock until the cost drains.
* ``run_units(item, k, tick)`` — advance ``k`` units of a budgeted
  phase at ``tick``; only DECODE does real work here (k model steps).
* ``phase_end(item, tick)`` — the phase's units just drained.

Determinism: items are visited in (round, committee) order everywhere,
ties never depend on dict/hash order, and nothing reads time or
randomness — the same trace and costs give the same schedule, bit for
bit, which is what lets the continuous engine be pinned against the
synchronized oracle.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from repro_torch.serving.loop.workitem import Phase, PhaseCost, WorkItem


@dataclass
class StepEvent:
    """One (tick, item) slice of the schedule — the timeline the overlap
    tests and benchmarks read."""

    tick: int
    committee: int
    round_idx: int
    phase: str
    units: int


class StepScheduler:
    """Composes one global step per tick from all in-flight work items."""

    def __init__(self, executor, n_committees: int, n_rounds: int, *,
                 slots_per_step: int,
                 arrivals: Optional[Sequence[int]] = None):
        assert slots_per_step >= 1
        self.executor = executor
        self.n_committees = n_committees
        self.n_rounds = n_rounds
        self.slots = int(slots_per_step)
        self.arrivals = ([0] * n_committees if arrivals is None
                         else [int(x) for x in arrivals])
        assert len(self.arrivals) == n_committees
        self.items: Dict[tuple, WorkItem] = {
            (c, r): WorkItem(c, r, ready_at=self.arrivals[c])
            for c in range(n_committees) for r in range(n_rounds)}
        self._ptr = [0] * n_committees     # committee's current round
        self.now = 0
        self.timeline: List[StepEvent] = []
        #: serial cost in ticks per (committee, round) — the synchronized
        #: baseline's building block, recorded as phases begin
        self._serial: Dict[tuple, int] = {}

    # ------------------------------------------------------------ queues
    def _current(self, c: int) -> Optional[WorkItem]:
        r = self._ptr[c]
        return self.items[(c, r)] if r < self.n_rounds else None

    def _promote(self, c: int) -> None:
        """Advance committee ``c`` through completed items and zero-cost
        phases until it parks on budgeted work, an arrival gate, or the
        end of its rounds. ``phase_begin`` runs the phase's real work
        here; budgeted phases then wait for :meth:`_tick` to feed them
        slots."""
        while True:
            item = self._current(c)
            if item is None:
                return
            if item.done:
                self._ptr[c] += 1
                continue
            if item.ready_at > self.now:
                return
            if not item.started:
                cost = self.executor.phase_begin(item)
                item.started = True
                item.units_left = int(cost.units)
                item.unit_slots = max(1, int(cost.unit_slots))
                item.per_tick = int(cost.per_tick)
                assert item.units_left == 0 or item.unit_slots <= self.slots, (
                    f"phase {item.key} needs {item.unit_slots} slots per "
                    f"unit but the step budget is {self.slots}")
                self._serial[(c, item.round_idx)] = (
                    self._serial.get((c, item.round_idx), 0)
                    + self._serial_ticks(cost))
            if item.units_left > 0:
                return
            self.executor.phase_end(item, self.now)
            item.advance_phase()

    def _serial_ticks(self, cost: PhaseCost) -> int:
        """Ticks this phase takes with the WHOLE budget to itself — how
        long it runs inside a synchronized round barrier."""
        if cost.units <= 0:
            return 0
        if cost.per_tick == 1:
            return cost.units                       # decode: 1 step/tick
        per = max(1, self.slots // max(1, cost.unit_slots))
        return math.ceil(cost.units / per)

    # -------------------------------------------------------------- loop
    def run(self, max_ticks: int = 1_000_000) -> int:
        """Drive every item to DONE; returns the makespan in ticks."""
        while not all(it.done for it in self.items.values()):
            assert self.now < max_ticks, "scheduler failed to make progress"
            self._tick()
        return self.now

    def _active(self) -> List[WorkItem]:
        items = [self._current(c) for c in range(self.n_committees)]
        return sorted(
            (it for it in items
             if it is not None and it.started and it.units_left > 0),
            key=lambda it: (it.round_idx, it.committee))

    def _tick(self) -> None:
        for c in range(self.n_committees):
            self._promote(c)
        budget = self.slots
        # decode lane first (per-tick-capped phases), then PREFILL /
        # RESTORE drain into the remaining budget — both in
        # (round, committee) order
        for capped in (True, False):
            for item in self._active():
                if (item.per_tick == 1) != capped:
                    continue
                cap = item.per_tick if item.per_tick else item.units_left
                afford = budget // item.unit_slots
                take = min(cap, afford, item.units_left)
                if take <= 0:
                    continue
                budget -= take * item.unit_slots
                self.executor.run_units(item, take, self.now)
                item.units_left -= take
                self.timeline.append(StepEvent(
                    self.now, item.committee, item.round_idx, item.phase,
                    take))
                if item.units_left == 0:
                    self.executor.phase_end(item, self.now)
                    item.advance_phase()
                    self._promote(item.committee)
        self.now += 1

    # ---------------------------------------------------------- baselines
    def sync_makespan(self) -> int:
        """The synchronized engine's makespan on the SAME recorded costs:
        rounds are barriers, committees run serially inside each round
        (no overlap anywhere), arrivals only gate a committee's first
        work. Conservative for the baseline — a strict barrier would
        also stall finished committees on the slowest arrival."""
        t = 0
        for r in range(self.n_rounds):
            for c in range(self.n_committees):
                t = max(t, self.arrivals[c])
                t += self._serial.get((c, r), 0)
        return t

    def overlap_steps(self) -> int:
        """Ticks where one committee decoded while ANOTHER committee's
        restore/prefill drained — the quantity the round barrier forces
        to zero."""
        by_tick: Dict[int, List[StepEvent]] = {}
        for ev in self.timeline:
            by_tick.setdefault(ev.tick, []).append(ev)
        n = 0
        for evs in by_tick.values():
            dec = {e.committee for e in evs if e.phase == Phase.DECODE}
            oth = {e.committee for e in evs
                   if e.phase in (Phase.RESTORE, Phase.PREFILL)}
            if dec and (oth - dec):
                n += 1
        return n
