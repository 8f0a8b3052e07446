"""Work items: one committee-round decomposed into schedulable phases.

The continuous serving loop breaks the global round barrier by treating
each committee's round as a small state machine

    PLAN -> RESTORE -> PREFILL -> DECODE -> STORE -> (next round)

keyed by ``(committee, round, phase)``. Phases differ in how they spend
the scheduler's per-step slot budget:

* **PLAN / STORE** are host-side bookkeeping (admission, prompt build,
  diff build, segment extraction) — zero model-step cost, they complete
  the tick they start.
* **RESTORE** is counted restore work: the pages the policy's ``plan``
  wrote (``pool_pages`` of the restore ledger) times the page tile, in
  token-slots.
* **PREFILL** is the recovery pass: N×S token-slots, drained from
  whatever slot budget the decode lane leaves each tick.
* **DECODE** is capped at ONE model step per tick (``per_tick=1``): each
  step consumes one slot per agent in the committee and emits one token
  per agent — the phase that defines the virtual clock.

Costs are *counted* quantities (pages, tokens, steps), never wall-clock,
matching the repo's counted-work CI policy.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


class Phase:
    """Phase names, in execution order."""

    PLAN = "plan"
    RESTORE = "restore"
    PREFILL = "prefill"
    DECODE = "decode"
    STORE = "store"
    DONE = "done"
    ORDER = (PLAN, RESTORE, PREFILL, DECODE, STORE)


@dataclass
class PhaseCost:
    """What one phase costs, returned by the executor's ``phase_begin``.

    ``units`` of work remain; each unit occupies ``unit_slots`` of the
    per-tick slot budget; at most ``per_tick`` units run per tick (0 =
    unlimited — the phase drains as fast as leftover budget allows).
    ``units=0`` means the phase is instantaneous (host work).
    """

    units: int
    unit_slots: int = 1
    per_tick: int = 0


@dataclass
class WorkItem:
    """One committee-round in flight.

    The scheduler owns ``phase``/``units_left`` and calls the executor
    to do the real work; ``data`` is the executor's scratch space (round
    plan, per-partition contexts, open decode states...). Rounds of one
    committee are strictly sequential: the item for round r+1 starts
    only once round r's item is DONE.
    """

    committee: int
    round_idx: int
    ready_at: int = 0          # virtual tick gate (committee arrival)
    phase: str = Phase.PLAN
    units_left: int = 0
    unit_slots: int = 1
    per_tick: int = 0
    started: bool = False      # phase_begin ran for the current phase
    data: dict = field(default_factory=dict)

    @property
    def key(self) -> Tuple[int, int, str]:
        return (self.committee, self.round_idx, self.phase)

    @property
    def done(self) -> bool:
        return self.phase == Phase.DONE

    def advance_phase(self) -> None:
        i = Phase.ORDER.index(self.phase)
        self.phase = (Phase.ORDER[i + 1] if i + 1 < len(Phase.ORDER)
                      else Phase.DONE)
        self.started = False
        self.units_left = 0
        self.unit_slots = 1
        self.per_tick = 0
