"""Continuous serving loop: phase-level work-queue scheduling.

Breaks the synchronized engine's round barrier: each committee-round is
a :class:`WorkItem` state machine (PLAN → RESTORE → PREFILL → DECODE →
STORE) and a deterministic :class:`StepScheduler` composes one global
model step per virtual tick — all DECODE-phase committees step, and
other committees' RESTORE/PREFILL work drains into the leftover slot
budget. The synchronized ``ServingEngine.serve`` remains the bit-exact
oracle; :class:`ContinuousEngine` must match it output-for-output on
single-committee traces and beat it on counted-step makespan whenever
committees can overlap.
"""
from repro_torch.serving.loop.engine import ContinuousEngine, ContinuousResult
from repro_torch.serving.loop.scheduler import StepEvent, StepScheduler
from repro_torch.serving.loop.workitem import Phase, PhaseCost, WorkItem

__all__ = [
    "ContinuousEngine",
    "ContinuousResult",
    "Phase",
    "PhaseCost",
    "StepEvent",
    "StepScheduler",
    "WorkItem",
]
