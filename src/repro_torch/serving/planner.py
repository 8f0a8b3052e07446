"""Round planning: gather topology + SLO admission ahead of each round.

:class:`RoundPlanner` uses the capacity model of ``serving/scheduler.py``
on the serving path: given a measured (or modeled) ``ServiceTimes``
source, it runs :func:`~repro_torch.serving.scheduler.max_agents_under_slo`
before every round and admits only as many agents as the SLO sustains at
the offered load. Deferred agents keep their sessions (and their last
outputs stay in the gather) but do not run this round — the
admission-control analogue of the paper's Fig. 10 capacity ceiling.

``ServingEngine.serve(trace, planner)`` drives one ``plan_round`` per
round, records the decision on ``RoundStats.admission``, and feeds each
served round's stats back through :meth:`RoundPlanner.observe` — with
``refit_every`` set, the capacity model is re-fit from measurement
(:func:`~repro_torch.serving.scheduler.service_times_from_stats`) instead
of staying an a-priori guess.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, List, Optional, Sequence

from repro_torch.core.rounds import GatherTopology
from repro_torch.serving.scheduler import (ServiceTimes, max_agents_under_slo,
                                           service_times_from_stats)


@dataclass
class RoundPlan:
    """One round's admission decision, emitted by :class:`RoundPlanner`."""

    round_idx: int
    admitted: List[str]
    deferred: List[str] = field(default_factory=list)
    max_agents: int = 0                 # SLO cap; 0 = uncapped
    topology: Optional[GatherTopology] = None   # overrides the engine's


class RoundPlanner:
    """Emits per-round :class:`RoundPlan`s from a topology + SLO model.

    Parameters:
      topology          — gather topology for planned rounds (``None``
                          keeps the engine's own, default All-Gather).
      measure           — ``(n_agents) -> ServiceTimes``; the capacity
                          model input. ``None`` disables admission (all
                          agents admitted — bit-identical to unplanned
                          serving).
      qps / slo_s       — offered load (subrequests/s) and the round
                          latency SLO the admitted set must satisfy.
      agent_range       — candidate agent counts for the SLO search
                          (default ``1..n_agents``).
      pool_budget_bytes — KV pool budget for the memory-fallback term.
      refit_every       — re-fit ``measure`` from observed round stats
                          every this many :meth:`observe` calls (0 =
                          never; the initial model is kept verbatim).

    Admission is ROUND-ROBIN fair: a rotating cursor advances by the cap
    each planned round, so under a stable cap every agent is served
    ``cap/n`` of the rounds — deferral means "not this round", never
    permanent starvation of a fixed tail.
    """

    def __init__(self, topology: Optional[GatherTopology] = None, *,
                 measure: Optional[Callable[[int], ServiceTimes]] = None,
                 qps: float = 0.0, slo_s: float = math.inf,
                 agent_range: Optional[Sequence[int]] = None,
                 pool_budget_bytes: float = 0.0,
                 refit_every: int = 0):
        self.topology = topology
        self.measure = measure
        self.qps = qps
        self.slo_s = slo_s
        self.agent_range = agent_range
        self.pool_budget_bytes = pool_budget_bytes
        self.refit_every = refit_every
        self.refits = 0           # times observe() replaced the model
        self._obs: List[object] = []
        self._cursor = 0          # round-robin start of the admitted slice

    @property
    def admission_active(self) -> bool:
        return (self.measure is not None and self.qps > 0.0
                and math.isfinite(self.slo_s))

    def plan_round(self, round_idx: int,
                   agent_ids: Sequence[str]) -> RoundPlan:
        aids = list(agent_ids)
        if not self.admission_active:
            return RoundPlan(round_idx, aids, [], 0, self.topology)
        rng = self.agent_range or range(1, len(aids) + 1)
        cap = max_agents_under_slo(
            self.measure, self.qps, self.slo_s, rng,
            pool_budget_bytes=self.pool_budget_bytes)
        n_adm = min(cap, len(aids))
        start = self._cursor % len(aids) if aids else 0
        admitted = [aids[(start + i) % len(aids)] for i in range(n_adm)]
        self._cursor = (start + n_adm) % len(aids) if aids else 0
        deferred = [a for a in aids if a not in admitted]
        return RoundPlan(round_idx, admitted, deferred, cap, self.topology)

    def observe(self, stats, *, collective: bool,
                recompute_round: float = 0.0) -> None:
        """Feed one served round's measured ``RoundStats`` back into the
        capacity model.

        Closes the measure→admit loop: with ``refit_every=k > 0``, every
        k observed rounds the (possibly modeled) ``measure`` callable is
        replaced by :func:`service_times_from_stats` over the mean of
        the window — admission caps then track what the engine actually
        measured instead of the a-priori model. Rounds that admitted
        nobody carry no timing signal and are skipped.
        """
        if getattr(stats, "n_agents", 0) <= 0:
            return
        self._obs.append(stats)
        if self.refit_every <= 0 or len(self._obs) % self.refit_every != 0:
            return
        window = self._obs[-self.refit_every:]
        n = len(window)
        mean = SimpleNamespace(
            t_recover=sum(s.t_recover for s in window) / n,
            t_decode=sum(s.t_decode for s in window) / n,
            t_restore=sum(s.t_restore for s in window) / n,
            t_store=sum(s.t_store for s in window) / n,
            persistent_bytes=sum(s.persistent_bytes for s in window) / n,
        )
        n_obs = max(1, round(sum(s.n_agents for s in window) / n))
        fitted = service_times_from_stats(
            mean, n_obs, collective=collective,
            recompute_round=recompute_round)
        # measured rounds ran n_obs agents; the capacity model scales the
        # per-request/collective split across candidate counts itself
        self.measure = lambda n_agents: fitted
        self.refits += 1
