"""Request scheduling: compatible-group formation for the collective path
and a capacity model used by the Fig. 10 benchmarks.

The capacity model turns *measured* per-phase service times (a served
round's ``RoundStats``) plus per-agent persistent memory into round
latency at an offered QPS:

  * service: serial modes pay per-request recovery N times; the collective
    mode pays one grouped pass per round; decode/restore/store are batched.
  * memory: when the persistent footprint of all active agents exceeds the
    KV pool budget, the overflow fraction of agents loses its cached state
    and falls back to full-recompute recovery next round (the pool
    saturation -> preemption/swap mechanism of the paper's Fig. 2).
  * queueing: a single accelerator at utilization rho = qps * s_subrequest
    scales latency by 1/(1-rho) (M/D/1-style congestion); rho >= 1 =>
    unbounded latency (over capacity).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

# group_compatible is re-exported, as the JAX package's module does
from repro_torch.core.collector import group_compatible  # noqa: F401


@dataclass
class ServiceTimes:
    """Measured per-round service costs for one (mode, n_agents) point."""

    per_request_recover: float   # serial modes: cost per request (s)
    collective_recover: float    # collective mode: one cost per round (s)
    decode: float                # batched decode phase (s)
    restore: float = 0.0         # mirror restore (tokendance) (s)
    store: float = 0.0           # diff build / bookkeeping (s)
    collective: bool = False
    # memory model (optional)
    persistent_per_agent: float = 0.0   # bytes of state kept across rounds
    recompute_round: float = 0.0        # full-recompute round cost (s)


def service_times_from_stats(stats, n_agents: int, *, collective: bool,
                             recompute_round: float = 0.0) -> ServiceTimes:
    """Build a :class:`ServiceTimes` point from a measured round
    (``RoundStats``) — the bridge from the engine's per-round ledger into
    the capacity model. Serial policies' per-request cost is the measured
    recovery divided across the round's agents; collective policies carry
    the whole measured pass as the one-per-round cost."""
    return ServiceTimes(
        per_request_recover=stats.t_recover / n_agents,
        collective_recover=stats.t_recover,
        decode=stats.t_decode,
        restore=stats.t_restore,
        store=stats.t_store,
        collective=collective,
        persistent_per_agent=stats.persistent_bytes / n_agents,
        recompute_round=recompute_round,
    )


def round_service_time(st: ServiceTimes, n_agents: int,
                       pool_budget_bytes: float = 0.0) -> float:
    """Effective service time of one round, including swap fallback."""
    if st.collective:
        recover = st.collective_recover
    else:
        recover = st.per_request_recover * n_agents
    base = recover + st.decode + st.restore + st.store
    if pool_budget_bytes and st.persistent_per_agent and st.recompute_round:
        need = st.persistent_per_agent * n_agents
        overflow = max(0.0, 1.0 - pool_budget_bytes / need) if need else 0.0
        # evicted agents lose reuse: they pay the recompute-mode round cost
        base = (1 - overflow) * base + overflow * max(
            st.recompute_round, base)
    return base


def simulate_round_latency(
    st: ServiceTimes,
    n_agents: int,
    qps: float,
    *,
    pool_budget_bytes: float = 0.0,
) -> float:
    """Round latency (s) under offered load ``qps`` subrequests/s."""
    service = round_service_time(st, n_agents, pool_budget_bytes)
    s_sub = service / n_agents
    rho = qps * s_sub
    if rho >= 1.0:
        return float("inf")
    return service / (1.0 - rho)


def max_agents_under_slo(
    measure,                     # (n_agents) -> ServiceTimes
    qps: float,
    slo_s: float,
    agent_range: Sequence[int],
    pool_budget_bytes: float = 0.0,
) -> int:
    """Largest agent count whose simulated round latency stays under SLO."""
    best = 0
    for n in agent_range:
        lat = simulate_round_latency(measure(n), n, qps,
                                     pool_budget_bytes=pool_budget_bytes)
        if lat <= slo_s:
            best = n
    return best
