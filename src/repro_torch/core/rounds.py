"""All-Gather round abstraction (paper §2.1), gather topologies, and
synthetic workload traces.

A round: every agent holds a private history H_i, the scheduler gathers
the previous round's output blocks O = {O_1..O_N} and each agent's next
prompt is ``H_i || Π_i(O)`` (+ a round task). Traces model the paper's two
evaluation workloads:

* ``generative_agents`` — shorter private histories, fewer agents/round
* ``agent_society``     — longer histories, more agents

A :class:`GatherTopology` declares WHICH agents' outputs each agent
receives — the paper evaluates the full All-Gather, but the serving layer
is topology-generic: neighborhood or grouped rounds (KVFlow-style
workflow awareness) express "agent i reads only its committee" without
touching the reuse machinery. Agents with identical source sets form one
gather group: they share a prompt layout and shared-block content, which
is exactly the §4.2 compatibility constraint the KV Collector needs for
a collective pass, and the unit at which Master families form (§4.3).

Output blocks are either taken from the trace (replay mode) or generated
by the engine (greedy decode) so accuracy divergence can compound across
rounds like in the paper's Fig. 14.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.segments import (
    PRIVATE,
    SHARED,
    TASK,
    Segment,
    aligned_segment,
    build_prompt,
)

WORKLOADS = {
    # (init history len, per-round task len, output block len)
    "generative_agents": dict(hist_len=64, task_len=16, out_len=32),
    "agent_society": dict(hist_len=192, task_len=24, out_len=48),
}


@dataclass
class AgentState:
    agent_id: str
    history: np.ndarray          # int32 private history tokens

    def extend_history(self, tokens: np.ndarray) -> None:
        self.history = np.concatenate([self.history, np.asarray(tokens, np.int32)])


@dataclass
class Round:
    """One synchronized round: shared blocks + per-agent tasks."""

    index: int
    shared_blocks: List[np.ndarray]      # previous round outputs O^{t-1}
    tasks: Dict[str, np.ndarray]         # per-agent round task tokens


# --------------------------------------------------------------------------
# Gather topologies
# --------------------------------------------------------------------------
class GatherTopology:
    """Declares which agents' outputs each agent receives in a round.

    ``sources(agent_ids)`` maps every agent to the ordered tuple of
    *agent indices* (into ``agent_ids``) whose previous-round outputs
    appear in its prompt. Shared block ``j`` is always the output of
    agent ``agent_ids[j]``, so a source tuple doubles as a prompt layout
    order (``core.rounds.round_prompt``'s ``layout_order``).

    ``gather_groups`` partitions agents by identical source tuples —
    members of one group share shared-block content and prompt layout, so
    they can share ONE collective recovery pass and form ONE Master
    family. The full All-Gather is the single-group special case.
    """

    def sources(self, agent_ids: Sequence[str]) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    def gather_groups(self, agent_ids: Sequence[str],
                      members: Optional[Sequence[str]] = None) -> List[List[str]]:
        """Partition ``members`` (default: all agents) into gather groups,
        preserving order. ``agent_ids`` is the full round roster that
        source indices refer to (admission may restrict ``members``)."""
        src = self.sources(list(agent_ids))
        groups: Dict[Tuple[int, ...], List[str]] = {}
        for a in (agent_ids if members is None else members):
            groups.setdefault(src[a], []).append(a)
        return list(groups.values())


@dataclass(frozen=True)
class AllGather(GatherTopology):
    """Every agent receives every agent's output (the paper's workload)."""

    def sources(self, agent_ids: Sequence[str]) -> Dict[str, Tuple[int, ...]]:
        full = tuple(range(len(agent_ids)))
        return {a: full for a in agent_ids}


@dataclass(frozen=True)
class SubsetGather(GatherTopology):
    """Explicit per-agent source sets (neighborhood / grouped rounds).

    ``source_map`` maps agent id -> ordered tuple of source agent
    indices. Constructors:

    * :meth:`full` — every agent reads everyone; reproduces
      :class:`AllGather` exactly (the parity anchor).
    * :meth:`grouped` — contiguous committees of ``group_size``; each
      agent reads its own committee's outputs.
    * :meth:`neighborhood` — ring window of ``k`` neighbors each side
      (plus self); every agent gets its own source set, so gather groups
      degenerate to singletons — the collector's per-request fallback.
    """

    source_map: Tuple[Tuple[str, Tuple[int, ...]], ...]

    @classmethod
    def of(cls, mapping: Dict[str, Sequence[int]]) -> "SubsetGather":
        return cls(tuple((a, tuple(int(j) for j in js))
                         for a, js in mapping.items()))

    @classmethod
    def full(cls, agent_ids: Sequence[str]) -> "SubsetGather":
        n = len(agent_ids)
        return cls.of({a: range(n) for a in agent_ids})

    @classmethod
    def grouped(cls, agent_ids: Sequence[str], group_size: int) -> "SubsetGather":
        m = {}
        for i, a in enumerate(agent_ids):
            g0 = (i // group_size) * group_size
            m[a] = range(g0, min(g0 + group_size, len(agent_ids)))
        return cls.of(m)

    @classmethod
    def neighborhood(cls, agent_ids: Sequence[str], k: int) -> "SubsetGather":
        n = len(agent_ids)
        # dict.fromkeys: order-preserving dedupe — a window wider than the
        # ring (2k+1 > n) must not insert the same block twice
        return cls.of({
            a: dict.fromkeys((i + d) % n for d in range(-k, k + 1))
            for i, a in enumerate(agent_ids)})

    def sources(self, agent_ids: Sequence[str]) -> Dict[str, Tuple[int, ...]]:
        m = dict(self.source_map)
        missing = [a for a in agent_ids if a not in m]
        assert not missing, f"topology lacks sources for {missing}"
        return {a: m[a] for a in agent_ids}


@dataclass
class AllGatherTrace:
    workload: str
    agent_ids: List[str]
    rounds: List[Round]
    vocab_size: int
    sep_id: int
    init_histories: Dict[str, np.ndarray]
    out_len: int


def generate_trace(
    workload: str,
    n_agents: int,
    n_rounds: int,
    vocab_size: int,
    *,
    seed: int = 0,
    sep_id: Optional[int] = None,
    jitter_hist: bool = True,
) -> AllGatherTrace:
    """Build a deterministic synthetic trace of All-Gather rounds."""
    spec = WORKLOADS[workload]
    rng = np.random.default_rng(seed)
    sep = vocab_size - 1 if sep_id is None else sep_id

    def toks(n):
        return rng.integers(0, vocab_size - 1, size=n).astype(np.int32)

    agent_ids = [f"agent{i}" for i in range(n_agents)]
    inits = {}
    for i, aid in enumerate(agent_ids):
        # private histories differ in length -> shared blocks land at
        # different absolute positions (the core of the All-Gather problem)
        extra = int(rng.integers(0, spec["out_len"])) if jitter_hist else 0
        inits[aid] = toks(spec["hist_len"] + extra)

    rounds = []
    for r in range(n_rounds):
        shared = [toks(spec["out_len"]) for _ in range(n_agents)] if r else []
        tasks = {aid: toks(spec["task_len"]) for aid in agent_ids}
        rounds.append(Round(r, shared, tasks))
    return AllGatherTrace(workload, agent_ids, rounds, vocab_size, sep,
                          inits, spec["out_len"])


def round_prompt(
    state: AgentState,
    shared_blocks: Sequence[np.ndarray],
    task: np.ndarray,
    sep_id: int,
    *,
    layout_order: Optional[Sequence[int]] = None,
    align_blocks: int = 0,
):
    """Assemble agent *i*'s prompt ``H_i || Π_i(O) || task`` (Fig. 1/6).

    ``align_blocks`` > 0 pads every segment to whole KV blocks and omits
    physical separators (block boundaries mark segments; the pad token is
    ``sep_id``). See segments.build_prompt.
    """
    order = list(range(len(shared_blocks))) if layout_order is None else list(layout_order)
    if align_blocks:
        mk = lambda t, kind: aligned_segment(t, kind, align_blocks, sep_id)
        segs = [mk(state.history, PRIVATE)]
        segs += [mk(shared_blocks[j], SHARED) for j in order]
        segs.append(mk(task, TASK))
        return build_prompt(segs, None)
    segs = [Segment(tuple(int(t) for t in state.history), PRIVATE)]
    for j in order:
        segs.append(Segment(tuple(int(t) for t in shared_blocks[j]), SHARED))
    segs.append(Segment(tuple(int(t) for t in task), TASK))
    return build_prompt(segs, sep_id)
