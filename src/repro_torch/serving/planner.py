"""Round planning: the per-round admission decision the engine takes.

Only the decision record is ported so far: :class:`RoundPlan` names the
agents a round admits (the others keep their sessions and their last
outputs stay in the gather) and may override the engine's gather
topology for that round. The SLO planner that emits it in the JAX
package (``RoundPlanner`` over ``serving/scheduler.py``) is not ported
yet; callers build plans themselves and hand them to
``ServingEngine.run_round``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core.rounds import GatherTopology


@dataclass
class RoundPlan:
    """One round's admission decision."""

    round_idx: int
    admitted: List[str]
    deferred: List[str] = field(default_factory=list)
    max_agents: int = 0                 # SLO cap; 0 = uncapped
    topology: Optional[GatherTopology] = None   # overrides the engine's
