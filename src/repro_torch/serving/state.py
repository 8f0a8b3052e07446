"""Shared serving state: per-agent sessions and per-round statistics."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.rounds import AgentState


@dataclass
class RoundStats:
    round_idx: int
    mode: str                    # the serving policy's registry name
    n_agents: int
    prompt_len: int
    t_recover: float = 0.0       # prefill / PIC recovery (s)
    t_restore: float = 0.0       # mirror restore on the critical path (s)
    t_decode: float = 0.0
    t_store: float = 0.0         # diff build / segment extraction (s)
    persistent_bytes: int = 0    # cache state surviving the round
    transient_peak_bytes: int = 0
    outputs: Optional[np.ndarray] = None      # [N, G] generated tokens
    first_logits: Optional[np.ndarray] = None  # [N, V] recovery logits
    reuse: dict = field(default_factory=dict)
    admission: Optional[dict] = None          # the round's RoundPlan

    @property
    def t_round(self) -> float:
        return self.t_recover + self.t_restore + self.t_decode + self.t_store

    def merge_reuse(self, key: str, value) -> None:
        """Record a reuse-ledger entry. Single-gather-group rounds (the
        All-Gather default) write the value directly; multi-group rounds
        accumulate a list."""
        if key not in self.reuse:
            self.reuse[key] = value
        elif isinstance(self.reuse[key], list):
            self.reuse[key].append(value)
        else:
            self.reuse[key] = [self.reuse[key], value]


@dataclass
class Session:
    agent_id: str
    state: AgentState
    # prefix policy: the agent's dense cache (its own storage) + the
    # prompt and outputs it holds
    dense_k: Optional[object] = None       # [L, S+G, KV, hd] tensor
    dense_v: Optional[object] = None
    prompt_tokens: Optional[np.ndarray] = None
    # history segment cache, set by the family restore each round
    hist_entry: Optional[object] = None   # SegmentCacheEntry | PagedSegmentCacheEntry
    # tokendance: compressed persistent state
    mirror: Optional[object] = None       # MirrorHandle
    is_master: bool = False
    family: Optional[tuple] = None        # Master-family member tuple
    hist_pending: Optional[tuple] = None   # (hist span len, own-output sid)
