"""The ``ReusePolicy`` protocol of the serving layer, in PyTorch.

A policy owns one KV-reuse strategy end to end, in three phases the
engine drives every round, per gather group:

* ``plan(ctx) -> RecoveryPlan`` — host-side planning, including restore
  launches: decide what can be reused and assemble the cached tensors.
* ``recover(plan, tokens) -> RecoveryResult`` — execute the plan: full
  prefill or PIC recovery, returning last-token logits and the
  prefill-state cache the decode loop continues from.
* ``store(ctx, cache, outputs, result, stats)`` — post-round storage.

Policies share a :class:`PolicyRuntime` owned by the engine. A registry
(:func:`register_policy` / :func:`get_policy`) names each policy by its
mode string, so the engine takes a policy object or its name.
"""
from __future__ import annotations

import time
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.collector import KVCollector
from repro_torch.core.segments import PromptLayout, SegmentIndex
from repro_torch.models.transformer import prefill
from repro_torch.serving.kvpool import PagedKVPool
from repro_torch.serving.pool.manager import PoolManager, Spillable
from repro_torch.serving.state import Session


def entry_spillable(entry) -> Spillable:
    """Move a dense :class:`SegmentCacheEntry`'s k/v between tiers, in
    place — the entry object stays; only its tensors change device."""
    def get():
        return (entry.k, entry.v)

    def put(arrs):
        entry.k, entry.v = arrs
    return Spillable(get, put)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class PolicyRuntime:
    """Shared serving substrate a policy executes against (one per
    engine). ``warm`` records the shapes whose first call has run, so
    timings exclude first-call setup (library handles, allocator growth)."""

    params: dict
    cfg: ModelConfig
    gen_len: int
    ratio: float                 # recompute_ratio
    block_select: int
    sep_id: int
    sessions: Dict[str, Session]
    segment_index: SegmentIndex
    pool: PagedKVPool
    collector: KVCollector
    #: tiered pool manager: policies allocate persistent state through it
    #: and call ``ensure_resident`` before reading spillable state
    manager: PoolManager
    device: torch.device
    warm: set = field(default_factory=set)

    def timed(self, key, fn, *args):
        """Run ``fn`` once untimed for a new ``key``, then time it (host
        clock around work that ends in a device synchronise)."""
        if key not in self.warm:
            fn(*args)
            sync(self.device)
            self.warm.add(key)
        t0 = time.perf_counter()
        out = fn(*args)
        sync(self.device)
        return out, time.perf_counter() - t0


@dataclass
class RoundContext:
    """Everything a policy needs to plan one gather group's recovery."""

    round_idx: int
    gid: str                     # stable gather-group id ("g0", "g1", ...)
    agent_ids: List[str]         # group members, session order
    layouts: List[PromptLayout]
    tokens: np.ndarray           # [N, S] host-side prompt tokens

    @property
    def group_key(self) -> tuple:
        return tuple(self.agent_ids)

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[1])


@dataclass
class RecoveryPlan:
    """Host-side planning result: ``kind`` is ``"recompute"`` (full
    prefill — round 0 and the nothing-cached fallback), ``"extend"``
    (prefix reuse of ``prefix_len`` tokens) or ``"reuse"`` (collective
    PIC recovery over ``assembled``)."""

    kind: str
    ctx: RoundContext
    prefix_len: int = 0
    n_sel: int = 0
    assembled: Optional[tuple] = None   # (sk, sv, src, smask, priv, pmask, is_cached)
    t_restore: float = 0.0              # mirror restore spent during plan
    restore_info: Optional[dict] = None # restore ledger for RoundStats.reuse


@dataclass
class RecoveryResult:
    """Recovery logits + prefill-state cache."""

    logits: torch.Tensor         # [N, V] last-token logits
    cache: dict                  # prefill cache ("k"/"v")
    t_recover: float
    info: dict = field(default_factory=dict)


class ReusePolicy(ABC):
    """One KV-reuse strategy: plan / recover / store (see module doc)."""

    name: str = "?"
    #: PIC-style reuse needs attention KV; the engine serves an SSM or
    #: hybrid model with the recompute policy instead
    requires_attention: bool = False
    #: plans in whole KV blocks: the engine refuses ``block_select=0``
    requires_blocks: bool = False
    #: extends a cached attention prefix and has no recompute fallback:
    #: the engine refuses a hybrid model at construction (an
    #: attention-free one caches nothing, so every round recomputes)
    requires_attention_cache: bool = False

    def __init__(self) -> None:
        self.rt: Optional[PolicyRuntime] = None

    def bind(self, rt: PolicyRuntime) -> None:
        """Attach the engine's runtime. Called once by the engine."""
        self.rt = rt

    @abstractmethod
    def plan(self, ctx: RoundContext) -> RecoveryPlan:
        """Host-side planning for one gather group."""

    @abstractmethod
    def recover(self, plan: RecoveryPlan,
                tokens: torch.Tensor) -> RecoveryResult:
        """Execute ``plan`` over the group's prompts."""

    def store(self, ctx: RoundContext, cache: dict, outputs: np.ndarray,
              result: RecoveryResult, stats) -> None:
        """Post-round storage (default: keep nothing)."""

    def _recover_recompute(self, tokens: torch.Tensor) -> RecoveryResult:
        """Full batched prefill — the universal fallback path."""
        rt = self.rt
        N, S = tokens.shape

        def run(toks):
            logits, cache = prefill(rt.params, rt.cfg, toks, max_len=S,
                                    logits_last_only=True)
            return logits[:, -1], cache

        (logits, cache), dt = rt.timed(("prefill", N, S), run, tokens)
        return RecoveryResult(logits, cache, dt, {})


# --------------------------------------------------------------------------
# Registry: mode strings -> policy classes
# --------------------------------------------------------------------------
POLICIES: Dict[str, Callable[..., ReusePolicy]] = {}


def register_policy(name: str):
    """Class decorator registering a policy under a mode string."""
    def deco(cls):
        cls.name = name
        POLICIES[name] = cls
        return cls
    return deco


def get_policy(name: str, **kwargs) -> ReusePolicy:
    """Instantiate a registered policy by its mode string."""
    if name not in POLICIES:
        raise KeyError(f"unknown policy {name!r}; have {sorted(POLICIES)}")
    return POLICIES[name](**kwargs)
