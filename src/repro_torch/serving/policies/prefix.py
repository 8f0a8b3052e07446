"""vLLM + automatic prefix caching: exact reuse of each agent's own
history prefix, fresh compute for everything after it."""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.transformer import extend
from repro_torch.serving.policies.base import (RecoveryPlan, RecoveryResult,
                                               ReusePolicy, RoundContext,
                                               register_policy)
from repro_torch.serving.pool import Spillable
from repro_torch.serving.round_kv import round_kv


def _common_prefix(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.shape[0], b.shape[0])
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if neq.size else n


def _session_spillable(s) -> Spillable:
    """Move a session's dense prefix cache between tiers, in place."""
    def get():
        return (s.dense_k, s.dense_v)

    def put(arrs):
        s.dense_k, s.dense_v = arrs
    return Spillable(get, put)


@register_policy("prefix")
class PrefixCachePolicy(ReusePolicy):
    """Exact own-prefix reuse over dense per-session caches.

    ``plan`` computes (host-side) the longest prompt prefix every group
    member still has cached; ``recover`` pads the stacked prefix caches
    to the prompt length and extends over the suffix (the prefill kernel
    with queries at the suffix positions); ``store`` keeps each agent's
    full dense cache for the next round, in storage of its own. A hybrid
    model is refused (``requires_attention_cache``): ``extend`` carries
    attention KV only. An attention-free model (Mamba2) is served as JAX
    serves it: its rounds leave no attention KV, so ``store`` keeps no
    session and every round recomputes."""

    requires_attention_cache = True

    def plan(self, ctx: RoundContext) -> RecoveryPlan:
        if ctx.round_idx == 0:
            return RecoveryPlan(kind="recompute", ctx=ctx)
        plens = []
        for i, aid in enumerate(ctx.agent_ids):
            self.rt.manager.ensure_resident(f"sess:{aid}")
            s = self.rt.sessions[aid]
            if s.prompt_tokens is None or s.dense_k is None:
                plens.append(0)
            else:
                plens.append(min(_common_prefix(ctx.tokens[i],
                                                s.prompt_tokens),
                                 s.dense_k.shape[1]))
        p = min(plens)  # equal-length sessions give equal p; be safe
        if p == 0:
            return RecoveryPlan(kind="recompute", ctx=ctx)
        return RecoveryPlan(kind="extend", ctx=ctx, prefix_len=p)

    def recover(self, plan: RecoveryPlan,
                tokens: torch.Tensor) -> RecoveryResult:
        if plan.kind == "recompute":
            return self._recover_recompute(tokens)
        rt, p = self.rt, plan.prefix_len
        aids = plan.ctx.agent_ids
        N, S = tokens.shape
        kpre = torch.stack([rt.sessions[a].dense_k[:, :p] for a in aids],
                           dim=1)
        vpre = torch.stack([rt.sessions[a].dense_v[:, :p] for a in aids],
                           dim=1)

        def run(toks, kp, vp):
            # a fresh padded cache each call: extend writes rows p..S-1
            # of it in place, never a session's tensors
            pad = (0, 0, 0, 0, 0, S - p)
            cache = {"k": F.pad(kp, pad), "v": F.pad(vp, pad),
                     "length": torch.full((N,), p, dtype=torch.int32,
                                          device=toks.device)}
            logits, cache = extend(rt.params, rt.cfg, toks[:, p:], cache)
            return logits[:, -1], {"k": cache["k"], "v": cache["v"]}

        (logits, cache), dt = rt.timed(("extend", N, S, p), run, tokens,
                                       kpre, vpre)
        return RecoveryResult(logits, cache, dt, {"prefix_len": p})

    def store(self, ctx: RoundContext, cache: dict, outputs: np.ndarray,
              result: RecoveryResult, stats) -> None:
        kv = round_kv(cache)
        if kv is None:
            return
        rt = self.rt
        # dense session caches ARE this policy's storage design, so the
        # full-cache gather (a copy in both cache forms) is intentional
        kc, vc = kv.slice(0, kv.total)          # [L, N, S+G, KV, hd]
        S, G = ctx.prompt_len, rt.gen_len
        for i, a in enumerate(ctx.agent_ids):
            s = rt.sessions[a]
            # a storage of its own per session: a view would keep the
            # whole round tensor alive, and a spill would free nothing
            s.dense_k = kc[:, i].clone()
            s.dense_v = vc[:, i].clone()
            s.prompt_tokens = np.concatenate(
                [np.asarray(ctx.layouts[i].tokens), outputs[i]])
            rt.manager.free(f"sess:{a}")
            rt.manager.alloc_tokens(f"sess:{a}", S + G, persistent=True,
                                    spillable=_session_spillable(s))
