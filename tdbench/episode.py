"""The timed path: one episode of All-Gather rounds through the port's
``ServingEngine`` (TokenDance policy, engine defaults), with the
benchmark's own clocks and named ranges around the program's calls.

TTFT: a CUDA event is recorded at each round's start (the device is idle
there: the previous round ended with the engine's own synchronise, and
the harness waits for the device before the event) and one when the
bound policy's ``recover`` returns a batch's first-token logits. Events
are read after the round, whose end the engine already synchronises, so
the round itself gets no extra synchronise.

With ``ranges`` the calls into each layer run inside
``torch.profiler.record_function`` ranges named ``round``, ``plan``,
``recover``, ``decode``, ``store`` and ``ops.<kernel wrapper>``; the
kernel wrappers also log each call's shapes (:class:`OpLog`) while a
profile is being taken, for the frozen bounds of ``tdbench.flops``.
"""
from __future__ import annotations

import functools
import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.rounds import AllGatherTrace, Round
from repro_torch.kernels import ops
from repro_torch.serving.engine import ServingEngine

from tdbench import flops
from tdbench.traffic import Episode, Traffic

WRAPPED_OPS = ("flash_attention", "flash_decode_paged", "flash_decode",
               "flash_prefill_paged", "rope_align", "block_diff",
               "fused_diff_restore", "fused_family_restore")


def model_config(c: dict) -> ModelConfig:
    """The program's config from a configuration file's published keys.
    Where the program's registry knows the name, its widths must equal
    the file's."""
    from repro_torch.configs.base import ARCH_IDS, get_config
    from tdbench.weights import sizes
    s = sizes(c)
    cfg = ModelConfig(name=c["name"], arch_type="dense", n_layers=s["L"],
                      d_model=s["D"], n_heads=s["H"], n_kv_heads=s["KV"],
                      head_dim=s["hd"], d_ff=s["F"], vocab_size=s["V"],
                      rope_theta=s["theta"], rmsnorm_eps=s["eps"],
                      attn_bias=True,
                      tie_embeddings=bool(c["tie_word_embeddings"]),
                      dtype=c["torch_dtype"], source=c["source"])
    if c["name"] in ARCH_IDS:
        reg = get_config(c["name"])
        widths = ("n_layers", "d_model", "n_heads", "n_kv_heads",
                  "resolved_head_dim", "d_ff", "vocab_size")
        bad = [k for k in widths if getattr(reg, k) != getattr(cfg, k)]
        if bad:
            raise SystemExit(f"config {c['name']}: widths {bad} differ from "
                             f"the program's registry")
    return cfg


def to_trace(ep: Episode, vocab_size: int) -> AllGatherTrace:
    rounds = [Round(r, [], tasks) for r, tasks in enumerate(ep.tasks)]
    return AllGatherTrace("tdbench", list(ep.agent_ids), rounds, vocab_size,
                          ep.sep_id, dict(ep.histories), ep.gen_len)


class Clock:
    """Device timestamps: CUDA events, or the host clock on the CPU
    (rehearsals only)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


@dataclass
class BatchRec:
    aids: List[str]
    S: int
    n_sel: int
    sel: Optional[Dict[str, np.ndarray]]    # the program's selection
    stamp: object = None
    ttft_ms: float = 0.0


@dataclass
class RoundRec:
    ep: int
    r: int
    n_agents: int
    G: int
    t_recover: float
    t_restore: float
    t_decode: float
    t_store: float
    persistent_bytes: int
    transient_peak_bytes: int
    outputs: Dict[str, np.ndarray]
    batches: List[BatchRec]
    wall_s: float
    profiled: bool = False
    flops: int = 0


@dataclass
class OpLog:
    """Shapes of the attention wrappers' calls while ``active``; device
    operands (positions, lengths) are kept and read after the profile."""

    active: bool = False
    calls: List[tuple] = field(default_factory=list)

    def bounds(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, args in self.calls:
            if name == "flash_attention":
                qs, ks, el, q_pos, window, kv_len = args
                pairs = flops.attention_pairs(q_pos, window, ks[1], kv_len)
                b = flops.flash_attention_bound(qs, ks, el, pairs,
                                                kv_len is not None)
            else:
                qs, kv, el, span, window, n_idx = args
                rows = int(torch.clamp(span.long(), max=window).sum())
                b = flops.decode_paged_bound(qs, kv, el, rows, n_idx)
            out[name] = out.get(name, 0.0) + b
        return out


def install_ranges(log: OpLog) -> None:
    """Wrap the port's kernel wrappers (module attributes every call site
    reads) in named ranges, logging the attention calls' shapes."""
    from torch.profiler import record_function

    for name in WRAPPED_OPS:
        fn = getattr(ops, name)
        if getattr(fn, "_tdbench", False):
            continue

        def wrapped(*a, _fn=fn, _name=name, **kw):
            if log.active and _name == "flash_attention":
                q, k = a[0], a[1]
                log.calls.append((_name, (tuple(q.shape), tuple(k.shape),
                                          q.element_size(), kw["q_pos"],
                                          int(kw["window"]),
                                          kw.get("kv_len"))))
            elif log.active and _name == "flash_decode_paged":
                q, pk, page_idx, span = a[0], a[1], a[3], a[4]
                window = kw.get("window", 0) or (1 << 62)
                log.calls.append((_name, (tuple(q.shape), pk.shape[2],
                                          q.element_size(), span, window,
                                          page_idx.numel())))
            with record_function(f"ops.{_name}"):
                return _fn(*a, **kw)

        wrapped._tdbench = True
        setattr(ops, name, functools.wraps(fn)(wrapped))


def _ranged(name: str, fn):
    from torch.profiler import record_function

    def call(*a, **kw):
        with record_function(name):
            return fn(*a, **kw)
    return call


def run_episode(params: dict, cfg: ModelConfig, traffic: Traffic,
                ep: Episode, e_idx: int, clock: Clock, *, ranges=False,
                hooks=None) -> List[RoundRec]:
    """One simulation: a fresh engine, ``traffic.rounds`` rounds. ``hooks``
    (``before(e, r)`` / ``after(e, r)``) start and stop a profile; a
    round inside one is marked ``profiled``."""
    engine = ServingEngine(params, cfg, gen_len=traffic.gen_len)
    engine.init_agents(to_trace(ep, cfg.vocab_size))
    pol = engine.policy
    pending: List[BatchRec] = []
    recover = pol.recover

    def timed_recover(plan, tokens):
        res = recover(plan, tokens)
        stamp = clock.mark()
        p = res.info.get("plan")
        sel = (None if p is None or p.sel_idx_all is None else
               dict(zip(p.request_ids, np.asarray(p.sel_idx_all))))
        pending.append(BatchRec(list(plan.ctx.agent_ids),
                                int(tokens.shape[1]), int(plan.n_sel), sel,
                                stamp))
        return res

    pol.recover = (_ranged("recover", timed_recover) if ranges
                   else timed_recover)
    if ranges:
        pol.plan = _ranged("plan", pol.plan)
        pol.store = _ranged("store", pol.store)
        engine._decode = _ranged("decode", engine._decode)
    trace = to_trace(ep, cfg.vocab_size)
    out = []
    try:
        for r, rnd in enumerate(trace.rounds):
            prof = hooks is not None and hooks.before(e_idx, r)
            clock.sync()
            t0 = time.perf_counter()
            start = clock.mark()
            if ranges:
                from torch.profiler import record_function
                with record_function("round"):
                    stats = engine.run_round(rnd)
            else:
                stats = engine.run_round(rnd)
            wall = time.perf_counter() - t0
            for b in pending:
                b.ttft_ms = clock.ms(start, b.stamp)
                b.stamp = None
            outs = {a: stats.outputs[i]
                    for i, a in enumerate(trace.agent_ids)}
            out.append(RoundRec(e_idx, r, stats.n_agents, traffic.gen_len,
                                stats.t_recover, stats.t_restore,
                                stats.t_decode, stats.t_store,
                                stats.persistent_bytes,
                                stats.transient_peak_bytes, outs,
                                list(pending), wall, bool(prof)))
            pending.clear()
            if hooks is not None:
                hooks.after(e_idx, r)
    finally:
        # the wrappers close over the policy: drop them so the engine's
        # device state is freed with it
        for attr in ("recover", "plan", "store"):
            pol.__dict__.pop(attr, None)
        engine.__dict__.pop("_decode", None)
        del engine, pol, recover
        gc.collect()
    return out
