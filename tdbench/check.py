"""What decides ``correct``: one episode of the window, drawn from the
seed, replayed by the plain reference (``tdbench.reference``) in float32
with TF32 off, judging every token the program served in it.

Numbers compared, each against its limit in ``limits/<cell>.json``:

* ``gap_max``: the widest gap, over every served token of the episode,
  by which its logit lies below the reference's best logit at that
  position. It covers round 0's prefill and decode, and from round 1 the
  restored history, the shared blocks' rotation, the fresh layers, the
  selective recompute and the paged decode.
* ``sel_rel``: the reference follows the program's block selection and
  scores it against its own (see the reference); 0 where they agree.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from tdbench.reference.tokendance import Model, simulate
from tdbench.traffic import make_episode

ROOT = Path(__file__).resolve().parent
NUMBERS = ("gap_max", "sel_rel")


def load_limits(cell: str) -> dict:
    spec = json.loads((ROOT / "limits" / f"{cell}.json").read_text())
    return {k: float(spec[k]["limit"]) for k in NUMBERS}


def pick_episode(episodes, rounds: int, seed: int):
    done = [e for e in episodes if len(e) == rounds]
    rng = np.random.default_rng([seed % (1 << 64), 7919])
    return done[int(rng.integers(len(done)))]


def given_selection(recs):
    """Per round, the program's selected positions by agent (round 0:
    nothing is selected)."""
    out = []
    for rr in recs:
        sel = {}
        for b in rr.batches:
            if b.sel is not None:
                sel.update(b.sel)
        out.append(sel or None)
    return out


def reference_numbers(w: dict, s: dict, traffic, seed: int, recs,
                      quant=None, extra=None, keep_argmax=False) -> dict:
    """Replay the episode of ``recs`` (its rounds' records) in the
    reference. Returns the simulation's result with ``gap_max`` and
    ``sel_rel``."""
    ep = make_episode(traffic, s["V"], seed, recs[0].ep)
    outputs = [rr.outputs for rr in recs]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            res = simulate(Model(w, s, quant), ep, outputs,
                           given_selection(recs), extra=extra,
                           keep_argmax=keep_argmax)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    res["gap_max"] = float(res["gaps"].max())
    res["sel_rel"] = float(res["sel_rel"].max()) if res["sel_rel"].size \
        else 0.0
    return res
