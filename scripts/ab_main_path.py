"""Run ``chip_smoke.py``'s main path — the kernel build, then Qwen2.5-7B
served by ``ServingEngine`` + ``TokenDancePolicy`` on the 8-agent,
3-round trace — and its ``[hybrid]`` phase (Hymba-1.5B on the same
trace) from several checkouts in turn on one card, and print each run's
per-round recover, restore, decode and store ms, serve seconds and peak
device memory (its ``[main]`` lines), the ``[dense]`` loop's decode ms per
round, and the hybrid rounds' recover and decode ms and serve seconds as
one JSON line.

Each run also times every attention call of the main path's served trace
with CUDA events (``ops.flash_attention`` wrapped; one event pair a call,
no synchronisation on the served path): ``recover_attn_ms`` is the sum
over the timed recovery of each round (its last 28 calls; the first 28
are the untimed warm-up of the round's new shape), split into the fresh
layers' calls (``_fresh_ms``) and the selective layers' (``_sel_ms``).
It saves the main path's greedy tokens, first-token logits and each
round's ledgers (the policy's reuse record: restore, pool and compression
counts, and the persistent bytes) to ``build/ab_main_outputs.npz`` in its
checkout; at the end, every other checkout's tokens, logits and ledgers
are compared with the first one's (tokens that differ, with the first
root's top-2 logit margin where the first token of a row differs, the
largest first-token logit difference, and whether the ledgers are equal).

    python3 scripts/ab_main_path.py PARENT . . PARENT

Each argument is the root of a checkout that holds ``chip_smoke.py``
(with ``build()``, ``main_path(dev)`` and ``hybrid(dev)``); each run is a
process of its own. Give the runs in turns (A B B A) so that drift of the
card shows.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

CODE = r"""
import json, sys, numpy as np, torch
sys.path.insert(0, '.')
import chip_smoke as c
from repro_torch.kernels import ops
from repro_torch.serving import ServingEngine
calls, served = [], []
attention = ops.flash_attention
def timed_attention(q, k, *a, **kw):
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = attention(q, k, *a, **kw)
    e.record()
    calls.append((len(served), q.shape[1] == k.shape[1], s, e))
    return out
ops.flash_attention = timed_attention
serve = ServingEngine.serve
def serving(self, *a, **kw):
    stats = serve(self, *a, **kw)
    served.append(stats)
    return stats
ServingEngine.serve = serving
dev = torch.device('cuda')
c.build()
c.main_path(dev)
torch.cuda.synchronize()
main = [x for x in calls if x[0] == 0]
L = 28
assert len(main) == 2 * L * len(served[0]), len(main)
attn = {'recover_attn_ms': [], 'recover_attn_fresh_ms': [],
        'recover_attn_sel_ms': []}
for r in range(len(served[0])):
    timed = main[(2 * r + 1) * L:(2 * r + 2) * L]
    ms = [(fresh, s.elapsed_time(e)) for _, fresh, s, e in timed]
    attn['recover_attn_ms'].append(sum(t for _, t in ms))
    attn['recover_attn_fresh_ms'].append(sum(t for f, t in ms if f))
    attn['recover_attn_sel_ms'].append(sum(t for f, t in ms if not f))
ledgers = json.dumps([{'reuse': st.reuse, 'persistent': st.persistent_bytes}
                      for st in served[0]], sort_keys=True, default=str)
np.savez('build/ab_main_outputs.npz',
         outputs=np.stack([st.outputs for st in served[0]]),
         first_logits=np.stack([st.first_logits for st in served[0]]),
         ledgers=np.array(ledgers))
print('[attn] ' + json.dumps(attn), flush=True)
ops.flash_attention = attention
c.hybrid(dev)
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root,
                         capture_output=True, text=True, timeout=900)
    text = out.stdout
    if out.returncode != 0:
        raise RuntimeError(f"{root}: rc {out.returncode}\n{text[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    main = "\n".join(line for line in text.splitlines()
                     if line.startswith("[main]"))
    hyb = "\n".join(line for line in text.splitlines()
                    if line.startswith("[hybrid]"))
    dense = "\n".join(line for line in text.splitlines()
                      if line.startswith("[dense]"))
    attn = json.loads(re.search(r"^\[attn\] (.*)$", text, re.M).group(1))
    return {"root": root,
            "recover_ms": [float(x) for x in
                           re.findall(r"\(recover ([0-9.]+)", main)],
            **attn,
            "restore_ms": [float(x) for x in
                           re.findall(r"restore ([0-9.]+), decode", main)],
            "decode_ms": [float(x) for x in
                          re.findall(r"decode ([0-9.]+), store", main)],
            "store_ms": [float(x) for x in
                         re.findall(r"store ([0-9.]+)\)", main)],
            "serve_s": float(re.search(r"serve ([0-9.]+) s", main).group(1)),
            "peak_gib": float(re.search(r"peak device memory ([0-9.]+) GiB",
                                        main).group(1)),
            "dense_decode_ms": [float(x) for x in
                                re.findall(r"decode ([0-9.]+), store",
                                           dense)],
            "hybrid_recover_ms": [float(x) for x in
                                  re.findall(r"\(recover ([0-9.]+)", hyb)],
            "hybrid_decode_ms": [float(x) for x in
                                 re.findall(r"decode ([0-9.]+), store", hyb)],
            "hybrid_serve_s": float(re.search(r"serve ([0-9.]+) s",
                                              hyb).group(1))}


def compare(base: str, other: str) -> dict:
    """Greedy tokens and first-token logits of ``other``'s main path
    against ``base``'s, per round."""
    a = np.load(Path(base) / "build" / "ab_main_outputs.npz")
    b = np.load(Path(other) / "build" / "ab_main_outputs.npz")
    rounds = []
    for r in range(len(a["outputs"])):
        ta, tb = a["outputs"][r], b["outputs"][r]
        la, lb = a["first_logits"][r], b["first_logits"][r]
        diff = np.argwhere(ta != tb)
        flips = []
        for row, pos in diff[:16].tolist():
            flip = {"row": row, "token": pos}
            if pos == 0:
                top2 = np.sort(la[row])[-2:]
                flip["margin"] = float(top2[1] - top2[0])
            flips.append(flip)
        rounds.append({"tokens_equal": bool(not len(diff)),
                       "tokens_differ": int(len(diff)), "flips": flips,
                       "first_logits_max_abs_diff":
                           float(np.abs(la - lb).max())})
    ledgers = ("ledgers" in a and "ledgers" in b
               and str(a["ledgers"]) == str(b["ledgers"]))
    return {"base": base, "other": other, "rounds": rounds,
            "ledgers_equal": ledgers}


def main() -> int:
    roots = sys.argv[1:]
    for root in roots:
        print(json.dumps(run(root)), flush=True)
    for other in dict.fromkeys(roots[1:]):
        if other != roots[0]:
            print(json.dumps(compare(roots[0], other)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
