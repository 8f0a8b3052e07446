"""Readings that set a cell's limits: the program's numbers and the
control's, on many seeds in one process.

    python3 tdbench/control.py --workload <cell> --seeds 11,12,13

For each seed: the weights, one episode of the program at the cell's own
shapes (the warm-up is one more episode), and the reference replaying it
twice: in float8 e4m3 (the control: the nearest precision below the
model's bf16, following the program's selection and putting its own
token first at every served position) and in float32, which judges both
the program's served tokens and the control's tokens. One JSON line a
seed: ``gap_max`` and ``sel_rel`` of the program and of the control. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell: str, seed: int, device=None, config=None, traffic=None):
    import torch

    from tdbench import check, episode
    from tdbench.run import manifest_cell
    from tdbench.traffic import Traffic, make_episode
    from tdbench.weights import load_config, make_weights, program_params, \
        sizes

    spec = manifest_cell(cell)
    dev = torch.device(device or "cuda")
    c = config or load_config(spec["config"])
    s = sizes(c)
    cfg = episode.model_config(c)
    traffic = traffic or Traffic.load(spec["traffic"])
    clock = episode.Clock(dev)
    w = make_weights(s, seed, dev)
    params = program_params(w)
    for e_idx in (-1, 0):
        recs = episode.run_episode(params, cfg, traffic,
                                   make_episode(traffic, s["V"], seed, e_idx),
                                   e_idx, clock)
    del params
    ctl = check.reference_numbers(w, s, traffic, seed, recs, quant="fp8",
                                  keep_argmax=True)
    ref = check.reference_numbers(w, s, traffic, seed, recs,
                                  extra=ctl["argmax"])
    return {"seed": seed, "program": {"gap_max": ref["gap_max"],
                                      "sel_rel": ref["sel_rel"]},
            "control": {"gap_max": float(ref["extra_gaps"].max()),
                        "sel_rel": ctl["sel_rel"]},
            "tokens": int(ref["gaps"].size)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(x) for x in a.seeds.split(",")):
        t0 = time.perf_counter()
        out = readings(a.workload, seed)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
