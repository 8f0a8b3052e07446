"""Run one cell of the benchmark once on this machine's GPU.

    python3 tdbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: the kernels (built on the first run of a checkout, then loaded
from ``build/``), the weights from the seed on the device, the traffic
from the seed, and one whole warm episode at the cell's shapes. The
window then runs whole episodes (fresh engines, rounds back to back: a
closed loop of one simulation at a time) until ``--seconds`` have passed.
``--trace 1`` profiles rounds 1 and 2 of the window's first episode and
reports the per-layer metrics; ``--trace 0`` the end-to-end ones. After
the window the program's state is freed and the reference judges one
episode of it (``tdbench/check.py``). The last line of standard output is
the result as one JSON object; the numbers compared, with their limits,
close standard error.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def manifest_cell(cell: str) -> dict:
    return next((w for w in manifest()["workloads"] if w["name"] == cell),
                {})


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"tdbench.metrics.{name}", HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class RunRecord:
    """What the metric readers see."""

    rounds: list
    traffic: object
    window_s: float
    setup_s: float
    peak_bytes: int
    profile: Optional[dict]
    bounds: dict


class ProfileHooks:
    """Profile rounds 1..2 of the window's first episode."""

    def __init__(self, log_):
        self.log = log_
        self.prof = None

    def before(self, e: int, r: int) -> bool:
        import torch
        from torch.profiler import ProfilerActivity, profile
        if e != 0 or r not in (1, 2):
            return False
        if r == 1:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.__enter__()
            self.log.active = True
        return True

    def after(self, e: int, r: int) -> None:
        import torch
        if e == 0 and r == 2 and self.prof is not None:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.log.active = False
            self.prof.__exit__(None, None, None)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return out.replace("\n", " | ")


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             device=None, config=None, traffic=None, limits=None) -> dict:
    """Set-up, window and check of one cell. ``device`` None: the CUDA
    device, refused when absent; a CPU device, and ``config`` /
    ``traffic`` / ``limits`` in place of the cell's files, are for
    rehearsals at a small size."""
    import numpy as np
    import torch

    from tdbench import check, episode, flops
    from tdbench.traffic import Traffic, make_episode
    from tdbench.weights import load_config, make_weights, program_params, \
        sizes

    bench = manifest()
    spec = manifest_cell(cell)
    dev = torch.device(device or "cuda")
    c = config or load_config(spec["config"])
    s = sizes(c)
    cfg = episode.model_config(c)
    traffic = traffic or Traffic.load(spec["traffic"])
    clock = episode.Clock(dev)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all(("rope_align", "block_diff", "flash_prefill",
                         "flash_decode_paged", "diff_restore"))
    t_built = time.perf_counter()
    w = make_weights(s, seed, dev)
    params = program_params(w)
    clock.sync()
    t_weights = time.perf_counter()
    oplog = episode.OpLog()
    if trace:
        episode.install_ranges(oplog)

    def one(e_idx, hooks=None):
        ep = make_episode(traffic, s["V"], seed, e_idx)
        return episode.run_episode(params, cfg, traffic, ep, e_idx, clock,
                                   ranges=trace, hooks=hooks)

    one(-1)                                    # the warm episode
    clock.sync()
    setup_s = time.perf_counter() - T_START
    log(f"[set-up] to kernels loaded {t_built - T_START:.3f} s, weights "
        f"{t_weights - t_built:.3f} s, warm episode "
        f"{T_START + setup_s - t_weights:.3f} s")
    hooks = ProfileHooks(oplog) if trace else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    episodes: List[list] = []
    t0 = time.perf_counter()
    while True:
        episodes.append(one(len(episodes), hooks))
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    profile = bounds = None
    if trace and hooks.prof is not None:
        from tdbench.trace import summarize
        names = {"round", "plan", "recover", "decode", "store"} | {
            f"ops.{n}" for n in episode.WRAPPED_OPS}
        profile = summarize(hooks.prof, names) or None
        log(f"[trace] {time.perf_counter() - t0 - window_s:.3f} s to read; "
            f"range device s {(profile or {}).get('range_device_s')}; "
            f"unlinked {(profile or {}).get('unlinked_device_s')}")
        bounds = oplog.bounds()
        oplog.calls.clear()
        hooks.prof = None
    rounds = [rr for e in episodes for rr in e]
    for rr in rounds:
        rr.flops = sum(flops.batch_flops(
            s, len(b.aids), b.S, rr.G,
            None if b.sel is None else [b.sel[a] for a in b.aids])
            for b in rr.batches)
    run = RunRecord(rounds, traffic, window_s, setup_s, peak, profile,
                    bounds or {})
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, cell, kind):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = sum(len(b.aids) for rr in rounds for b in rr.batches)
    log(f"[window] {len(episodes)} episodes, {len(rounds)} rounds, "
        f"{attempted} agent-requests (TTFT samples {attempted}), "
        f"{window_s:.3f} s; set-up {setup_s:.3f} s; peak "
        f"{peak / 2**30:.3f} GiB")
    # ---- the check: free the program's state, then the reference -------
    recs = check.pick_episode(episodes, traffic.rounds, seed)
    del episodes, rounds, run, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t1 = time.perf_counter()
    res = check.reference_numbers(w, s, traffic, seed, recs)
    limits = limits or check.load_limits(cell)
    numbers = {k: {"value": res[k], "limit": limits[k]}
               for k in check.NUMBERS}
    correct = all(n["value"] <= n["limit"] for n in numbers.values())
    log(f"[check] episode {recs[0].ep}: {res['gaps'].size} served tokens "
        f"judged, gap p50 {float(np.median(res['gaps'])):.6g}, reference "
        f"{time.perf_counter() - t1:.3f} s")
    out = {"correct": correct, "attempted": attempted, "failed": 0,
           "metrics": metrics,
           "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                      "kind": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if profile:
        out["device"]["busy_s"] = profile["busy_s"]
        out["device"]["window_s"] = profile["window_s"]
        out["breakdown"] = {"device_ops": profile["device_ops"],
                            "idle_gaps": profile["idle_gaps"]}
    out["check"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        log("tdbench: the program (src/repro_torch) is not in this checkout")
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    spec = manifest_cell(a.workload)
    if not spec:
        log(f"tdbench: no cell {a.workload!r} in BENCHMARK.json")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        log(f"tdbench: the cell needs {spec['chips']} CUDA device(s); "
            f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"[device] {torch.cuda.get_device_name(0)}; devices "
        f"{torch.cuda.device_count()}; nvidia-smi: {card_line()}")
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace))
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        log(f"tdbench: loaded {found}: the port must not load JAX or the "
            f"JAX package")
        return 3
    for k, n in out["check"].items():
        log(f"check {k} {n['value']!r} limit {n['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
