"""Continuous serving: break the round barrier with the phase-level work
queue. Committees arrive staggered; while one committee's decode holds
the virtual clock, the others' restores and prefills drain into the
leftover slot budget, so the makespan (in counted model-step slots) lands
below the synchronized round-barrier replay, with outputs bit-exact
against the synchronized ``ServingEngine.serve`` oracle. The port's twin
of ``examples/continuous_serving.py``: the same arguments and printed
lines.

  PYTHONPATH=src python -m repro_torch.examples.continuous_serving \\
      [--agents 6] [--group 2] [--rounds 2] [--gen 32] \\
      [--stagger 0,8,16] [--stream] [--device cpu] [--weights params.npz]

``--stream`` prints each token the tick it becomes observable. Weights
and device as in ``multi_agent_serving``.
"""
import argparse

import numpy as np

from repro_torch.configs import get_smoke_config
from repro_torch.core.rounds import SubsetGather, generate_trace
from repro_torch.examples.multi_agent_serving import (add_device_args,
                                                      load_params)
from repro_torch.serving import ContinuousEngine, ServingEngine, get_policy


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=6)
    ap.add_argument("--group", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--gen", type=int, default=32,
                    help="generated tokens per round (KV-block-aligned)")
    ap.add_argument("--stagger", default="0,8,16",
                    help="comma-separated arrival tick per committee")
    ap.add_argument("--stream", action="store_true",
                    help="print tokens at the tick they are produced")
    add_device_args(ap)
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = load_params(cfg, args)
    aids = [f"agent{i}" for i in range(args.agents)]
    topo = SubsetGather.grouped(aids, args.group)
    stagger = [int(s) for s in args.stagger.split(",")]

    def trace():
        return generate_trace("generative_agents", args.agents, args.rounds,
                              cfg.vocab_size, seed=11, jitter_hist=False)

    # --- synchronized oracle --------------------------------------------
    sync = ServingEngine(params, cfg, get_policy("tokendance"),
                         topology=topo, gen_len=args.gen,
                         recompute_ratio=0.1)
    sync_stats = sync.serve(trace())

    # --- continuous, staggered ------------------------------------------
    on_token = None
    if args.stream:
        def on_token(aid, round_idx, t, token, tick):
            print(f"  tick {tick:4d}: {aid} r{round_idx} "
                  f"token[{t}] = {token}")
    cont = ContinuousEngine(params, cfg, "tokendance", topology=topo,
                            gen_len=args.gen, recompute_ratio=0.1)
    res = cont.serve(trace(), stagger=stagger, on_token=on_token)

    # --- parity + makespan ----------------------------------------------
    per_agent = {a: [] for a in aids}
    for s in sync_stats:
        admitted = s.admission["admitted"] if s.admission else aids
        for i, a in enumerate(admitted):
            per_agent[a].append(s.outputs[i])
    exact = all(np.array_equal(x, y)
                for a in aids
                for x, y in zip(res.outputs[a], per_agent[a]))
    print(f"committees: {len(topo.gather_groups(aids))}  "
          f"stagger: {stagger}  slots/step: {cont.scheduler.slots}")
    print(f"outputs bit-exact vs synchronized oracle: {exact}")
    print(f"makespan: continuous {res.makespan_steps} steps vs "
          f"synchronized {res.sync_makespan_steps} "
          f"({res.sync_makespan_steps / res.makespan_steps:.2f}x), "
          f"overlap {res.overlap_steps} steps, "
          f"{res.restore_overlap_events} restores/prefills under decode")
    assert exact and res.makespan_steps < res.sync_makespan_steps


if __name__ == "__main__":
    main()
