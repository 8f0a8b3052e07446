"""End-to-end driver (the paper's kind of workload): serve a multi-agent
All-Gather simulation with batched requests, comparing the four reuse
policies — full recompute (vLLM), prefix caching (vLLM+APC), per-request
PIC (CacheBlend) and TokenDance collective reuse + diff storage. The
port's twin of ``examples/multi_agent_serving.py``: the same arguments
and printed lines.

  PYTHONPATH=src python -m repro_torch.examples.multi_agent_serving \\
      [--agents 6] [--rounds 3] [--policies tokendance,pic] \\
      [--topology allgather|grouped:2|ring:1] [--device cpu] \\
      [--weights params.npz]

The smoke Qwen2.5-7B in f32 with random weights from seed 0, or those of
``--weights`` (an npz checkpoint in the JAX package's format, e.g. JAX's
own ``init_params`` written by ``repro.training.checkpoint.save``: with
it the greedy tokens are the JAX example's). Without ``--device`` it runs
on the CUDA device.
"""
import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.core.rounds import AllGather, SubsetGather, generate_trace
from repro_torch.models import init_params
from repro_torch.models.transformer import resolve_device
from repro_torch.serving import MODES, ServingEngine, get_policy
from repro_torch.training.checkpoint import load


def make_topology(spec: str, agent_ids):
    if spec == "allgather":
        return AllGather()
    kind, _, arg = spec.partition(":")
    if kind == "grouped":
        return SubsetGather.grouped(agent_ids, int(arg or 2))
    if kind == "ring":
        return SubsetGather.neighborhood(agent_ids, int(arg or 1))
    raise SystemExit(f"unknown topology {spec!r}")


def load_params(cfg, args):
    """Weights from seed 0 on the device, or ``--weights`` loaded into
    their tree."""
    params = init_params(cfg, 0, device=resolve_device(args.device))
    return load(args.weights, params) if args.weights else params


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--weights", default=None,
                    help="npz checkpoint of the weights (default: random "
                         "from seed 0)")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--workload", default="generative_agents",
                    choices=["generative_agents", "agent_society"])
    ap.add_argument("--policies", "--modes", dest="policies",
                    default=",".join(MODES))
    ap.add_argument("--topology", default="allgather",
                    help="allgather | grouped:<size> | ring:<k>")
    add_device_args(ap)
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = load_params(cfg, args)
    agent_ids = [f"agent{i}" for i in range(args.agents)]
    topology = make_topology(args.topology, agent_ids)

    for name in args.policies.split(","):
        trace = generate_trace(args.workload, args.agents, args.rounds,
                               cfg.vocab_size, seed=7, jitter_hist=False)
        eng = ServingEngine(params, cfg, get_policy(name),
                            topology=topology, gen_len=args.gen,
                            recompute_ratio=0.1)
        print(f"\n== policy={name} agents={args.agents} "
              f"workload={args.workload} topology={args.topology}")
        for s in eng.serve(trace):
            line = (f"  round {s.round_idx}: S={s.prompt_len} "
                    f"recover={s.t_recover*1e3:6.0f}ms "
                    f"restore={s.t_restore*1e3:5.0f}ms "
                    f"decode={s.t_decode*1e3:5.0f}ms "
                    f"persist={s.persistent_bytes/2**20:6.1f}MiB")
            c = s.reuse.get("compression")
            if isinstance(c, list):   # one entry per gather group
                c = c[0]
            if c:
                line += (f"  mirror={c['per_mirror_ratio']:.1f}x "
                         f"({c['avg_changed_blocks']:.0f}/{c['total_blocks']}"
                         " blocks changed)")
            print(line)


if __name__ == "__main__":
    main()
