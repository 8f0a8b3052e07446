"""SLO admission control on the serving path: measure one calibration
round per policy, feed the measured ``ServiceTimes`` into a
``RoundPlanner``, and serve the trace with per-round admission. The
port's twin of ``examples/slo_admission.py``: the same arguments and
printed lines.

  PYTHONPATH=src python -m repro_torch.examples.slo_admission \\
      [--agents 6] [--rounds 3] [--qps-factor 0.6] [--slo-factor 1.5] \\
      [--device cpu] [--weights params.npz]

The SLO is expressed relative to the measured 2-agent TokenDance round
(hardware-scale-free); lower --slo-factor to watch the planner defer more
agents. Weights and device as in ``multi_agent_serving``.
"""
import argparse

from repro_torch.configs import get_smoke_config
from repro_torch.core.rounds import generate_trace
from repro_torch.examples.multi_agent_serving import (add_device_args,
                                                      load_params)
from repro_torch.serving import (RoundPlanner, ServingEngine, get_policy,
                                 service_times_from_stats)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--policy", default="tokendance")
    ap.add_argument("--qps-factor", type=float, default=0.6,
                    help="offered load as a fraction of measured capacity")
    ap.add_argument("--slo-factor", type=float, default=1.5,
                    help="SLO as a multiple of the calibration round")
    add_device_args(ap)
    args = ap.parse_args()

    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = load_params(cfg, args)
    collective = args.policy in ("recompute", "tokendance")

    # --- calibrate: measure a small round, build the capacity model ------
    cal_n = 2
    cal_trace = generate_trace("generative_agents", cal_n, 2,
                               cfg.vocab_size, seed=3, jitter_hist=False)
    cal = ServingEngine(params, cfg, get_policy(args.policy),
                        gen_len=args.gen, recompute_ratio=0.1)
    cal_stats = cal.serve(cal_trace)[-1]     # steady-state (reuse active)
    st = service_times_from_stats(cal_stats, cal_n, collective=collective)
    measure = lambda n: st                    # flat model; swap in a table
    slo_s = args.slo_factor * cal_stats.t_round
    qps = args.qps_factor * cal_n / cal_stats.t_round
    print(f"calibration: round={cal_stats.t_round*1e3:.0f}ms -> "
          f"SLO={slo_s*1e3:.0f}ms, offered load={qps:.1f} subrequests/s")

    # --- serve with admission -------------------------------------------
    planner = RoundPlanner(measure=measure, qps=qps, slo_s=slo_s,
                           agent_range=range(1, args.agents + 1))
    trace = generate_trace("generative_agents", args.agents, args.rounds,
                           cfg.vocab_size, seed=7, jitter_hist=False)
    eng = ServingEngine(params, cfg, get_policy(args.policy),
                        gen_len=args.gen, recompute_ratio=0.1)
    for s in eng.serve(trace, planner=planner):
        adm = s.admission
        print(f"  round {s.round_idx}: admitted {len(adm['admitted'])}"
              f"/{len(adm['admitted']) + len(adm['deferred'])} "
              f"(SLO cap {adm['max_agents']}) "
              f"round={s.t_round*1e3:6.0f}ms "
              f"deferred={adm['deferred'] or '-'}")


if __name__ == "__main__":
    main()
