"""Dry-run of the paper's core operation itself: collective KV cache reuse
(``pic_prefill`` over a round's group of agents) traced on the production
mesh at published widths — the JAX package's ``repro.launch.
reuse_dryrun`` on PyTorch, with ``launch.dryrun``'s machinery (a
``"fake"`` group of 256 or 512 ranks, fake DTensors, a
``roofline.Recorder``, the attention stand-in).

JAX's shardings: the group's tokens over the batch axes, the shared
cache's sequence over ``model`` (it is round-global), its source
positions and mask likewise; heads and d_ff over ``model`` by the
rules. The cached keys' RoPE alignment runs ``rope_align``'s plain
version on DTensors.

  PYTHONPATH=src python -m repro_torch.launch.reuse_dryrun \\
      [--arch qwen2.5-14b] [--agents 8] [--seq 32768] [--mesh single]

The record goes to experiments/dryrun_torch/ (``--out`` elsewhere).
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import InputShape, get_config
from repro_torch.launch.dryrun import (RESULTS_DIR, STANDIN_FLOPS,
                                       TRACE_NOTE, join_fake_group,
                                       kernel_standins)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Recorder, build_report
from repro_torch.launch.sharding import (distribute, distribute_params,
                                         rules_for)


def trace_collective_reuse(arch: str, n_agents: int, seq: int,
                           multi_pod: bool, n_sel: int = 4096,
                           check_layer: int = 1):
    """(cfg, shape, mesh, Recorder) of one traced ``pic_prefill``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core.pic import pic_prefill
    from repro_torch.models import init_params
    from repro_torch.models.transformer import dtype_of

    cfg = get_config(arch)
    shape = InputShape(f"reuse_{seq // 1024}k", seq, n_agents, "prefill")
    join_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = rules_for(cfg, shape, mesh)
    L, KV, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = distribute_params(init_params(cfg, 0, device="cpu"), rules)
        shared = rules.placements_for((L, seq, KV, hd), None, "model", None,
                                      None)
        vec = rules.placements_for((seq,), "model")
        tokens = distribute(torch.zeros((n_agents, seq), dtype=torch.int32),
                            mesh, rules.placements_for(
                                (n_agents, seq), rules.batch_axes, None))
        sk = distribute(torch.zeros((L, seq, KV, hd), dtype=dtype_of(cfg)),
                        mesh, shared)
        sv = distribute(torch.zeros((L, seq, KV, hd), dtype=dtype_of(cfg)),
                        mesh, shared)
        src = distribute(torch.zeros((seq,), dtype=torch.int32), mesh, vec)
        mask = distribute(torch.zeros((seq,), dtype=torch.bool), mesh, vec)
        gc.collect()
        rec = Recorder(STANDIN_FLOPS)
        rec.track(params, tokens, sk, sv, src, mask)
        with kernel_standins(), rec, torch.no_grad():
            res = pic_prefill(params, cfg, tokens, sk, sv, src, mask, n_sel,
                              check_layer=check_layer, block_select=32,
                              shard=rules.shard)
            out = (res.recovered_k, res.recovered_v, res.logits, res.sel_idx)
            del res, out
    return cfg, shape, mesh, rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-14b")
    ap.add_argument("--agents", type=int, default=8)
    ap.add_argument("--seq", type=int, default=32768)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--n-sel", type=int, default=4096)
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory for the record")
    args = ap.parse_args()

    mesh_name = "pod2x16x16" if args.mesh == "multi" else "pod16x16"
    out = os.path.join(args.out,
                       f"{args.arch}__reuse{args.agents}x{args.seq//1024}k"
                       f"__{mesh_name}.json")
    rec = {"arch": args.arch, "shape": f"collective_reuse N={args.agents} "
           f"S={args.seq}", "mesh": mesh_name, "status": "error"}
    t0 = time.time()
    try:
        cfg, shape, mesh, r = trace_collective_reuse(
            args.arch, args.agents, args.seq, args.mesh == "multi",
            n_sel=args.n_sel)
        rep = build_report(cfg, shape, mesh_name, mesh.size(),
                           {"flops": r.flops, "bytes accessed": r.bytes},
                           r.collectives, r,
                           notes=f"collective reuse, n_sel={args.n_sel}; "
                           "eager trace of every layer; " + TRACE_NOTE
                           + "; the selective layers' attention counted at "
                           "every query's full window; rope_align: the "
                           "plain version")
        rec.update(dataclasses.asdict(rep))
        rec.update({"status": "ok", "t_total_s": round(time.time() - t0, 1),
                    "peak_device_bytes": r.peak})
        print(f"OK collective reuse {args.arch} N={args.agents} S={args.seq} "
              f"{mesh_name}: peak/dev={rec['peak_device_bytes']/2**30:.2f}GiB "
              f"flops/dev={rec['hlo_flops']:.3e} "
              f"coll={rec['coll_bytes']:.3e}B bn={rec['bottleneck']} "
              f"t={rec['t_total_s']}s")
    except Exception as e:  # recorded, surfaced, fixed — not swallowed
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print("FAIL", rec["error"][:200])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    os.makedirs(args.out, exist_ok=True)
    with open(out, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    if rec["status"] != "ok":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
