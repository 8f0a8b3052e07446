"""Multi-pod dry-run: trace every (architecture x input shape x mesh)
combination on the production mesh at published widths, with nothing
allocated, and record its roofline terms — the JAX package's
``repro.launch.dryrun`` on PyTorch.

JAX compiles each step on 512 placeholder host devices and reads XLA's
cost and memory analyses. Here the process joins a ``"fake"`` process
group of 256 (or 512) ranks as rank 0 (it runs as its own process, as
JAX's does: the group is the process's default group), places every
parameter, moment, input and cache as a DTensor of fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage) by
``launch.sharding``, and runs the step eagerly under a
``roofline.Recorder``, which counts rank 0's local ops: FLOPs, bytes,
collectives, live memory. Eager execution runs every layer, so JAX's two
cost probes (2 and 4 layers, extrapolated) are not needed: one full-depth
trace gives both the peak and the costs.

Attention: the card never materialises the S x S scores, so the trace
does not run the plain version (whose scores would sit in the peak).
``ops.flash_attention`` is routed, for the trace only, to a stand-in
custom op with the kernel's output shape, the kernel's causal FLOPs
(every allowed (query, key) pair: 2 products of 2·hd FLOPs forward, 8 in
the backward kernel) and, as an op, the kernel's input and output bytes.
The decode step's single-query attention runs its plain version on
DTensors (its scores are one row a head). Each record says so in
``notes``.

Step functions and inputs are JAX's: train is loss, grad and AdamW
(moments sharded like their parameters; ``remat=True``, so its FLOPs
include each layer's recomputed forward, where JAX's cost probe has no
remat); prefill returns the last position's logits; decode is one token
per sequence over a cache of ``seq_len``; the stubbed frontends take
``FRONTEND_FRAMES`` embeddings. ``VARIANTS`` keeps JAX's: the ``rules``
overrides reach ``rules_for``; of the ``cfg`` overrides, ``xent_chunk``
chunks the port's loss as JAX's, while ``attn_impl``/``attn_chunk`` name
JAX's attention implementations and change nothing here (the port's
attention is always the flash kernel).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--mesh single|multi|both]
Results land in experiments/dryrun_torch/<arch>__<shape>__<mesh>.json
(resumable; --force re-runs; --out DIR writes elsewhere).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      get_config, list_archs)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Recorder, build_report
from repro_torch.launch.sharding import (ShardingRules, distribute,
                                         distribute_params, rules_for)

RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    "../../../experiments/dryrun_torch")
FRONTEND_FRAMES = 256   # stubbed modality frontends emit this many embeddings

ASSIGNED_ARCHS = [a for a in list_archs() if not a.startswith("qwen2.5")]

TRACE_NOTE = ("attention: a stand-in op with the flash kernel's output "
              "shape, causal FLOPs and in/out bytes (no S x S scores in "
              "the peak); bytes: the inputs and outputs of every local op, "
              "as an eager program moves them (no fusion)")


# ------------------------------------------------------------------ kernels
def attention_pairs(Sq: int, Sk: int, window: int) -> int:
    """Allowed (query, key) pairs of one head of one sequence. Sq == Sk is
    self-attention from position 0 (query i reads keys (i - window, i]);
    otherwise the queries' positions are data (a selective recompute),
    and every query counts ``min(Sk, window)`` keys, the most it reads."""
    w = min(window, Sk)
    if Sq != Sk:
        return Sq * w
    return w * (w + 1) // 2 + (Sq - w) * w


@torch.library.custom_op("repro_torch_dryrun::flash_attention",
                         mutates_args=())
def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, window: int,
               softcap: float) -> torch.Tensor:
    raise RuntimeError("the attention stand-in traces fake tensors only")


@_attention.register_fake
def _(q, k, v, q_pos, window, softcap):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch_dryrun::flash_attention_bwd",
                         mutates_args=())
def _attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, dout: torch.Tensor,
                   q_pos: torch.Tensor, window: int,
                   softcap: float) -> tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    raise RuntimeError("the attention stand-in traces fake tensors only")


@_attention_bwd.register_fake
def _(q, k, v, out, dout, q_pos, window, softcap):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _setup(ctx, inputs, output):
    q, k, v, q_pos, window, softcap = inputs
    ctx.save_for_backward(q, k, v, output, q_pos)
    ctx.window, ctx.softcap = window, softcap


def _backward(ctx, dout):
    q, k, v, out, q_pos = ctx.saved_tensors
    dq, dk, dv = _attention_bwd(q, k, v, out, dout, q_pos, ctx.window,
                                ctx.softcap)
    return dq, dk, dv, None, None, None


_attention.register_autograd(_backward, setup_context=_setup)


def _attention_flops(products: int):
    def formula(q, k, *args, out_val=None, **kwargs):
        B, Sq, H, hd = q.shape
        window = args[-2] if len(args) >= 2 else kwargs["window"]
        return products * 2 * hd * B * H * attention_pairs(Sq, k.shape[1],
                                                           window)
    return formula


#: the stand-ins' FLOPs: 2 products (S = QK^T, PV) forward; the backward
#: kernel's 8 (its LSE sweep, S, dP, dQ; then S^T, dP^T, dV, dK)
STANDIN_FLOPS = {
    torch.ops.repro_torch_dryrun.flash_attention: _attention_flops(2),
    torch.ops.repro_torch_dryrun.flash_attention_bwd: _attention_flops(8),
}


def _standin_attention(q, k, v, *, q_pos, window, kv_len=None,
                       softcap=0.0):
    if kv_len is not None:
        raise NotImplementedError("the stand-in has no kv_len")
    return _attention(q, k, v, q_pos, int(min(window, 2 ** 31 - 1)),
                      float(softcap))


@contextlib.contextmanager
def kernel_standins():
    """Within the ``with``, ``ops.flash_attention`` calls the stand-in op
    (for a trace of fake tensors; the model reaches it through
    ``layers.attention``, on local shards)."""
    real = ops.flash_attention
    ops.flash_attention = _standin_attention
    try:
        yield
    finally:
        ops.flash_attention = real


# ------------------------------------------------------------------- steps
def input_specs(cfg: ModelConfig, shape: InputShape, rules: ShardingRules):
    """Fake DTensor stand-ins for every model input (call under a
    ``FakeTensorMode``), placed by ``rules``."""
    from repro_torch.models import init_params, make_empty_cache
    from repro_torch.models.transformer import dtype_of
    from repro_torch.training.optimizer import init_adamw

    B, S = shape.global_batch, shape.seq_len
    mesh = rules.mesh
    params = distribute_params(init_params(cfg, 0, device="cpu"), rules)
    out = {"params": params}
    if shape.kind == "train":
        out["opt"] = init_adamw(params)
        out["tokens"] = distribute(torch.zeros((B, S), dtype=torch.int32),
                                   mesh, rules.tokens_sharding())
        out["mask"] = distribute(torch.zeros((B, S)), mesh,
                                 rules.tokens_sharding())
    elif shape.kind == "prefill":
        out["tokens"] = distribute(torch.zeros((B, S), dtype=torch.int32),
                                   mesh, rules.tokens_sharding())
    else:  # decode: ONE new token against a cache of seq_len
        cache = make_empty_cache(cfg, B, S, device="cpu")
        sh = rules.cache_shardings(cache)
        out["cache"] = {k: distribute(v, mesh, sh[k])
                        for k, v in cache.items()}
        out["token"] = distribute(torch.zeros((B,), dtype=torch.int32), mesh,
                                  rules.token_sharding_1d())
    if cfg.frontend != "none" and shape.kind in ("train", "prefill"):
        out["frontend_embeds"] = distribute(
            torch.zeros((B, FRONTEND_FRAMES, cfg.d_model),
                        dtype=dtype_of(cfg)),
            mesh, rules.placements_for((B, FRONTEND_FRAMES, cfg.d_model),
                                       rules.batch_axes, None, None))
    return out


def run_step(cfg: ModelConfig, shape: InputShape, rules: ShardingRules,
             specs: dict):
    """Run the step of ``shape.kind`` on ``specs``; returns its outputs
    (kept alive until the caller drops them, as a step's results are)."""
    from repro_torch.models import decode_step, prefill
    from repro_torch.training import AdamWConfig, adamw_update
    from repro_torch.training.train_loop import value_and_grad

    long_ctx = shape.name == "long_500k"
    fe = specs.get("frontend_embeds")
    if shape.kind == "train":
        loss, parts, grads = value_and_grad(
            specs["params"], cfg, specs["tokens"], specs["mask"],
            shard=rules.shard, remat=True, frontend_embeds=fe)
        params, opt, om = adamw_update(AdamWConfig(), specs["params"],
                                       grads, specs["opt"])
        return params, opt, {"loss": loss, **parts, **om}
    with torch.no_grad():
        if shape.kind == "prefill":
            return prefill(specs["params"], cfg, specs["tokens"],
                           max_len=shape.seq_len, shard=rules.shard,
                           long_context=long_ctx, logits_last_only=True,
                           frontend_embeds=fe)
        return decode_step(specs["params"], cfg, specs["token"],
                           specs["cache"], shard=rules.shard,
                           long_context=long_ctx)


def trace(cfg: ModelConfig, shape: InputShape, mesh, rule_overrides=None):
    """One traced step: (its Recorder, trace notes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rules = rules_for(cfg, shape, mesh, **(rule_overrides or {}))
    with FakeTensorMode(allow_non_fake_inputs=True):
        specs = input_specs(cfg, shape, rules)
        gc.collect()
        rec = Recorder(STANDIN_FLOPS)
        rec.track(specs)
        with kernel_standins(), rec:
            out = run_step(cfg, shape, rules, specs)
            del out
    notes = [TRACE_NOTE]
    if shape.kind == "train":
        notes.append("train: remat on, FLOPs include each layer's "
                     "recomputed forward")
    if shape.kind == "decode":
        notes.append("decode attention: the plain version on DTensors")
    return rec, "; ".join(notes)


# perf variants (the JAX module's): config/sharding overrides applied on
# top of the paper-faithful baseline; results saved under a __<variant>
# suffix. "cfg" entries go through ModelConfig.replace, "rules" through
# rules_for(**overrides).
VARIANTS = {
    "baseline": {},
    "chunked_attn": {"cfg": {"attn_impl": "chunked", "attn_chunk": 1024}},
    "chunked_all": {"cfg": {"attn_impl": "chunked", "attn_chunk": 1024,
                            "xent_chunk": 512}},
    "decode_seqshard": {"rules": {"batch_axes": (), "seq_shard": True}},
    "decode_seqshard_chunked": {
        "cfg": {"attn_impl": "chunked", "attn_chunk": 2048},
        "rules": {"batch_axes": (), "seq_shard": True}},
    "seqpar_chunked": {
        "cfg": {"attn_impl": "chunked", "attn_chunk": 1024},
        "rules": {"seq_parallel": True}},
    "seqpar_chunked_all": {
        "cfg": {"attn_impl": "chunked", "attn_chunk": 1024,
                "xent_chunk": 512},
        "rules": {"seq_parallel": True}},
}


def join_fake_group(world: int) -> None:
    """Make the process's default group a ``"fake"`` group of ``world``
    ranks (this process is rank 0), replacing one of another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def run_combo(arch: str, shape_name: str, multi_pod: bool,
              force: bool = False, save: bool = True,
              cost_probe: bool = True, variant: str = "baseline",
              results_dir: str = RESULTS_DIR) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    suffix = "" if variant == "baseline" else f"__{variant}"
    out_path = os.path.join(
        results_dir, f"{arch}__{shape_name}__{mesh_name}{suffix}.json")
    if save and not force and os.path.exists(out_path):
        with open(out_path) as f:
            rec = json.load(f)
            if rec.get("status") == "ok":
                return rec

    vspec = VARIANTS[variant]
    cfg = get_config(arch).replace(**vspec.get("cfg", {}))
    shape = INPUT_SHAPES[shape_name]
    record = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "variant": variant, "status": "error"}
    t0 = time.time()
    try:
        join_fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        rec, notes = trace(cfg, shape, mesh, vspec.get("rules", {}))
        record["memory_analysis"] = {
            "argument": rec.argument_size_in_bytes,
            "output": rec.output_size_in_bytes,
            "temp": rec.temp_size_in_bytes,
            "alias": rec.alias_size_in_bytes,
        }
        record["peak_device_bytes"] = rec.peak
        if cost_probe:
            rep = build_report(cfg, shape, mesh_name, mesh.size(),
                               {"flops": rec.flops,
                                "bytes accessed": rec.bytes},
                               rec.collectives, rec, notes=notes)
            record.update(dataclasses.asdict(rep))
        else:
            record["notes"] = notes
        record.update({"status": "ok",
                       "t_total_s": round(time.time() - t0, 1)})
    except Exception as e:  # recorded, surfaced, fixed — not swallowed
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    gc.collect()
    if save:
        os.makedirs(results_dir, exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(record, f, indent=1, default=str)
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--no-cost-probe", action="store_true",
                    help="trace proof + memory only")
    ap.add_argument("--variant", default="baseline", choices=list(VARIANTS))
    ap.add_argument("--out", default=RESULTS_DIR,
                    help="directory for the records")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else ASSIGNED_ARCHS
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    try:
        for mp in meshes:
            for arch in archs:
                for shape in shapes:
                    # roofline table is single-pod; multi-pod proves the
                    # pod axis
                    rec = run_combo(
                        arch, shape, mp, force=args.force,
                        cost_probe=not mp and not args.no_cost_probe,
                        variant=args.variant, results_dir=args.out)
                    tag = (f"{arch:16s} {shape:12s} "
                           f"{'2x16x16' if mp else '16x16 '}")
                    if rec["status"] == "ok":
                        extra = ""
                        if "hlo_flops" in rec:
                            extra = (f" flops/dev={rec['hlo_flops']:.3e}"
                                     f" coll={rec['coll_bytes']:.3e}B"
                                     f" bn={rec['bottleneck']}")
                        print(f"OK   {tag} peak/dev="
                              f"{rec['peak_device_bytes']/2**30:.2f}GiB"
                              f"{extra} t={rec['t_total_s']}s", flush=True)
                    else:
                        failures += 1
                        err = rec["error"].splitlines()[0][:160]
                        print(f"FAIL {tag} {err}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        raise SystemExit(f"{failures} combos failed")


if __name__ == "__main__":
    main()
