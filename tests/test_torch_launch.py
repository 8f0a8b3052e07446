"""The port's ``launch/`` against the JAX package's: twins of the seven
``tests/test_sharding.py`` tests.

The rules are compared field by field with JAX's ``rules_for`` on the
same abstract meshes (the production 16x16 and 2x16x16, no devices): the
sanitized spec of every parameter leaf of all 12 configs at published
widths (JAX's shapes from ``jax.eval_shape``, the port's from fake
tensors), every activation tag, and the placements each spec gives
(local shapes and, for a tuple entry, JAX's major-to-minor offsets).
The sharded forward runs on a one-rank gloo mesh in this process and on
a (1, 2) gloo mesh of two spawned CPU processes, where the GQA slicing
shows; it is held to the unsharded forward with JAX's tolerance (atol
1e-5, ``test_sharded_forward_matches_unsharded``) and, on one rank, to
JAX's ``forward`` on the same weights (1e-4, ``tests/test_torch_forward``).
The dry-run's 256-rank fake group runs in a subprocess, so no other test
of a worker sees a default process group.
"""
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    _compute_local_shape_and_global_offset

from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.configs import get_smoke_config as jget_smoke_config
from repro.configs import list_archs
from repro.launch import roofline as jroofline
from repro.launch.sharding import rules_for as jrules_for
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init
from repro_torch.configs import INPUT_SHAPES, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.sharding import (P, AbstractMesh, distribute_params,
                                         rules_for)
from repro_torch.models import forward, from_jax, init_params
from test_torch_forward import _random_norms

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TAGS = ("act_resid", "act_heads", "act_kv_heads", "act_ffn", "logits",
        "moe_dispatch", "moe_ffn", "cache_kv", "no_such_tag")


def _meshes(name):
    shape, names = MESHES[name]
    return (jax.sharding.AbstractMesh(shape, names),
            AbstractMesh(shape, names))


def _jax_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_jax_leaves(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _rules_fields(r):
    return (r.batch_axes, r.fsdp_axis, r.seq_shard, r.seq_parallel,
            r.expert_parallel, r.model_size)


# ---------------------------------------------------------------- rules
@pytest.mark.parametrize("mesh", list(MESHES))
def test_rules_batch_axes_per_shape(mesh):
    jm, tm = _meshes(mesh)
    for arch in list_archs():
        for shape in INPUT_SHAPES:
            j = jrules_for(jget_config(arch), JSHAPES[shape], jm)
            t = rules_for(get_config(arch), INPUT_SHAPES[shape], tm)
            assert _rules_fields(t) == _rules_fields(j), (arch, shape)
    t = rules_for(get_config("qwen2-72b"), INPUT_SHAPES["long_500k"], tm)
    assert t.seq_shard and t.batch_axes == ()


@pytest.mark.parametrize("mesh", ["debug", *MESHES])
def test_expert_parallel_selection(mesh):
    if mesh == "debug":
        jm = jax.sharding.AbstractMesh((1, 1), ("data", "model"))
        tm = AbstractMesh((1, 1), ("data", "model"))
    else:
        jm, tm = _meshes(mesh)
    for arch in list_archs():
        j = jrules_for(jget_config(arch), JSHAPES["train_4k"], jm)
        t = rules_for(get_config(arch), INPUT_SHAPES["train_4k"], tm)
        assert (t.expert_parallel, t.model_size) == (j.expert_parallel,
                                                     j.model_size), arch
    if mesh == "16x16":     # grok's 8 experts on 16: tensor parallel
        t = rules_for(get_config("grok-1-314b"), INPUT_SHAPES["train_4k"], tm)
        assert not t.expert_parallel


def _check_placements(tm, spec, shape, pl):
    """``pl`` lays each dim out as ``spec`` says: the local shape divides
    the dim by the product of its entry's axes, and a tuple entry's
    offsets follow JAX's major-to-minor order, at every coordinate."""
    sizes = dict(zip(tm.mesh_dim_names, tm.shape))
    names = tm.mesh_dim_names
    for i, p in enumerate(pl):
        entry = spec[p.dim] if isinstance(p, Shard) else None
        axes = entry if isinstance(entry, tuple) else (entry,)
        assert (names[i] in axes) == isinstance(p, Shard), (spec, pl)
    for coord in np.ndindex(*tm.shape):
        local, offset = _compute_local_shape_and_global_offset(
            shape, tm.shape, list(coord), pl)
        for d, entry in enumerate(spec):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n, idx = 1, 0
            for a in axes:
                idx = idx * sizes[a] + coord[names.index(a)]
                n *= sizes[a]
            assert local[d] == shape[d] // n, (spec, shape, pl)
            assert offset[d] == idx * local[d], (spec, coord, pl)
        if not any(isinstance(e, tuple) for e in spec):
            break       # one coordinate checks the shapes; tuples need all


@pytest.mark.parametrize("arch", list_archs())
def test_param_shardings_cover_tree(arch):
    """Every leaf at published widths: the sanitized spec equals JAX's on
    both production meshes, the tree and shapes equal JAX's, and the
    placements follow the spec; every activation tag's spec equals
    JAX's."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    jparams = _jax_leaves(jax.eval_shape(
        lambda: jax_init(jax.random.PRNGKey(0), jcfg)))
    with FakeTensorMode():
        tparams = init_params(tcfg, 0, device="cpu")
    tleaves = _jax_leaves(tparams)
    assert sorted(tleaves) == sorted(jparams)
    for mesh in MESHES:
        jm, tm = _meshes(mesh)
        for shape in ("train_4k", "long_500k"):
            jr = jrules_for(jcfg, JSHAPES[shape], jm)
            tr = rules_for(tcfg, INPUT_SHAPES[shape], tm)
            shardings = tr.params_shardings(tparams)
            opt = tr.opt_shardings(shardings)
            assert opt.m is shardings and opt.v is shardings
            assert opt.step == (Replicate(),) * len(tm.shape)
            for path, jleaf in jparams.items():
                leaf = tleaves[path]
                assert tuple(leaf.shape) == tuple(jleaf.shape), path
                name = "/".join(path)
                js = jr.sanitize(jr.param_spec(name, jleaf), jleaf.shape)
                ts = tr.sanitize(tr.param_spec(name, leaf), leaf.shape)
                assert tuple(ts) == tuple(js), (mesh, name, ts, js)
                pl = shardings
                for k in path:
                    pl = pl[k]
                assert pl == tr.placements(ts)
                _check_placements(tm, ts, tuple(leaf.shape), pl)
            for tag in TAGS:
                for nd in (3, 4, 5):
                    assert tr.act_spec(tag, nd) == jr.act_spec(tag, nd), tag
            kv = (jcfg.n_layers, 4, 4096, 8, 128)
            spec = tr.sanitize(P(*tr.act_spec("cache_kv", 5)), kv)
            assert tuple(spec) == tuple(
                jr.sanitize(jax.sharding.PartitionSpec(
                    *jr.act_spec("cache_kv", 5)), kv))
            if shape == "long_500k" and mesh == "16x16" and arch == "qwen3-4b":
                # the sequence split over (data, model): JAX's order
                _check_placements(tm, spec, kv, tr.placements(spec))


# ------------------------------------------------------- sharded forward
def _tokens(cfg):
    return np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 16),
                                             dtype=np.int32)


def test_sharded_forward_matches_unsharded():
    """One rank in this process (a ``(1, 1)`` gloo mesh): the sharded
    forward equals the unsharded one and JAX's on the same weights; the
    attention ran on local shards, through the plain version."""
    jcfg = jget_smoke_config("qwen3-4b").replace(dtype="float32")
    tcfg = get_smoke_config("qwen3-4b").replace(dtype="float32")
    jparams = _random_norms(jax_init(jax.random.PRNGKey(0), jcfg), seed=1)
    params = from_jax(jparams, tcfg, device="cpu")
    toks = _tokens(tcfg)
    ref, _ = forward(params, tcfg, torch.from_numpy(toks))
    jref, _ = jax_forward(jax.tree.map(jax.numpy.asarray, jparams), jcfg,
                          jax.numpy.asarray(toks))
    try:
        mesh = make_debug_mesh(device_type="cpu")
        rules = rules_for(tcfg, INPUT_SHAPES["train_4k"], mesh)
        ops.reset_launches()
        out, _ = forward(distribute_params(params, rules), tcfg,
                         torch.from_numpy(toks), shard=rules.shard)
        assert ops.PLAIN_CALLS["flash_prefill"] == tcfg.n_layers
        out = out.full_tensor()
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), atol=1e-4,
                               rtol=0)


#: (n_heads, n_kv_heads) on a 2-way model axis: whole KV groups a rank
#: (h = 2 of G = 2), one group's part a rank (h = 2 of G = 4), and
#: neither dividing the other (h = 6, G = 4: q's heads gathered)
GQA = ((4, 2), (4, 1), (12, 3))


def _two_ranks(rank, path):
    from repro_torch.training import AdamWConfig, init_adamw, make_train_step
    from repro_torch.training.optimizer import tree_leaves

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                            world_size=2)
    try:
        mesh = make_debug_mesh(device_type="cpu")
        assert tuple(mesh.shape) == (1, 2)
        for H, KV in GQA:
            cfg = get_smoke_config("qwen3-4b").replace(
                dtype="float32", n_heads=H, n_kv_heads=KV)
            params = init_params(cfg, 0, device="cpu")
            toks = torch.from_numpy(_tokens(cfg))
            ref, _ = forward(params, cfg, toks)
            rules = rules_for(cfg, INPUT_SHAPES["train_4k"], mesh)
            sharded = distribute_params(params, rules)
            out, _ = forward(sharded, cfg, toks, shard=rules.shard)
            assert out.to_local().shape[-1] == cfg.vocab_size // 2
            np.testing.assert_allclose(out.full_tensor().numpy(),
                                       ref.numpy(), atol=1e-5, rtol=0)
            # one training step: the same loss, and each leaf after AdamW
            # within the f32 tolerance of the training tests
            opt = AdamWConfig(warmup_steps=1)
            mask = torch.ones(toks.shape)
            sharded, _, ms = make_train_step(cfg, opt, shard=rules.shard)(
                sharded, init_adamw(sharded), toks, mask)
            params, _, m = make_train_step(cfg, opt)(
                params, init_adamw(params), toks, mask)
            assert abs(float(ms["loss"]) - float(m["loss"])) < 1e-5
            assert abs(float(ms["grad_norm"]) - float(m["grad_norm"])) < 1e-4
            for (path, a), (_, b) in zip(tree_leaves(sharded),
                                         tree_leaves(params)):
                np.testing.assert_allclose(a.full_tensor().numpy(),
                                           b.numpy(), atol=1e-4, rtol=0,
                                           err_msg=str(path))
        # the recorder on one real redistribute: a [4, 6] f32 all-gather
        rules = rules_for(cfg, INPUT_SHAPES["train_4k"], mesh)
        x = torch.arange(24, dtype=torch.float32).view(4, 6)
        from repro_torch.launch.sharding import distribute
        xd = distribute(x, mesh, (Replicate(), Shard(1)))
        rec = roofline.Recorder()
        with rec:
            full = xd.redistribute(placements=[Replicate(), Replicate()])
        assert torch.equal(full.to_local(), x)
        got = roofline.collective_bytes(rec.collectives)
        assert got["all-gather"] == 4 * 6 * 4, rec.collectives
        assert sum(got.values()) == got["all-gather"]
    finally:
        dist.destroy_process_group()


def test_sharded_forward_two_ranks(tmp_path):
    """Two spawned CPU processes on a (1, 2) gloo mesh: heads, vocab and
    d_ff split over ``model``; the forward within 1e-5 of the unsharded
    one at three GQA layouts, one training step equal to the unsharded
    step, and the recorder on a real all-gather."""
    mp.start_processes(_two_ranks, args=(str(tmp_path / "store"),),
                       nprocs=2, start_method="spawn")


# ------------------------------------------------------------ roofline
def test_collective_bytes_parser():
    """The same four sums from a record equal to JAX's HLO snippet."""
    hlo = """
  %all-reduce.1 = f32[16,1024]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[512,128]{1,0} all-gather(%y), dimensions={0}
  %tup = (f32[8,4]{1,0}, f32[8,4]{1,0}) all-to-all(%a, %b)
  %not_a_collective = f32[4,4]{1,0} add(%p, %q)
"""
    record = [("all-reduce", torch.float32, (16, 1024)),
              ("all-gather", torch.bfloat16, (512, 128)),
              ("all-to-all", torch.float32, (8, 4)),
              ("all-to-all", torch.float32, (8, 4))]
    out = roofline.collective_bytes(record)
    assert out == jroofline.collective_bytes(hlo)
    assert out["all-reduce"] == 16 * 1024 * 4
    assert out["all-gather"] == 512 * 128 * 2
    assert out["all-to-all"] == 2 * 8 * 4 * 4
    assert out["reduce-scatter"] == 0
    assert set(roofline.COLLECTIVE_KINDS.values()) < set(out)


@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_scale(arch):
    """``model_flops_for`` equals JAX's exactly at every input shape; the
    ratios JAX's test pins hold."""
    for shape in INPUT_SHAPES:
        assert roofline.model_flops_for(get_config(arch),
                                        INPUT_SHAPES[shape]) == \
            jroofline.model_flops_for(jget_config(arch), JSHAPES[shape])
    cfg = get_config(arch)
    tr = roofline.model_flops_for(cfg, INPUT_SHAPES["train_4k"])
    pf = roofline.model_flops_for(cfg, INPUT_SHAPES["prefill_32k"])
    dc = roofline.model_flops_for(cfg, INPUT_SHAPES["decode_32k"])
    assert tr / pf == pytest.approx(3.0, rel=1e-6)
    assert dc < pf / 100
    if cfg.is_moe:
        assert cfg.active_param_count() < cfg.param_count()


def test_dryrun_one_combination(tmp_path):
    """The dry-run in its own process (a 256-rank fake group) at published
    widths: qwen3-4b's prefill records ``ok`` with per-device FLOPs near
    the model's share (every rank holds 1/256 of the work), positive
    memory and collective bytes, the attention's mode and what its bytes
    count in its notes."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                    "--arch", "qwen3-4b", "--shape", "prefill_32k",
                    "--mesh", "single", "--out", str(tmp_path)],
                   check=True, env=env, capture_output=True, timeout=600)
    with open(tmp_path / "qwen3-4b__prefill_32k__pod16x16.json") as f:
        r = json.load(f)
    assert r["status"] == "ok", r.get("error")
    assert r["peak_device_bytes"] > 0 and r["coll_bytes"] > 0
    assert r["n_chips"] == 256 and "stand-in" in r["notes"]
    assert "eager program" in r["notes"]
    # the model's 2ND over 256 ranks is most of each rank's FLOPs; the
    # rest is causal attention at 32k (model FLOPs count none of it)
    assert 0.3 < r["useful_ratio"] <= 1.0, r["useful_ratio"]


def test_dryrun_results_if_present():
    """Validate any dry-run records produced so far (the sweep runs through
    ``python -m repro_torch.launch.dryrun``; this keeps the schema
    honest)."""
    recs = glob.glob(os.path.join(ROOT, "experiments/dryrun_torch/*.json"))
    if not recs:
        pytest.skip("no dry-run records yet")
    for path in recs:
        with open(path) as f:
            r = json.load(f)
        assert r["status"] in ("ok", "error"), path
        if r["status"] == "ok":
            assert r["peak_device_bytes"] > 0
            if "hlo_flops" in r:
                assert r["hlo_flops"] > 0
                assert r["bottleneck"] in ("compute", "memory", "collective")
