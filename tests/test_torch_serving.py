"""The slice end to end: the port's ``ServingEngine`` with
``TokenDancePolicy(incremental=False)`` against the JAX engine with the
same policy, on the same weights and trace (smoke qwen2.5-7b in f32, 3
agents, 3 rounds, seed 11, gen 32, recompute_ratio 0.1)."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.rounds import generate_trace
from repro.models import init_params as jax_init
from repro.serving import ServingEngine, TokenDancePolicy
from repro_torch.configs import get_smoke_config as torch_smoke
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.models import from_jax, init_params
from repro_torch.serving import ServingEngine as TorchEngine
from repro_torch.serving import TokenDancePolicy as TorchTokenDance

torch.set_num_threads(1)

N_AGENTS, N_ROUNDS, GEN = 3, 3, 32
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def served():
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    params = jax_init(jax.random.PRNGKey(0), cfg)
    tcfg = torch_smoke("qwen2.5-7b").replace(dtype="float32")
    tparams = from_jax(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    kw = dict(gen_len=GEN, recompute_ratio=0.1, keep_logits=True)
    jeng = ServingEngine(params, cfg, TokenDancePolicy(incremental=False),
                         **kw)
    js = jeng.serve(generate_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                   cfg.vocab_size, seed=11,
                                   jitter_hist=False))
    teng = TorchEngine(tparams, tcfg, TorchTokenDance(), **kw)
    ts = teng.serve(torch_trace("generative_agents", N_AGENTS, N_ROUNDS,
                                tcfg.vocab_size, seed=11, jitter_hist=False))
    return jeng, js, teng, ts


def test_outputs_equal_jax_every_round(served):
    _, js, _, ts = served
    assert len(js) == len(ts) == N_ROUNDS
    for r in range(N_ROUNDS):
        np.testing.assert_array_equal(ts[r].outputs, js[r].outputs)


def test_first_token_logits_close(served):
    """atol 2e-4: XLA and torch sum the same f32 products in another order
    over 4 layers (the port's attention is a different kernel form, too);
    the greedy tokens above are equal."""
    _, js, _, ts = served
    for r in range(N_ROUNDS):
        np.testing.assert_allclose(ts[r].first_logits, js[r].first_logits,
                                   atol=2e-4, rtol=0)


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return np.asarray(x).tolist()


def test_reuse_and_pool_ledgers_equal(served):
    jeng, js, teng, ts = served
    for r in range(N_ROUNDS):
        want = {k: v for k, v in js[r].reuse.items() if k != "plan"}
        assert _plain(ts[r].reuse) == _plain(want), r
        assert ts[r].persistent_bytes == js[r].persistent_bytes, r
        assert ts[r].transient_peak_bytes == js[r].transient_peak_bytes, r
        assert ts[r].prompt_len == js[r].prompt_len, r
    restore = ts[-1].reuse["restore"]
    assert restore["paged"] and not restore["incremental"]
    assert restore["pool_pages"] <= restore["full_write_pages"]
    assert ts[-1].reuse["pool"]["restore_cache_bytes"] == 0
    assert teng.collector.align_passes == jeng.collector.align_passes


def test_port_imports_no_jax_and_nothing_of_repro():
    code = """
import importlib, pkgutil, sys
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("ok", len([n for n in sys.modules if n.startswith("repro_torch")]))
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_port_source_imports_neither_jax_nor_repro(path):
    """Static check of every import statement, including the ones inside
    functions that the subprocess test above never executes."""
    import ast

    tree = ast.parse((ROOT / path).read_text())
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            mods.append(node.module or "")
    bad = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, (path, bad)


def test_entry_points_need_a_device_when_no_card():
    cfg = torch_smoke("qwen2.5-7b")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, 0)
    with pytest.raises(NotImplementedError):
        TorchTokenDance(incremental=True)
    with pytest.raises(NotImplementedError):
        init_params(cfg.replace(n_experts=4, top_k=2), 0, device="cpu")
