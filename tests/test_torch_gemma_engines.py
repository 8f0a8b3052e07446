"""The serving engine on Gemma3, the port against the JAX package on the
f32 smoke configs of ``gemma3-1b`` (4 query heads over 1 KV head) and
``gemma3-12b`` (4 over 2), 3 rounds with the smoke window of 64 binding
on the local layers: the defaults (TokenDance, paged decode, incremental
restore), the prefix policy and the dense decode loop. The entry points
are held in ``test_torch_gemma.py``; the engines sit in a file of their
own so that the test runner can hand the two to different workers.
Tolerances as ``test_torch_qwen._assert_served_alike``."""
import numpy as np
import pytest
import torch

from repro.core.rounds import generate_trace as jax_trace
from repro.serving import ServingEngine as JaxEngine
from repro_torch.core.rounds import generate_trace as torch_trace
from repro_torch.serving import ServingEngine as TorchEngine
from test_torch_gemma import GEMMA
from test_torch_qwen import KW, TRACE, _assert_served_alike, _weights

torch.set_num_threads(1)


def _serve_both(arch, workload, policy=(), **kw):
    cfg, params, tcfg, tparams = _weights(arch)
    jeng = JaxEngine(params, cfg, *policy, **KW, **kw)
    js = jeng.serve(jax_trace(workload, 3, 3, cfg.vocab_size, **TRACE))
    teng = TorchEngine(tparams, tcfg, *policy, **KW, **kw)
    ts = teng.serve(torch_trace(workload, 3, 3, tcfg.vocab_size, **TRACE))
    return jeng, js, teng, ts


@pytest.mark.parametrize("workload", ["generative_agents", "agent_society"])
@pytest.mark.parametrize("arch", GEMMA)
def test_default_engine_matches_jax(arch, workload):
    """TokenDance with paged decode and incremental restore, 3 rounds:
    G 4 over one KV head (1B) and G 2 over 2 (12B), the window binding on
    the local layers from round 0 (prompts of 96 tokens and more)."""
    jeng, js, teng, ts = _serve_both(arch, workload)
    assert teng.policy.name == "tokendance" and teng.policy.incremental
    assert teng.paged_decode
    assert min(s.prompt_len for s in ts) > 64
    _assert_served_alike(jeng, js, teng, ts)
    assert ts[-1].reuse["restore"]["incremental"]


@pytest.mark.parametrize("arch", GEMMA)
def test_prefix_policy_matches_jax(arch):
    """The prefix baseline's ``extend`` under the layers' windows."""
    jeng, js, teng, ts = _serve_both(arch, "agent_society", ("prefix",))
    _assert_served_alike(jeng, js, teng, ts)
    assert all(s.reuse.get("prefix_len", 0) > 0 for s in ts[1:])


def test_dense_decode_loop_matches_jax_and_the_paged_loop():
    """``paged_decode=False`` on gemma3-1b: the dense loop against JAX's
    dense loop, and bit-equal to the port's paged loop (the window is
    applied by both decode kernels' plain versions on the same rows)."""
    jeng, js, teng, ts = _serve_both("gemma3-1b", "generative_agents",
                                     paged_decode=False)
    _assert_served_alike(jeng, js, teng, ts)
    paged = TorchEngine(teng.params, teng.cfg, **KW).serve(torch_trace(
        "generative_agents", 3, 3, teng.cfg.vocab_size, **TRACE))
    for d, p in zip(ts, paged):
        np.testing.assert_array_equal(d.outputs, p.outputs)
        np.testing.assert_array_equal(d.first_logits, p.first_logits)
        assert d.persistent_bytes == p.persistent_bytes
