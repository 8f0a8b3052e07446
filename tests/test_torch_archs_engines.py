"""The serving engine on the last five model families, the port against
the JAX package on their f32 smoke configs, 3 rounds of
``agent_society``: Grok-1 (MoE, logit soft cap 30) under every policy,
Mamba2 through the recompute fallback and under the prefix policy (which
recomputes every round, as in JAX), Arctic, MusicGen and Chameleon with
the defaults. The entry points of the same families are held in
``test_torch_archs.py``; the engines sit in a file of their own so that
the test runner can hand the two to different workers.

Tolerances as ``test_torch_qwen._assert_served_alike``: greedy tokens and
ledgers equal, first-token logits within 2e-4."""
import pytest
import torch

from repro_torch.kernels import ops
from test_torch_qwen import _assert_served_alike, _serve_both

torch.set_num_threads(1)


@pytest.mark.parametrize("policy", [None, "pic", "prefix", "recompute"])
def test_grok_engine_matches_jax(policy):
    """Grok-1 smoke served 3 rounds under each policy: MoE in every
    layer's recovery and decode, the capped attention at every call."""
    jeng, js, teng, ts = _serve_both("grok-1-314b", policy, 3,
                                     workload="agent_society")
    assert teng.policy.name == (policy or "tokendance")
    _assert_served_alike(jeng, js, teng, ts)


@pytest.mark.parametrize("policy", [None, "pic", "recompute"])
def test_mamba2_engine_matches_jax(policy):
    """Mamba2 smoke: TokenDance and PIC fall back to recompute in both
    packages (no attention KV to share), every round recomputes and
    decodes through the dense loop with no attention kernel, and the
    persistent pool stays empty (``round_kv`` gives None)."""
    ops.reset_launches()
    jeng, js, teng, ts = _serve_both("mamba2-2.7b", policy, 3,
                                     workload="agent_society")
    assert jeng.policy.name == teng.policy.name == "recompute"
    assert not any(ops.PLAIN_CALLS.values()), dict(ops.PLAIN_CALLS)
    _assert_served_alike(jeng, js, teng, ts)
    assert all(s.persistent_bytes == 0 for s in ts)


def test_mamba2_prefix_policy_serves_as_jax():
    """The prefix policy on the attention-free model, as JAX serves it:
    constructed under its own name, every round recomputed (no attention
    KV, so no session is stored and no prefix reused), with JAX's tokens,
    reuse ledger and pool bytes (``agent_society``, 3 agents, 3 rounds,
    seed 11); no attention kernel's plain version runs."""
    ops.reset_launches()
    jeng, js, teng, ts = _serve_both("mamba2-2.7b", "prefix", 3,
                                     workload="agent_society")
    assert jeng.policy.name == teng.policy.name == "prefix"
    assert not any(ops.PLAIN_CALLS.values()), dict(ops.PLAIN_CALLS)
    _assert_served_alike(jeng, js, teng, ts)
    assert all(s.persistent_bytes == 0 for s in ts)
    assert all(s.reuse.get("prefix_len", 0) == 0 for s in ts)


@pytest.mark.parametrize("arch", ["arctic-480b", "musicgen-large",
                                  "chameleon-34b"])
def test_default_engine_matches_jax(arch):
    """The default TokenDance engine on token prompts (JAX's engine passes
    no frontend embeddings), round 2 restoring only the delta."""
    jeng, js, teng, ts = _serve_both(arch, None, 3, workload="agent_society")
    assert teng.policy.name == "tokendance"
    _assert_served_alike(jeng, js, teng, ts)
    assert ts[-1].reuse["restore"]["incremental"]
