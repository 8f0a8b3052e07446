"""The port's spans and counters (``repro_torch.spans``) on a tiny bf16
Qwen2.5-7B (the smoke widths) served by ``ServingEngine`` with the
TokenDance policy on the CPU: the span tree and request ids, the decode
steps, the recovery's five stages under its timed and warm-up runs, the
phase timers as span durations, the weight-cast counter against its closed
form, and tracing off."""
import re
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.core.rounds import SubsetGather, generate_trace
from repro_torch.models import init_params
from repro_torch.serving import ServingEngine

G = 32
STAGES = ["pic.align", "pic.fresh", "pic.select", "pic.recompute",
          "pic.logits"]
SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def serve(cfg, params, trace, traced, **kw):
    """An engine over ``trace``; each round's (stats, spans, counters),
    drained after the round."""
    eng = ServingEngine(params, cfg, gen_len=G, keep_logits=True, **kw)
    eng.init_agents(trace)
    out = []
    for rnd in trace.rounds:
        if traced:
            spans.start()
        try:
            stats = eng.run_round(rnd)
        finally:
            spans.stop()
        done, counters = spans.drain()
        out.append((stats, done, counters))
    return eng, out


@pytest.fixture(scope="module")
def model():
    cfg = get_smoke_config("qwen2.5-7b")
    assert cfg.dtype == "bfloat16" and not cfg.tie_embeddings
    return cfg, init_params(cfg, 0, device="cpu")


def _trace(cfg, n_agents=3):
    return generate_trace("generative_agents", n_agents, 3, cfg.vocab_size,
                          seed=11, jitter_hist=False)


@pytest.fixture(scope="module")
def traced(model):
    torch.set_num_threads(2)
    return serve(*model, _trace(model[0]), True)


@pytest.fixture(scope="module")
def untraced(model):
    torch.set_num_threads(2)
    return serve(*model, _trace(model[0]), False)


def children(done, parent):
    return sorted((s for s in done if s.parent == parent.id),
                  key=lambda s: s.t0)


def only(done, name):
    found = [s for s in done if s.name == name]
    assert len(found) == 1, (name, found)
    return found[0]


def test_span_tree_and_request_ids(traced):
    eng, rounds = traced
    for r, (stats, done, _) in enumerate(rounds):
        root = only(done, "engine.round")
        assert root.parent is None and root.request == (eng.serial, r, None)
        (batch,) = children(done, root)
        assert batch.name == "engine.batch"
        assert batch.attrs == {"gid": "g0", "N": 3, "S": stats.prompt_len}
        want = ["policy.plan", "policy.recover.warm", "policy.recover",
                "engine.decode", "policy.store"]
        assert [s.name for s in children(done, batch)] == want
        plan = only(done, "policy.plan")
        assert [s.name for s in children(done, plan)] == (
            ["policy.restore"] if r else [])
        for s in done:
            if s is not root:
                assert s.request == (eng.serial, r, "g0"), s
            assert root.t0 <= s.t0 <= s.t1 <= root.t1
        assert len({s.id for s in done}) == len(done)


def test_one_span_a_decode_step(traced):
    for _, done, _ in traced[1]:
        dec = only(done, "engine.decode")
        kids = children(done, dec)
        assert [s.name for s in kids] == (["engine.decode.begin"]
                                          + ["engine.decode.step"] * (G - 1)
                                          + ["engine.decode.finish"])
        assert [s.attrs["t"] for s in kids[1:-1]] == list(range(G - 1))
        for s in kids[1:-1]:           # the CPU has no events: host time
            assert s.device_s == s.host_s > 0


def test_recovery_stages_under_timed_and_warm_runs(traced):
    for r, (_, done, _) in enumerate(traced[1]):
        for name in ("policy.recover", "policy.recover.warm"):
            kids = children(done, only(done, name))
            assert [s.name for s in kids] == (STAGES if r else [])
            for a, b in zip(kids, kids[1:]):
                assert a.t1 <= b.t0


def test_warm_run_once_per_new_shape(model):
    """Two committees of two give two batches of one shape a round: the
    first runs the shape's warm-up, the second does not."""
    cfg, params = model
    trace = _trace(cfg, 4)
    eng, rounds = serve(cfg, params, trace, True,
                        topology=SubsetGather.grouped(trace.agent_ids, 2))
    for r, (_, done, _) in enumerate(rounds):
        batches = [s for s in done if s.name == "engine.batch"]
        assert [b.attrs["gid"] for b in batches] == ["g0", "g1"]
        assert len({(b.attrs["N"], b.attrs["S"]) for b in batches}) == 1
        warm = [s for s in done if s.name == "policy.recover.warm"]
        assert len(warm) == 1 and warm[0].request[2] == "g0"
        assert Counter(s.name for s in done)["policy.recover"] == 2
    assert len(eng.rt.warm) == len(rounds)


def test_phase_timers_are_span_durations(traced):
    for stats, done, _ in traced[1]:
        for field, name in (("t_recover", "policy.recover"),
                            ("t_restore", "policy.restore"),
                            ("t_decode", "engine.decode"),
                            ("t_store", "policy.store")):
            total = 0.0
            for s in done:
                if s.name == name:
                    total += s.host_s
            assert getattr(stats, field) == total, field


def _cast_bytes(cfg):
    """Closed form of ``model.cast_bytes`` for one recovery pass (every
    layer in f32 from the embedding on) and one decode step over f32 KV
    (layer 0's q/k/v projections still meet the bf16 embedding; its
    attention output is f32, and so is everything after it). Every norm
    scale is cast to f32 at every use, in round 0 too."""
    D, H, KV, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    L, F, V = cfg.n_layers, cfg.d_ff, cfg.vocab_size
    qkv = D * (H + 2 * KV) * hd
    rest = H * hd * D + 3 * D * F
    norms = (2 * L + 1) * D
    b = 2                                       # bf16 bytes
    recover = b * (L * (qkv + rest) + norms + D * V)
    step = b * ((L - 1) * qkv + L * rest + norms + D * V)
    return b * norms, recover, step


def test_cast_bytes_closed_form(traced, model):
    norms, recover, step = _cast_bytes(model[0])
    for r, (_, done, counters) in enumerate(traced[1]):
        runs = Counter(s.name for s in done)["pic.logits"]
        want = (2 * norms + (G - 1) * norms if r == 0
                else runs * recover + (G - 1) * step)
        assert runs == (2 if r else 0)
        assert counters == {"model.cast_bytes": want}


def test_no_cast_where_dtypes_agree(model):
    cfg = model[0].replace(dtype="float32")
    params = init_params(cfg, 0, device="cpu")
    _, rounds = serve(cfg, params, _trace(cfg), True)
    for _, done, counters in rounds:
        assert done and counters == {}


def test_tracing_off_records_nothing(untraced):
    for stats, done, counters in untraced[1]:
        assert done == [] and counters == {}
        assert stats.t_recover > 0 and stats.t_decode > 0
        assert stats.t_store > 0
    with spans.span("engine.round") as s:
        spans.count("model.cast_bytes", 1)
    assert not isinstance(s, spans.Span)
    assert spans.drain() == ([], {})


def test_outputs_and_logits_bit_equal_on_and_off(traced, untraced):
    for (a, _, _), (b, _, _) in zip(traced[1], untraced[1]):
        np.testing.assert_array_equal(a.outputs, b.outputs)
        np.testing.assert_array_equal(a.first_logits, b.first_logits)


def test_request_id_inherits_down_the_tree():
    spans.start()
    try:
        with spans.span("engine.round", engine=7, round=2):
            with spans.span("engine.batch", gid="g1"):
                with spans.span("policy.plan"):
                    pass
            with spans.span("policy.store", timed=True) as st:
                pass
    finally:
        spans.stop()
    done, _ = spans.drain()
    assert [(s.name, s.request) for s in done] == [
        ("policy.plan", (7, 2, "g1")), ("engine.batch", (7, 2, "g1")),
        ("policy.store", (7, 2, None)), ("engine.round", (7, 2, None))]
    assert done[0].parent == done[1].id and done[1].parent == done[3].id
    assert st.host_s >= 0


def test_every_span_and_counter_name_is_declared():
    """Each ``spans.span`` / ``spans.count`` site of the package names an
    entry of ``spans.NAMES`` / ``spans.COUNTERS``, and each entry has a
    site."""
    found, counted = set(), set()
    for f in SRC.rglob("*.py"):
        text = f.read_text()
        found |= set(re.findall(r'spans\.span\(\s*"([^"]+)"', text))
        counted |= set(re.findall(r'spans\.count\(\s*"([^"]+)"', text))
    assert found == set(spans.NAMES)
    assert counted == set(spans.COUNTERS)


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_duration_is_read_once_and_kept():
    """A span's device duration comes from its two events, read on first
    use (the events are then let go) and the same on every later read."""
    sp = spans.Span("pic.fresh", None, {})
    sp.t0, sp.t1 = 0, 1_000_000                  # 1 ms on the host
    sp._events = (_Event(2.0), _Event(7.5))
    assert sp.device_s == sp.device_s == 5.5e-3
    assert sp._events is None and sp.host_s == 1e-3


@pytest.mark.gpu
def test_device_span_times_the_stream():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events)")
    dev = torch.device("cuda")
    x = torch.randn(4096, 4096, device=dev)
    torch.cuda.synchronize()
    spans.start()
    try:
        with spans.span("pic.fresh", dev):
            for _ in range(20):
                x = x @ x / 64
    finally:
        spans.stop()
    (s,), _ = spans.drain()
    # the host returns before the device; the events are read once
    assert s.host_s < s.device_s == s.device_s
