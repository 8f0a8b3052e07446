"""``tdbench/spanview.py``: a CPU rehearsal of the episode loop with the
port's spans on, read into the per-layer quantities; and its profile logic
on synthetic events, beside ``tdbench.trace.summarize`` with and without
the program's span names."""
import math
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from repro_torch import spans
from tdbench import episode, spanview
from tdbench.trace import summarize
from tdbench.traffic import Traffic, make_episode
from tdbench.weights import make_weights, program_params, sizes

CFG = {"name": "tiny", "source": "test", "hidden_size": 128,
       "intermediate_size": 256, "num_attention_heads": 4,
       "num_hidden_layers": 2, "num_key_value_heads": 2, "vocab_size": 1024,
       "rope_theta": 1e6, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
       "torch_dtype": "bfloat16"}
TRAFFIC = Traffic("tiny", {32: 2, 64: 2}, 8, 32, 3)


@pytest.fixture(scope="module")
def rehearsal():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s = sizes(CFG)
        cfg = episode.model_config(CFG)
        params = program_params(make_weights(s, 2**31 + 5, "cpu"))
        clock = episode.Clock(torch.device("cpu"))
        hooks = spanview.SpanHooks()
        recs = []
        for e in range(2):
            recs += episode.run_episode(
                params, cfg, TRAFFIC, make_episode(TRAFFIC, s["V"], 7, e), e,
                clock, hooks=hooks)
        return hooks.traced(recs)
    finally:
        torch.set_num_threads(n)
        spans.stop()


def test_rehearsal_reads_the_five_span_quantities(rehearsal):
    assert len(rehearsal) == 2 * TRAFFIC.rounds
    for name in ("recover_warm_ms", "recover_fresh_ms",
                 "recover_recompute_ms", "decode_gap_p95_ms",
                 "cast_gib_per_token"):
        v = getattr(spanview, name)(rehearsal)
        assert v is not None and math.isfinite(v) and v > 0, name
    # 2 batches a round, G - 1 steps each
    assert len(spanview.decode_gaps_ms(rehearsal)) == (
        2 * TRAFFIC.rounds * 2 * (TRAFFIC.gen_len - 1))


def test_rehearsal_spans_cover_rounds_and_first_tokens(rehearsal):
    for t in rehearsal:
        (cov,) = spanview.coverage(t.spans)
        assert 0.9 < cov <= 1.0
        got = spanview.ttft_from_spans(t.spans)
        assert len(got) == len(t.rec.batches) == 2
        for ms, b in zip(got, t.rec.batches):
            assert 0.75 < ms / b.ttft_ms <= 1.0 + 1e-9


def test_warm_run_once_a_new_shape_of_an_engine(rehearsal):
    """A batch whose (kind, N, S, selected rows) an episode's engine has not
    run yet runs once untimed: its warm-up span holds stages of its own,
    outside the timed run's. Round 2's first batch has round 1's second
    batch's shape."""
    seen = set()
    for t in rehearsal:
        if t.rec.r == 0:
            seen = set()
        new = 0
        for b in t.rec.batches:
            key = (t.rec.r > 0, len(b.aids), b.S, b.n_sel)
            new += key not in seen
            seen.add(key)
        names = [s.name for s in t.spans]
        assert names.count("policy.recover.warm") == new
        fresh = [s for s in t.spans if s.name == "pic.fresh"]
        warm = spanview._warm_ids(t.spans)
        assert len(fresh) == (len(t.rec.batches) + new if t.rec.r else 0)
        assert sum(s.id in warm for s in fresh) == (new if t.rec.r else 0)
    assert [t.rec.r for t in rehearsal if sum(
        s.name == "policy.recover.warm" for s in t.spans) == 1] == [2, 2]


# ---- the profile logic on synthetic events ---------------------------------
class Ev:
    def __init__(self, name, t0, t1, cpu=True, corr=0, linked=0):
        self.n, self.t0, self.t1 = name, t0, t1
        self.cpu, self.corr, self.linked = cpu, corr, linked

    def name(self):
        return self.n

    def start_ns(self):
        return self.t0

    def duration_ns(self):
        return self.t1 - self.t0

    def device_type(self):
        return DeviceType.CPU if self.cpu else DeviceType.CUDA

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.linked


def prof_of(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


BENCH = {"round", "plan", "recover", "decode", "store",
         "ops.flash_decode_paged"}
# one round: the benchmark's decode range around the program's decode span
# and two step spans; the kernel wrapper's range launches one kernel
# (linked), and the port's paged decode kernel runs unlinked
BASE = [Ev("round", 0, 1000), Ev("decode", 100, 900),
        Ev("gemm0", 60, 80, cpu=False),
        Ev("ops.flash_decode_paged", 250, 300),
        Ev("cudaLaunchKernel", 260, 270, corr=1),
        Ev("k_linked", 300, 450, cpu=False, linked=1),
        Ev("flash_decode_paged_kernel", 550, 600, cpu=False),
        Ev("gemm", 650, 700, cpu=False)]
PROGRAM = [Ev("engine.decode", 120, 880), Ev("engine.decode.step", 200, 400),
           Ev("engine.decode.step", 500, 700),
           # the profiler's copies of the program's ranges on the device
           Ev("engine.decode", 300, 700, cpu=False),
           Ev("engine.decode.step", 300, 450, cpu=False),
           Ev("engine.decode.step", 550, 700, cpu=False)]


def test_program_names_leave_the_benchmark_fields_as_they_were():
    names = BENCH | set(spans.NAMES)
    plain = summarize(prof_of(BASE), BENCH)
    traced = summarize(prof_of(BASE + PROGRAM), names)
    for k in ("window_s", "busy_s", "unlinked_device_s",
              "unlinked_by_kernel"):
        assert traced[k] == plain[k], k
    assert traced["range_device_s"]["ops.flash_decode_paged"] == \
        plain["range_device_s"]["ops.flash_decode_paged"] == 150 / 1e9
    assert plain["busy_s"] == 270 / 1e9
    # the device copies of the program's ranges are not kernels
    assert all(n not in spans.NAMES for n, _ in traced["device_ops"])
    # without the program's names the copies would count as device work
    assert summarize(prof_of(BASE + PROGRAM), BENCH)["busy_s"] > 270 / 1e9


def test_idle_inside_each_span_name_and_by_innermost_range():
    names = BENCH | set(spans.NAMES)
    view = spanview.idle_view(*spanview.profile_events(
        prof_of(BASE + PROGRAM), names))
    assert view["window_s"] == pytest.approx(1000e-9)
    assert view["busy_s"] == pytest.approx(270e-9)
    # engine.decode 120..880 holds busy 300..450, 550..600 and 650..700
    assert view["inside"]["engine.decode"] == pytest.approx(
        [510e-9, 760e-9])
    # the steps 200..400 and 500..700: busy 300..400, 550..600, 650..700
    assert view["inside"]["engine.decode.step"] == pytest.approx(
        [200e-9, 400e-9])
    assert view["inside"]["decode"] == pytest.approx([550e-9, 800e-9])
    assert view["inside"]["round"] == pytest.approx([730e-9, 1000e-9])
    # each gap goes to the innermost range open at its middle: 0..60 to
    # the round alone, 80..300 and 700..1000 to engine.decode, 450..550
    # and 600..650 to a step
    assert view["by_range"] == pytest.approx({
        "round": 60e-9, "engine.decode": 520e-9,
        "engine.decode.step": 150e-9})
    assert spanview.decode_idle_pct(view) == pytest.approx(100 * 510 / 760)
    assert spanview.unattributed_idle_share(view) == pytest.approx(60 / 730)
