"""A CPU rehearsal of a run at a small size: the episode loop, the counts
it prints, the check against the reference, and the faults the check has
to catch. The path that reads device metrics refuses to run without a
card."""
import json

import pytest
import torch

from tdbench import check, run
from tdbench.traffic import Traffic

CFG = {"name": "tiny", "source": "test", "hidden_size": 128,
       "intermediate_size": 256, "num_attention_heads": 4,
       "num_hidden_layers": 2, "num_key_value_heads": 2, "vocab_size": 1024,
       "rope_theta": 1e6, "rms_norm_eps": 1e-6, "tie_word_embeddings": False,
       "torch_dtype": "float32"}
TRAFFIC = Traffic("tiny", {32: 2, 64: 2}, 8, 32, 3)
CELL = "qwen2.5-7b.society-a32"


def limits():
    """The cell's limits, the logit gap scaled to this model's logits: with
    the benchmark's weights a logit's spread is 0.02 sqrt(hidden size)."""
    from tdbench.weights import load_config
    lim = check.load_limits(CELL)
    d = load_config(run.manifest_cell(CELL)["config"])["hidden_size"]
    lim["gap_max"] *= (CFG["hidden_size"] / d) ** 0.5
    return lim


def rehearse(seed=2**31 + 99):
    return run.run_cell(CELL, seed, 0.0, False, device="cpu", config=CFG,
                        traffic=TRAFFIC, limits=limits())


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_rehearsal_counts_and_check(capsys):
    out = rehearse()
    err = capsys.readouterr().err
    assert "[window] 1 episodes, 3 rounds, 12 agent-requests" in err
    assert out["correct"] and out["attempted"] == 12 and out["failed"] == 0
    assert out["check"]["gap_max"]["value"] < 1e-4
    assert out["check"]["sel_rel"]["value"] == 0.0
    assert list(out)[-1] == "check"
    assert out["metrics"]["tokens_per_s"]["value"] > 0
    json.dumps(out)


def test_device_path_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2
    cap = capsys.readouterr()
    assert cap.out == "" and "CUDA device" in cap.err


def _stale_step(real):
    """A decode step that returns its state unchanged."""
    def step(params, cfg, tok, cache, **kw):
        logits, _ = real(params, cfg, tok, {k: v.clone() if hasattr(v, "clone")
                                            else v for k, v in cache.items()},
                         **kw)
        return logits, cache
    return step


def _half_batch(real):
    """Each decode step's logits of the second half of the batch replaced
    by the mean over the first half."""
    def step(params, cfg, tok, cache, **kw):
        logits, cache = real(params, cfg, tok, cache, **kw)
        n = logits.shape[0]
        if n > 1:
            logits[n // 2:] = logits[: n // 2].mean(0)
        return logits, cache
    return step


def _altered_token(real):
    """One generated token altered where the decode loop produces it."""
    def advance(self, st):
        real(self, st)
        if st.t == 3:
            st.tok = (st.tok + 1) % self.cfg.vocab_size
            st.outs[-1] = st.tok
    return advance


@pytest.mark.parametrize("fault", ["stale_step", "half_batch",
                                   "altered_token"])
def test_faults_fail_the_check(fault, monkeypatch):
    from repro_torch.serving import engine
    if fault == "stale_step":
        monkeypatch.setattr(engine, "decode_step_paged",
                            _stale_step(engine.decode_step_paged))
    elif fault == "half_batch":
        monkeypatch.setattr(engine, "decode_step_paged",
                            _half_batch(engine.decode_step_paged))
    else:
        monkeypatch.setattr(engine.ServingEngine, "_decode_advance",
                            _altered_token(engine.ServingEngine._decode_advance))
    assert rehearse()["correct"] is False


def test_selected_rows_match_the_programs_count():
    """The FLOP count's selected rows, and the reference's block count,
    against the program's own ``n_sel`` (``RoundStats.reuse``)."""
    import numpy as np

    from tdbench import episode, flops
    from tdbench.reference.tokendance import n_sel_blocks
    from tdbench.traffic import make_episode
    from tdbench.weights import make_weights, program_params, sizes

    s = sizes(CFG)
    cfg = episode.model_config(CFG)
    w = make_weights(s, 5, torch.device("cpu"))
    ep = make_episode(TRAFFIC, s["V"], 5, 0)
    recs = episode.run_episode(program_params(w), cfg, TRAFFIC, ep, 0,
                               episode.Clock(torch.device("cpu")))
    n_agents = len(ep.agent_ids)
    for rr in recs[1:]:
        for b in rr.batches:
            n_cached = b.S - 32             # the task block is fresh
            fresh = np.r_[np.zeros(n_cached, bool), np.ones(32, bool)]
            assert b.S % 32 == 0
            assert b.n_sel == 32 * n_sel_blocks(fresh, 32, 0.15)
            assert all(len(b.sel[a]) == b.n_sel for a in b.aids)
            assert rr.n_agents == n_agents
            full = flops.batch_flops(s, len(b.aids), b.S, rr.G)
            part = flops.batch_flops(s, len(b.aids), b.S, rr.G,
                                     [b.sel[a] for a in b.aids])
            # two layers, both fresh (check layer 1): the whole count
            assert part == full
