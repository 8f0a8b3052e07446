"""The frozen generator: deterministic from the seed, and the batch
structure the same for every seed."""
import numpy as np
import pytest

from tdbench.traffic import ROOT, Traffic, make_episode

TRAFFIC = sorted(p.stem for p in (ROOT / "traffic").glob("*.json"))


def _shape(ep):
    return [len(ep.histories[a]) for a in ep.agent_ids], [
        [len(t[a]) for a in ep.agent_ids] for t in ep.tasks]


@pytest.mark.parametrize("name", TRAFFIC)
def test_same_seed_same_episode(name):
    t = Traffic.load(name)
    a = make_episode(t, 1000, 2**31 + 17, 3)
    b = make_episode(t, 1000, 2**31 + 17, 3)
    assert a.agent_ids == b.agent_ids
    for x in a.agent_ids:
        assert np.array_equal(a.histories[x], b.histories[x])
        for r in range(t.rounds):
            assert np.array_equal(a.tasks[r][x], b.tasks[r][x])
    c = make_episode(t, 1000, 2**31 + 18, 3)
    assert any(not np.array_equal(a.histories[x], c.histories[x])
               for x in a.agent_ids)


@pytest.mark.parametrize("name", TRAFFIC)
def test_batch_structure_does_not_depend_on_seed(name):
    t = Traffic.load(name)
    shapes = {str(_shape(make_episode(t, 1000, seed, e)))
              for seed in (0, 5, 2**40 + 3, -7) for e in (-1, 0, 4)}
    assert len(shapes) == 1
    hist, _ = _shape(make_episode(t, 1000, 1, 0))
    assert sorted(hist) == hist          # batches in one order
    assert {h: hist.count(h) for h in hist} == t.histories
    assert all(h % 32 == 0 for h in hist)   # whole blocks
    ep = make_episode(t, 1000, 9, 0)
    toks = np.concatenate([ep.histories[a] for a in ep.agent_ids])
    assert toks.max() < 999                 # the pad id is never drawn
