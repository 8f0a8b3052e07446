"""The port's example twins (``python -m repro_torch.examples.<name>``) run
on the CPU in subprocesses at smoke size, as
``tests/test_torch_hybrid.py`` runs ``quickstart``. The three serving
twins run beside the JAX examples (``examples/*.py``) at the same
arguments, the port on JAX's weights (``--weights``, an npz that JAX's
``checkpoint.save`` writes): each engine's greedy tokens and counted
fields (prompt length, persistent and transient bytes, the reuse ledger)
equal, and the printed lines equal with every time masked. A spy around
the scripts (``SPY``) records what each engine served; the scripts run
unchanged."""
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config
from repro.models import init_params
from repro.training.checkpoint import save

ROOT = Path(__file__).resolve().parents[1]

# Runs a script as __main__ with ServingEngine.serve and
# ContinuousEngine.serve of the given package wrapped, and pickles what
# they served at exit: argv = out, package, module or path, args...
SPY = r"""
import atexit, pickle, runpy, sys
import numpy as np
out, pkg, target = sys.argv[1:4]
sys.argv = [target] + sys.argv[4:]
serving = __import__(pkg + ".serving", fromlist=["ServingEngine"])
records = []

def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items() if k != "plan"}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return np.asarray(x).tolist()

def wrap(cls, keep):
    serve = cls.serve
    def spy(self, *a, **k):
        res = serve(self, *a, **k)
        records.append((cls.__name__, keep(res)))
        return res
    cls.serve = spy

wrap(serving.ServingEngine, lambda stats: [dict(
    round=s.round_idx, outputs=np.asarray(s.outputs), S=s.prompt_len,
    persistent=s.persistent_bytes, transient=s.transient_peak_bytes,
    reuse=plain(s.reuse)) for s in stats])
wrap(serving.ContinuousEngine, lambda res: dict(
    outputs={a: [np.asarray(o) for o in v] for a, v in res.outputs.items()},
    makespan=res.makespan_steps, sync=res.sync_makespan_steps,
    overlap=res.overlap_steps))
atexit.register(lambda: pickle.dump(records, open(out, "wb")))
if target.endswith(".py"):
    runpy.run_path(target, run_name="__main__")
else:
    runpy.run_module(target, run_name="__main__")
"""

# a time with the padding before it: the examples print times in fixed
# widths, so a wider time shifts the spaces
TIMES = re.compile(r"\s*-?\d+(\.\d+)?(ms|s\b| subrequests/s)")


@pytest.fixture(scope="module")
def jax_weights(tmp_path_factory):
    """The JAX examples' weights (smoke Qwen2.5-7B, f32, PRNGKey(0)) as
    an npz in JAX's checkpoint format."""
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    path = str(tmp_path_factory.mktemp("w") / "qwen")
    save(path, init_params(jax.random.PRNGKey(0), cfg))
    return path + ".npz"


def _run(tmp_path, tag, pkg, target, args):
    out = str(tmp_path / f"{tag}.pkl")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", SPY, out, pkg, target, *args],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(out, "rb") as f:
        return res.stdout, pickle.load(f)


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b, (a, b)


@pytest.mark.parametrize("name,args", [
    ("multi_agent_serving", ["--agents", "3", "--rounds", "3",
                             "--policies", "tokendance,prefix,recompute"]),
    ("multi_agent_serving", ["--agents", "4", "--rounds", "2",
                             "--policies", "pic", "--topology", "grouped:2",
                             "--workload", "agent_society"]),
    # an SLO far past the calibration round: every agent admitted in both
    # packages whatever the two machines' times (admission reads times)
    ("slo_admission", ["--agents", "3", "--rounds", "2",
                       "--slo-factor", "1000"]),
    ("continuous_serving", ["--agents", "4", "--rounds", "2",
                            "--stagger", "0,8"]),
])
def test_serving_twin_matches_the_jax_example(tmp_path, jax_weights, name,
                                              args):
    jout, jrec = _run(tmp_path, "jax", "repro", f"examples/{name}.py", args)
    tout, trec = _run(tmp_path, "torch", "repro_torch",
                      f"repro_torch.examples.{name}",
                      args + ["--device", "cpu", "--weights", jax_weights])
    assert [n for n, _ in trec] == [n for n, _ in jrec] and trec
    _same([r for _, r in trec], [r for _, r in jrec])
    masked = [TIMES.sub("#", x).split() for x in (tout, jout)]
    assert masked[0] == masked[1], (tout, jout)


def test_train_small_twin_runs_on_the_cpu(tmp_path):
    """``train_small`` at smoke size: the loss falls, and the checkpoint
    it writes loads into JAX's parameter tree."""
    from repro.training.checkpoint import load

    out = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.train_small", "--device",
         "cpu", "--steps", "30", "--seq-len", "48", "--batch", "8", "--out",
         str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr
    first, last = map(float, re.search(r"loss (\S+) -> (\S+)",
                                       res.stdout).groups())
    assert last < first - 0.3, res.stdout
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    like = init_params(jax.random.PRNGKey(0), cfg)
    back = load(str(out), like)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(back))
    assert not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                   zip(jax.tree.leaves(back), jax.tree.leaves(like)))
