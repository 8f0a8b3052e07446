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


# one thread a subprocess (torch's pools and XLA's): the module starts
# all of its subprocesses at once, beside the other test workers
ONE_THREAD = dict(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                  XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                            "intra_op_parallelism_threads=1")

SERVING_CASES = [
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
]


def _jax_weights(path):
    """The JAX examples' weights (smoke Qwen2.5-7B, f32, PRNGKey(0)) as
    an npz in JAX's checkpoint format."""
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    save(path, init_params(jax.random.PRNGKey(0), cfg))
    return path + ".npz"


def _start(out, pkg, target, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               **ONE_THREAD)
    return subprocess.Popen([sys.executable, "-c", SPY, out, pkg, target,
                             *args], env=env, cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every subprocess of the module, started together before its first
    test: for each serving case the JAX example and the port's twin (on
    the JAX weights), and ``train_small``. Yields the processes by key
    (the case's index and package, or "train") with their output paths;
    any still running at teardown is killed."""
    tmp = tmp_path_factory.mktemp("examples")
    weights = _jax_weights(str(tmp / "qwen"))
    procs = {}
    for i, (name, args) in enumerate(SERVING_CASES):
        for tag, pkg, target, extra in (
                ("jax", "repro", f"examples/{name}.py", []),
                ("torch", "repro_torch", f"repro_torch.examples.{name}",
                 ["--device", "cpu", "--weights", weights])):
            out = str(tmp / f"{i}-{tag}.pkl")
            procs[i, tag] = (_start(out, pkg, target, args + extra), out)
    ck = tmp / "ck"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **ONE_THREAD)
    procs["train"] = (subprocess.Popen(
        [sys.executable, "-m", "repro_torch.examples.train_small", "--device",
         "cpu", "--steps", "30", "--seq-len", "48", "--batch", "8", "--out",
         str(ck)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True), str(ck))
    yield procs
    for proc, _ in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def _result(run, timeout=600):
    """(stdout, the pickled records) of a finished spy run."""
    proc, out = run
    stdout, stderr = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, stderr[-3000:]
    with open(out, "rb") as f:
        return stdout, pickle.load(f)


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


@pytest.mark.parametrize("case", range(len(SERVING_CASES)),
                         ids=[f"{n}-args{i}" for i, (n, _) in
                              enumerate(SERVING_CASES)])
def test_serving_twin_matches_the_jax_example(runs, case):
    jout, jrec = _result(runs[case, "jax"])
    tout, trec = _result(runs[case, "torch"])
    assert [n for n, _ in trec] == [n for n, _ in jrec] and trec
    _same([r for _, r in trec], [r for _, r in jrec])
    masked = [TIMES.sub("#", x).split() for x in (tout, jout)]
    assert masked[0] == masked[1], (tout, jout)


def test_train_small_twin_runs_on_the_cpu(runs):
    """``train_small`` at smoke size: the loss falls, and the checkpoint
    it writes loads into JAX's parameter tree."""
    from repro.training.checkpoint import load

    proc, out = runs["train"]
    stdout, stderr = proc.communicate(timeout=300)
    assert proc.returncode == 0, stderr
    first, last = map(float, re.search(r"loss (\S+) -> (\S+)",
                                       stdout).groups())
    assert last < first - 0.3, stdout
    cfg = get_smoke_config("qwen2.5-7b").replace(dtype="float32")
    like = init_params(jax.random.PRNGKey(0), cfg)
    back = load(out, like)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(back))
    assert not all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                   zip(jax.tree.leaves(back), jax.tree.leaves(like)))
