"""Time the first build of the port's CUDA kernels in several checkouts, in
turns, on the machine with the card: each checkout's sources compiled from
scratch into a fresh temporary directory, one ``nvcc`` per source, all
started together (as ``repro_torch.kernels.build.build_all`` starts them),
with the wall time of the whole build and of each source, and each
source's instances and spills from the ptxas report. One JSON line per run.

    python3 scripts/time_kernel_build.py PARENT . . PARENT

Each argument is the root of a checkout with ``src/repro_torch``; each run
is a process of its own. Give the runs in turns (A B B A) so that drift of
the machine shows.
"""
from __future__ import annotations

import json
import subprocess
import sys

CODE = r"""
import json, re, subprocess, sys, tempfile, time
from pathlib import Path
sys.path.insert(0, 'src')
from repro_torch.kernels import build as kb

with tempfile.TemporaryDirectory() as tmp:
    t0 = time.perf_counter()
    procs = {}
    for name in kb.SOURCES:
        cmd = [kb.nvcc(), *kb.flags(), '-o', f'{tmp}/{name}.so',
               str(kb.CSRC / f'{name}.cu')]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    done, logs = {}, {}
    while len(done) < len(procs):
        for name, p in procs.items():
            if name not in done and p.poll() is not None:
                done[name] = time.perf_counter() - t0
                logs[name] = p.communicate()[0]
                assert p.returncode == 0, logs[name]
        time.sleep(0.05)
    total = time.perf_counter() - t0
rec = dict(root=sys.argv[1], total_s=round(total, 2),
           source_s={k: round(v, 2) for k, v in done.items()})
for name, log in logs.items():
    rec[name + '_instances'] = log.count('Compiling entry function')
    rec[name + '_spills'] = [
        int(a) + int(b) for a, b in re.findall(
            r'(\d+) bytes spill stores, (\d+) bytes spill loads', log)
        if int(a) + int(b)]
print(json.dumps(rec), flush=True)
"""


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CODE, root], cwd=root,
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    roots = sys.argv[1:] or ["."]
    for root in roots:
        print(json.dumps(run(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
