"""Build the mixed-precision product kernel alone and hold it on one card.

    python3 scripts/probe_mixed_matmul.py

Builds ``csrc/mixed_matmul.cu`` (no other source) and prints the
registers, spills and shared memory ptxas gives each of its two tile
configurations, then runs ``chip_smoke.mixed_phase``: every f32 product
shape of the benchmark's cells against the plain product, twice for the
same bits, timed beside the parent's path (the weight cast to f32,
cuBLAS's f32 product, TF32 off) and the bound, and the error against
the float64 product beside the parent path's. A minute or two on the
card, the build included.
"""
import argparse
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n")[0]).parse_args()
    if not torch.cuda.is_available():
        print("probe_mixed_matmul: needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    chip_smoke.card()
    t0 = time.perf_counter()
    log = build.build_all(("mixed_matmul",))["mixed_matmul"]
    print(f"[build] mixed_matmul in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for line in log.splitlines():
        if "Used" in line or "spill" in line or "Compiling" in line:
            print(f"[build] {line.strip()}", flush=True)
    chip_smoke.mixed_phase(dev)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
