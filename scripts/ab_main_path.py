"""Run ``chip_smoke.py``'s main path — the kernel build, then Qwen2.5-7B
served by ``ServingEngine`` + ``TokenDancePolicy`` on the 8-agent,
3-round trace — and its ``[hybrid]`` phase (Hymba-1.5B on the same
trace) from several checkouts in turn on one card, and print each run's
per-round recover, restore and decode ms, serve seconds and peak device
memory (its ``[main]`` lines), the ``[dense]`` loop's decode ms per round,
and the hybrid rounds' recover and decode ms and serve seconds as one
JSON line.

    python3 scripts/ab_main_path.py PARENT . . PARENT

Each argument is the root of a checkout that holds ``chip_smoke.py``
(with ``build()``, ``main_path(dev)`` and ``hybrid(dev)``); each run is a
process of its own. Give the runs in turns (A B B A) so that drift of the
card shows.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys

CODE = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as c;"
        " c.build(); c.main_path(torch.device('cuda'));"
        " c.hybrid(torch.device('cuda'))")


def run(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CODE], cwd=root,
                         capture_output=True, text=True, timeout=900)
    text = out.stdout
    if out.returncode != 0:
        raise RuntimeError(f"{root}: rc {out.returncode}\n{text[-3000:]}\n"
                           f"{out.stderr[-3000:]}")
    main = "\n".join(line for line in text.splitlines()
                     if line.startswith("[main]"))
    hyb = "\n".join(line for line in text.splitlines()
                    if line.startswith("[hybrid]"))
    dense = "\n".join(line for line in text.splitlines()
                      if line.startswith("[dense]"))
    return {"root": root,
            "recover_ms": [float(x) for x in
                           re.findall(r"\(recover ([0-9.]+)", main)],
            "restore_ms": [float(x) for x in
                           re.findall(r"restore ([0-9.]+), decode", main)],
            "decode_ms": [float(x) for x in
                          re.findall(r"decode ([0-9.]+), store", main)],
            "serve_s": float(re.search(r"serve ([0-9.]+) s", main).group(1)),
            "peak_gib": float(re.search(r"peak device memory ([0-9.]+) GiB",
                                        main).group(1)),
            "dense_decode_ms": [float(x) for x in
                                re.findall(r"decode ([0-9.]+), store",
                                           dense)],
            "hybrid_recover_ms": [float(x) for x in
                                  re.findall(r"\(recover ([0-9.]+)", hyb)],
            "hybrid_decode_ms": [float(x) for x in
                                 re.findall(r"decode ([0-9.]+), store", hyb)],
            "hybrid_serve_s": float(re.search(r"serve ([0-9.]+) s",
                                              hyb).group(1))}


def main() -> int:
    for root in sys.argv[1:]:
        print(json.dumps(run(root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
