"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with :mod:`ctypes`.
Nothing includes PyTorch's headers, so a build takes seconds. The decode
kernels' tiles per split come from ``ops.DECODE_SPLIT_TILES`` as a
define, so the wrappers' scratch and the kernels share one number. Builds
go to ``build/repro_torch_kernels/`` at the root of the checkout, named by
a hash of the sources and flags, and happen at the first launch of a
kernel — never at import, so the CPU tests import every module without a
compiler. :func:`build_all` starts one ``nvcc`` per source at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("rope_align", "block_diff", "flash_prefill", "flash_prefill_paged",
           "flash_decode_paged", "flash_decode", "diff_restore")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: ptxas report (registers, shared memory, spills) of each build, by source
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, object] = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SIGNATURES = {
    "rope_align": ("rope_align_launch",
                   [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "block_diff": ("block_diff_launch",
                   [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "flash_prefill": ("flash_prefill_launch",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _P]),
    "flash_prefill_paged": ("flash_prefill_paged_launch",
                            [_P] * 8 + [_I] * 11 + [_F, _I, _P]),
    "flash_decode_paged": ("flash_decode_paged_launch",
                           [_P] * 10 + [_I] * 10 + [_F, _I, _P]),
    "flash_decode": ("flash_decode_launch",
                     [_P] * 7 + [_I] * 7 + [_F, _I, _P]),
    "fused_diff_restore": ("fused_diff_restore_launch",
                           [_P] * 10 + [_I] * 8 + [_P]),
    "fused_family_restore": ("fused_family_restore_launch",
                             [_P] * 10 + [_I] * 9 + [_P]),
}
#: the source each kernel's launch function is compiled from
LIBRARY = {"fused_diff_restore": "diff_restore",
           "fused_family_restore": "diff_restore"}


def nvcc() -> str:
    """Path of the CUDA compiler (``$CUDA_HOME``, the default toolkit
    location, or ``PATH``); raises when there is none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def flags() -> tuple:
    """``NVCC_FLAGS`` and the defines the sources take from Python."""
    from repro_torch.kernels.ops import DECODE_SPLIT_TILES

    return (*NVCC_FLAGS, f"-DDECODE_SPLIT_TILES={DECODE_SPLIT_TILES}")


def _target(name: str) -> Path:
    h = hashlib.sha1()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.read_bytes())
    h.update(" ".join(flags()).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every library not built yet, one ``nvcc`` process per
    source, all started together. Returns the ptxas report per source
    and raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            BUILD_LOGS.setdefault(name, "(cached build)")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *flags(), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"--- {name} (rc {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return dict(BUILD_LOGS)


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed."""
    lib = _LIBS.get(source)
    if lib is None:
        out = _target(source)
        if not out.exists():
            build_all((source,))
        lib = ctypes.CDLL(str(out))
        _LIBS[source] = lib
    return lib


def launcher(name: str):
    """The C launch function of one kernel, typed."""
    fn = _FNS.get(name)
    if fn is None:
        fn_name, argtypes = SIGNATURES[name]
        fn = getattr(load(LIBRARY.get(name, name)), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn

