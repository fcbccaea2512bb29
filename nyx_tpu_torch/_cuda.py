"""Build and load the port's hand-written CUDA kernels.

Each `csrc/<name>.cu` exposes a plain `extern "C"` interface. It is compiled
with `nvcc` at first use into `_build/` (not tracked by git), under a file
name keyed on a hash of the source and the flags, and bound with `ctypes`.
A build holds a lock, so host threads that launch a kernel for the first
time at once build it once (a mesh's shards load it before they start,
all the same). Nothing here runs at import: the module is imported on
machines without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# IEEE f32 operation by operation: no --use_fast_math (it changes sqrtf and
# the division in 1/r), and no contraction into fused multiply-adds, so a
# kernel rounds each operation as its torch twin does and the two differ
# only where they sum in another order.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass(frozen=True)
class Built:
    lib: ctypes.CDLL
    path: Path
    seconds: float  # nvcc wall time; 0.0 when the cached library was reused
    log: str  # nvcc/ptxas output (registers, spills, shared memory)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME): cannot build the kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


_BUILD_LOCK = threading.Lock()


def load(name: str) -> Built:
    """The compiled `csrc/<name>.cu`, built on first use, once whichever
    threads ask."""
    with _BUILD_LOCK:
        return _load(name)


@functools.cache
def _load(name: str) -> Built:
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}-{key}.so"
    seconds, log = 0.0, ""
    if not so.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = BUILD_DIR / f"lib{name}-{key}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, so)
    return Built(ctypes.CDLL(str(so)), so, seconds, log)
