"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/*.cu`` is a self-contained source with a plain C interface
(no PyTorch header). At first use every source is compiled by its own
``nvcc`` process for ``sm_90a``, all started together, into a shared
library under ``tfpose_tpu_torch/_build/<hash>/``; the hash covers the
sources and the flags, so an edited source rebuilds. The libraries are
loaded with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Callable, Dict, Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300

_libs: Dict[str, ctypes.CDLL] = {}
_launchers: Dict[Tuple[str, str], Callable] = {}
build_log: Dict[str, str] = {}   # source stem -> nvcc output (ptxas -v)
build_seconds: Dict[str, float] = {}  # source stem -> seconds to its build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources():
    names = sorted(n for n in os.listdir(CSRC) if n.endswith((".cu", ".cuh")))
    if not any(n.endswith(".cu") for n in names):
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return names


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _sources():
        h.update(name.encode())
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> float:
    """Compile every source that has no library yet, one ``nvcc`` per
    source, in parallel. Returns the seconds spent (each source's own in
    ``build_seconds``); raises with nvcc's output on failure or timeout."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name in _sources():
        if not name.endswith(".cu"):
            continue
        stem = name[:-3]
        target = os.path.join(out_dir, f"lib{stem}.so")
        if os.path.exists(target):
            continue
        tmp = f"{target}.{os.getpid()}.tmp"
        log = open(f"{tmp}.log", "w+")
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, name)]
        procs[stem] = (subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT),
                       log, tmp, target)
    failures = []
    while procs:
        for stem, (proc, log, tmp, target) in list(procs.items()):
            timed_out = proc.poll() is None
            if timed_out:
                if time.perf_counter() - t0 <= BUILD_TIMEOUT_S:
                    continue
                proc.kill()
                proc.wait()
            del procs[stem]
            build_seconds[stem] = time.perf_counter() - t0
            log.seek(0)
            out = build_log[stem] = log.read()
            log.close()
            os.remove(log.name)
            if timed_out:
                failures.append(f"{stem}: nvcc timed out after "
                                f"{BUILD_TIMEOUT_S} s\n{out}")
            elif proc.returncode != 0:
                failures.append(f"{stem}: nvcc exit {proc.returncode}\n{out}")
            else:
                os.replace(tmp, target)
        time.sleep(0.05)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return time.perf_counter() - t0


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (builds all
    sources first if needed)."""
    lib = _libs.get(stem)
    if lib is None:
        path = os.path.join(build_dir(), f"lib{stem}.so")
        if not os.path.exists(path):
            build_all()
        lib = _libs[stem] = ctypes.CDLL(path)
    return lib


def launcher(stem: str, symbol: str, argtypes: Sequence) -> Callable:
    """The C launch function ``symbol`` of ``csrc/<stem>.cu`` with its
    argument types declared (returns a CUDA error code as int)."""
    fn = _launchers.get((stem, symbol))
    if fn is None:
        fn = getattr(library(stem), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _launchers[(stem, symbol)] = fn
    return fn


def check(stem: str, status: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code (``cudaGetLastError``
    right after the launch)."""
    if status != 0:
        err = library(stem).tfpose_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        msg = err(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg})")
