"""ctypes binding for the native C++ parity decoder — the port's copy of
``tfpose_tpu/oracle/cpp/__init__.py``.

``pafdecode.cpp`` (beside this file) is built at first use by
``g++ -O2 -shared -fPIC`` into ``tfpose_tpu_torch/_build/``, never beside
the source; the library's name carries a hash of the source and the
flags, so an edited source rebuilds. Without ``g++`` it raises. Used by
the parity sweep (``evaluation/parity_sweep.py``) as a second, native
witness next to the NumPy oracle.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "pafdecode.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
_FLAGS = ("-O2", "-shared", "-fPIC")

_lib: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"pafdecode-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the C++ parity oracle "
                           "(oracle/cpp/pafdecode.cpp) cannot be built")
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run([cxx, *_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True)
        os.replace(tmp, path)   # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        _build(path)
    lib = ctypes.CDLL(path)
    lib.process_paf.restype = ctypes.c_int
    lib.process_paf.argtypes = [
        ctypes.POINTER(ctypes.c_float),  # peaks
        ctypes.POINTER(ctypes.c_float),  # heat
        ctypes.POINTER(ctypes.c_float),  # paf
        ctypes.c_int, ctypes.c_int,      # h, w
        ctypes.POINTER(ctypes.c_float),  # out_parts
        ctypes.POINTER(ctypes.c_float),  # out_scores
        ctypes.c_int,                    # max_humans
        ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
    ]
    _lib = lib
    return lib


def process_paf(peaks: np.ndarray, heat: np.ndarray, paf: np.ndarray,
                max_humans: int = 96, thresh_heat: float = 0.05,
                thresh_vector_score: float = 0.05,
                thresh_vector_cnt1: int = 8, thresh_part_cnt: int = 4,
                thresh_human_score: float = 0.4, step_paf: int = 10):
    """Native decode of (H, W, 19) peaks and heat and (H, W, 38) PAF.
    Returns (parts (n, 18, 4): cid, x, y, score; scores (n,))."""
    lib = get_lib()
    h, w, _ = peaks.shape
    peaks_f = np.ascontiguousarray(peaks, np.float32)
    heat_f = np.ascontiguousarray(heat, np.float32)
    paf_f = np.ascontiguousarray(paf, np.float32)
    if peaks_f.shape[2] != 19 or heat_f.shape != peaks_f.shape or \
            paf_f.shape != (h, w, 38):
        raise ValueError(f"peaks/heat (H, W, 19) and paf (H, W, 38), got "
                         f"{peaks_f.shape}, {heat_f.shape}, {paf_f.shape}")
    out_parts = np.full((max_humans, 18, 4), -1.0, np.float32)
    out_scores = np.zeros((max_humans,), np.float32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))

    n = lib.process_paf(ptr(peaks_f), ptr(heat_f), ptr(paf_f), h, w,
                        ptr(out_parts), ptr(out_scores), max_humans,
                        thresh_heat, thresh_vector_score,
                        thresh_vector_cnt1, thresh_part_cnt,
                        thresh_human_score, step_paf)
    return out_parts[:n], out_scores[:n]
