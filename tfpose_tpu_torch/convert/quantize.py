"""Weight storage quantisation of a params tree.

Port of ``tfpose_tpu/convert/quantize.py``, on nested dicts of numpy
arrays (the flax tree that ``convert/checkpoint.py`` reads and writes):

  * ``quantize_params`` / ``dequantize_params``: per-output-channel
    symmetric int8 of every kernel (a leaf of two or more dimensions;
    its last axis is the output channel), so a checkpoint stores 4x
    smaller; dequantised on load, so the compute path is unchanged;
  * ``cast_params``: kernels cast to bf16 (torch tensors: numpy has no
    bf16) for a lighter serving copy.

Vectors (biases, BN parameters) stay fp32: they are small and
precision-critical. This is not the int8 backbone (``models/quantize.py``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch


def _quantize_leaf(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(int8 values, fp32 per-out-channel scales)."""
    absmax = np.abs(x).reshape(-1, x.shape[-1]).max(axis=0)
    scale = np.maximum(absmax, 1e-12) / 127.0
    q = np.clip(np.round(x / scale), -127, 127).astype(np.int8)
    return q, scale.astype(np.float32)


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """params tree -> {'q': int8 kernels, 's': their scales, 'fp': the
    other leaves as fp32}, each nested as ``params``."""
    q_tree, s_tree, fp_tree = {}, {}, {}

    def rec(src, q, s, fp):
        for k, v in src.items():
            if isinstance(v, dict):
                q[k], s[k], fp[k] = {}, {}, {}
                rec(v, q[k], s[k], fp[k])
            else:
                arr = np.asarray(v)
                if arr.ndim >= 2:  # kernels
                    q[k], s[k] = _quantize_leaf(arr)
                else:
                    fp[k] = arr.astype(np.float32)

    rec(params, q_tree, s_tree, fp_tree)
    return {"q": q_tree, "s": s_tree, "fp": fp_tree}


def dequantize_params(packed: Dict[str, Any],
                      dtype=np.float32) -> Dict[str, Any]:
    """The inverse of :func:`quantize_params` (kernels ``q * s``)."""
    out: Dict[str, Any] = {}

    def rec(q, s, fp, dst):
        for k in sorted(set(q) | set(fp)):
            if k in q and isinstance(q[k], dict):
                dst[k] = {}
                rec(q[k], s[k], fp.get(k, {}), dst[k])
            elif k in q:
                dst[k] = (np.asarray(q[k]).astype(dtype)
                          * np.asarray(s[k]).astype(dtype))
            else:
                dst[k] = np.asarray(fp[k]).astype(dtype)

    rec(packed["q"], packed["s"], packed["fp"], out)
    return out


def cast_params(params: Dict[str, Any],
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Every kernel leaf as a torch tensor of ``dtype``; the rest as is."""
    def rec(tree):
        return {k: rec(v) if isinstance(v, dict) else (
            torch.from_numpy(np.array(v)).to(dtype) if np.ndim(v) >= 2
            else v) for k, v in tree.items()}

    return rec(params)


def quantization_error(params: Dict[str, Any]) -> float:
    """Largest relative L2 error of a kernel after the int8 round trip."""
    restored = dequantize_params(quantize_params(params))
    errs = []

    def rec(a, b):
        for k, v in a.items():
            if isinstance(v, dict):
                rec(v, b[k])
            elif np.ndim(v) >= 2:
                va = np.asarray(v, np.float32)
                vb = np.asarray(b[k], np.float32)
                denom = np.linalg.norm(va) + 1e-12
                errs.append(np.linalg.norm(va - vb) / denom)

    rec(params, restored)
    return float(max(errs)) if errs else 0.0
