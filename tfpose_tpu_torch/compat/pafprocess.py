"""Compatibility shim for the reference SWIG module API
(``tf_pose/pafprocess``): ``process_paf(peaks, heat, paf)`` followed by
``get_num_humans() / get_part_cid / get_part_x / get_part_y /
get_part_score / get_score``.

Port of ``tfpose_tpu/compat/pafprocess.py``, backed by the port's NumPy
decoder (``oracle/numpy_decoder.py``) where the JAX package uses its C++
twin. As in the SWIG extension, the result of the last ``process_paf``
is module state that the getters read.
"""

from __future__ import annotations

import numpy as np

from tfpose_tpu_torch.oracle import numpy_decoder

_parts = np.zeros((0, 18, 4), np.float64)
_scores = np.zeros((0,), np.float64)


def process_paf(peaks: np.ndarray, heat_mat: np.ndarray,
                paf_mat: np.ndarray) -> int:
    """Run the decode; returns 0 like the SWIG wrapper."""
    global _parts, _scores
    res = numpy_decoder.process_paf(
        np.asarray(peaks, np.float32), np.asarray(heat_mat, np.float32),
        np.asarray(paf_mat, np.float32))
    _parts, _scores = res.parts, res.scores
    return 0


def get_num_humans() -> int:
    return int(_parts.shape[0])


def get_part_cid(human_id: int, part_id: int) -> int:
    return int(_parts[human_id, part_id, 0])


def get_part_x(human_id: int, part_id: int) -> int:
    return int(_parts[human_id, part_id, 1])


def get_part_y(human_id: int, part_id: int) -> int:
    return int(_parts[human_id, part_id, 2])


def get_part_score(human_id: int, part_id: int) -> float:
    return float(_parts[human_id, part_id, 3])


def get_score(human_id: int) -> float:
    return float(_scores[human_id])
