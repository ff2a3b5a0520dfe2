"""``TfPoseEstimator.inference_batch``: one caller, ``batch`` images a
call, in a closed loop (the offline or video user)."""

from posebench.entries import _program


def run(cell):
    _program.closed_loop(cell)
    up = cell.config["upsample"]
    return _program.drive(
        cell, lambda est, imgs: est.inference_batch(imgs, upsample_size=up))
