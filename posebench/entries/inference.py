"""``TfPoseEstimator.inference``: one caller, one image a call, in a
closed loop (the interactive user)."""

from posebench.entries import _program


def run(cell):
    _program.closed_loop(cell)
    up = cell.config["upsample"]
    return _program.drive(
        cell, lambda est, imgs: [est.inference(imgs[0], upsample_size=up)])
