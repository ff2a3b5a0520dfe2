"""The port's ``VideoPipeline`` on the CPU: frames come back in order and
as the same objects; at depth 1, 2 and 3 its humans equal a serial loop
of forward and decode bit for bit (``torch_cases.video_serial``, the
check the card tests make across CUDA streams); and they equal the JAX
``VideoPipeline``'s with the same ``thin160_coco`` weights (parts exact,
coords 1e-6, scores 1e-5)."""

import os

import numpy as np
import pytest
import torch

from torch_cases import humans_key, video_serial
from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.pipeline.video import VideoPipeline as JaxVideoPipeline
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.pipeline.video import VideoPipeline
from test_torch_estimator import _assert_same_humans, _scenes

torch.set_num_threads(2)

_THIN160 = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained", "thin160_coco", "params.msgpack")


def test_video_pipeline_order():
    est = TfPoseEstimator("mobilenet_thin", target_size=(96, 80),
                          device="cpu")
    rng = np.random.default_rng(2)
    frames = [rng.integers(0, 255, (80, 96, 3), np.uint8) for _ in range(5)]
    out = list(VideoPipeline(est, upsample_size=2.0, depth=2).run(
        iter(frames)))
    assert len(out) == 5
    for (f, humans), orig in zip(out, frames):
        assert f is orig
        assert isinstance(humans, list)


@pytest.fixture(scope="module")
def thin160():
    return TfPoseEstimator("mobilenet_thin", target_size=(160, 160),
                           params_path=_THIN160, device="cpu")


@pytest.fixture(scope="module")
def frames():
    # 320x320: halved to the network on the device, which equals the JAX
    # pipeline's cv2 INTER_AREA bit for bit at this factor
    return _scenes(5, 320, 320, seed=17)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_video_pipeline_equals_the_serial_loop(thin160, frames, depth):
    got = [h for _, h in VideoPipeline(thin160, 4.0, depth).run(frames)]
    want = video_serial(thin160, frames, 4.0)
    assert [humans_key(h) for h in got] == [humans_key(h) for h in want]
    assert sum(len(h) for h in got) >= 5


def test_video_pipeline_humans_equal_jax(thin160, frames):
    jax_est = JaxEstimator("mobilenet_thin", target_size=(160, 160),
                           params_path=_THIN160)
    want = [h for _, h in JaxVideoPipeline(jax_est, 4.0, 2).run(frames)]
    got = [h for _, h in VideoPipeline(thin160, 4.0, 2).run(frames)]
    for g, w in zip(got, want):
        _assert_same_humans(g, w)
    np.testing.assert_array_equal(thin160.last_peak_saturated,
                                  jax_est.last_peak_saturated)
