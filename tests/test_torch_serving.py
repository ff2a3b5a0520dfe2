"""The port's serving side against the JAX package's, on the CPU:
messages, the dynamic batcher (the five cases of ``tests/test_batcher.py``
on a fake estimator), and ``PoseService`` / ``PoseClient`` on
127.0.0.1 — the port's server against the JAX server on the same raw
frames, each package's client talking to the other's server, a bad tag,
JPEG payloads with and without cv2, and concurrent clients through the
batcher. Both estimators load the committed ``thin160_coco`` weights;
humans compare with parts exact, coords 1e-6 and scores 1e-5
(``tests/test_torch_estimator.py``'s tolerances)."""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tfpose_tpu.estimator import TfPoseEstimator as JaxEstimator
from tfpose_tpu.serving import PoseClient as JaxClient
from tfpose_tpu.serving import PoseService as JaxService
from tfpose_tpu.serving import humans_to_msg as jax_humans_to_msg
from tfpose_tpu_torch.core.types import BodyPart, Human
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.serving import (
    DynamicBatcher,
    Persons,
    PoseClient,
    PoseService,
    humans_to_msg,
)
from test_torch_estimator import _scenes

torch.set_num_threads(2)

_THIN160 = os.path.join(os.path.dirname(__file__), "..", "models",
                        "trained", "thin160_coco", "params.msgpack")


def _mk_human():
    h = Human()
    h.body_parts[0] = BodyPart("0-0", 0, 0.5, 0.25, 0.9)
    h.body_parts[1] = BodyPart("0-1", 1, 0.5, 0.40, 0.8)
    h.score = 1.5
    return h


def test_messages_roundtrip_and_fields_equal_jax():
    msg = humans_to_msg([_mk_human()], 640, 480)
    d = msg.to_dict()
    back = Persons.from_dict(d)
    assert back == msg
    assert back.image_w == 640 and back.image_h == 480
    parts = {bp.part_id: bp for bp in back.persons[0].body_part}
    assert parts[0].x == 0.5 and parts[1].y == 0.40
    want = jax_humans_to_msg([_mk_human()], 640, 480).to_dict()
    del d["header"], want["header"]
    assert d == want


# ---------------------------------------------------------------- batcher
class FakeEstimator:
    """One Human per image whose x encodes the image's first pixel, so
    results can be matched back to requests."""

    def __init__(self, delay=0.0):
        self.batches = []
        self.delay = delay

    def inference_batch(self, imgs, upsample_size=1.0):
        self.batches.append(len(imgs))
        if self.delay:
            time.sleep(self.delay)
        out = []
        for im in imgs:
            h = Human()
            h.body_parts[0] = BodyPart("0-0", 0, float(im[0, 0, 0]) / 255.0,
                                       0.5, 0.9)
            out.append([h])
        return out


def _img(tag, h=8, w=8):
    return np.full((h, w, 3), tag, np.uint8)


def test_batcher_coalesces_and_routes_results():
    est = FakeEstimator(delay=0.02)
    b = DynamicBatcher(est, max_batch=4, max_wait_ms=50.0)
    try:
        tags = (10, 20, 30, 40, 50, 60)
        futs = [b.submit(_img(t)) for t in tags]
        got = [f.result(timeout=10.0) for f in futs]
        for tag, humans in zip(tags, got):  # each request its own result
            assert len(humans) == 1
            assert humans[0].body_parts[0].x == pytest.approx(tag / 255)
        assert all(n == 4 for n in est.batches)  # padded to max_batch
        assert len(est.batches) <= 3  # 6 requests coalesced
        assert max(b.batch_sizes) >= 2
        assert sum(k * v for k, v in b.batch_sizes.items()) == 6
    finally:
        b.stop()


@pytest.mark.parametrize("pad_to_max,batches", [(True, [8]), (False, [1])])
def test_batcher_single_request(pad_to_max, batches):
    """A lone request resolves after max_wait: padded to max_batch by
    repeating it, or alone without padding."""
    est = FakeEstimator()
    b = DynamicBatcher(est, max_batch=8, max_wait_ms=1.0,
                       pad_to_max=pad_to_max)
    try:
        humans = b.submit(_img(99)).result(timeout=10.0)
        assert humans[0].body_parts[0].x == pytest.approx(99 / 255)
        assert est.batches == batches
        assert b.batch_sizes == {1: 1}
    finally:
        b.stop()


def test_batcher_propagates_estimator_errors():
    class Boom:
        def inference_batch(self, imgs, upsample_size=1.0):
            raise RuntimeError("device on fire")

    b = DynamicBatcher(Boom(), max_batch=2, max_wait_ms=1.0)
    try:
        with pytest.raises(RuntimeError, match="device on fire"):
            b.submit(_img(1)).result(timeout=10.0)
    finally:
        b.stop()


def test_batcher_stop_fails_pending_and_rejects_new():
    b = DynamicBatcher(FakeEstimator(), max_batch=2, max_wait_ms=1.0)
    b.stop()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        b.submit(_img(1))
    # a request queued after the worker left is failed by stop()
    from concurrent.futures import Future
    fut = Future()
    b._q.put((_img(2), fut))
    b.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        fut.result(timeout=1.0)


# ---------------------------------------------------------------- service
@pytest.fixture(scope="module")
def pair():
    kw = dict(target_size=(160, 160), params_path=_THIN160)
    return (JaxEstimator("mobilenet_thin", **kw),
            TfPoseEstimator("mobilenet_thin", device="cpu", **kw))


@pytest.fixture(scope="module")
def frames():
    # 320x320 frames, halved to the 160x160 network on the server: at a
    # factor of 2 the port's area resize equals cv2's INTER_AREA bit for
    # bit (at other factors a grey level can differ, tests/test_torch_ops)
    return _scenes(3, 320, 320, seed=21)


def _persons_key(msg):
    return [[(bp.part_id, bp.x, bp.y, bp.confidence) for bp in p.body_part]
            for p in msg.persons]


def _assert_same_persons(got, want):
    """Equal ``Persons`` except the stamp: part ids exact, x and y 1e-6,
    confidences 1e-5."""
    assert (got.image_w, got.image_h) == (want.image_w, want.image_h)
    g, w = _persons_key(got), _persons_key(want)
    assert [[p[0] for p in h] for h in g] == [[p[0] for p in h] for h in w]
    for hg, hw in zip(g, w):
        for pg, pw in zip(hg, hw):
            assert abs(pg[1] - pw[1]) <= 1e-6 and abs(pg[2] - pw[2]) <= 1e-6
            assert abs(pg[3] - pw[3]) <= 1e-5


@pytest.fixture(scope="module")
def servers(pair):
    jax_est, est = pair
    svcs = [JaxService(jax_est, port=0, upsample_size=4.0),
            PoseService(est, port=0, upsample_size=4.0)]
    addrs = [s.start() for s in svcs]
    yield addrs
    for s in svcs:
        s.stop()


@pytest.mark.parametrize("client", ["port", "jax"])
def test_port_server_equals_jax_server(servers, frames, client):
    """The same raw frames to both servers, through the port's client
    and through the JAX client (each package's client talking to the
    other's server): equal ``Persons`` except the stamp."""
    cls = PoseClient if client == "port" else JaxClient
    jax_addr, port_addr = servers
    cj, cp = cls(*jax_addr), cls(*port_addr)
    try:
        n = 0
        for img in frames:
            want, got = cj.infer_raw(img), cp.infer_raw(img)
            assert (got.image_w, got.image_h) == (320, 320)
            _assert_same_persons(got, want)
            n += len(got.persons)
        assert n >= 3
    finally:
        cj.close()
        cp.close()


def test_port_server_reply_is_humans_to_msg_of_the_estimator(pair, servers,
                                                              frames):
    _, est = pair
    c = PoseClient(*servers[1])
    try:
        got = c.infer_raw(frames[0])
    finally:
        c.close()
    want = humans_to_msg(est.inference(frames[0], upsample_size=4.0), 320,
                         320)
    _assert_same_persons(got, want)


def test_port_server_bad_tag_and_jpeg_without_cv2(servers, frames,
                                                  monkeypatch):
    """A bad tag, a JPEG payload where cv2 cannot be imported, and raw
    payloads shorter than their header or their pixels: each gets an
    error reply naming the reason (the client raises ``ValueError``) and
    the server goes on serving."""
    c = PoseClient(*servers[1])
    try:
        with pytest.raises(ValueError, match="tag must be"):
            c._roundtrip(b"X" + b"garbage")
        monkeypatch.setitem(sys.modules, "cv2", None)  # import fails
        with pytest.raises(ValueError, match="needs cv2"):
            c.infer_jpeg(b"\xff\xd8not a jpeg")
        with pytest.raises(ValueError, match="holds 5 bytes"):
            c._roundtrip(b"R" + (2).to_bytes(4, "big") * 2 + b"12345")
        with pytest.raises(ValueError, match="header"):
            c._roundtrip(b"R\x00\x01")
        assert c.infer_raw(frames[0]).image_w == 320
    finally:
        c.close()


def test_port_server_jpeg_with_cv2(servers, frames):
    """With cv2 a JPEG request decodes on the server: the reply equals
    the raw request of the decoded image."""
    cv2 = pytest.importorskip("cv2")
    ok, jpg = cv2.imencode(".jpg", frames[0], [cv2.IMWRITE_JPEG_QUALITY, 100])
    assert ok
    c = PoseClient(*servers[1])
    try:
        got = c.infer_jpeg(jpg.tobytes())
        want = c.infer_raw(cv2.imdecode(jpg, cv2.IMREAD_COLOR))
        _assert_same_persons(got, want)
        assert len(got.persons) > 0
    finally:
        c.close()


def test_batched_service_concurrent_clients_equal_inference_batch(pair,
                                                                  frames):
    """Four client threads at ``max_batch=4``: the requests share device
    batches, and each reply equals ``humans_to_msg`` of the estimator's
    ``inference_batch`` humans for its own frame."""
    _, est = pair
    svc = PoseService(est, port=0, upsample_size=4.0, max_batch=4,
                      max_wait_ms=200.0)
    addr = svc.start()
    imgs = frames + frames[:1]
    results, errors = {}, []

    def one(i):
        try:
            c = PoseClient(*addr)
            results[i] = c.infer_raw(imgs[i])
            c.close()
        except Exception as exc:  # reported below
            errors.append(exc)

    try:
        threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors and set(results) == {0, 1, 2, 3}
        sizes = svc._batcher.batch_sizes
        assert sum(k * v for k, v in sizes.items()) == 4
        assert max(sizes) >= 2
    finally:
        svc.stop()
    want = est.inference_batch(imgs, upsample_size=4.0)
    for i, humans in enumerate(want):
        _assert_same_persons(results[i], humans_to_msg(humans, 320, 320))
