"""The port's profiles (``tfpose_tpu_torch/profiles/``) on the CPU: the
five decode stages of ``stages.py`` against JAX's stages of
``scripts/profile_stages.py``, rebuilt here from ``tfpose_tpu.ops``
with the Pallas kernels in interpret mode, on the same N(0, 0.3)
network outputs (rtol 1e-5); the timers refusing the CPU; the forward's
FLOP count against ``TfPoseEstimator.get_flops``; the op buckets and
tables and the per-call kernel and sync counts of hand-written
``torch.profiler`` chrome traces (the pattern of
``tests/test_torch_profiling.py``)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfpose_tpu.core.config import DecodeParams as JaxDecodeParams
from tfpose_tpu.ops import nms as jax_nms
from tfpose_tpu.ops import paf as jax_paf
from tfpose_tpu.ops import resize as jax_resize
from tfpose_tpu.ops.decode import decode_batch as jax_decode_batch
from tfpose_tpu.ops.pallas.smooth_nms import smooth_nms_topk_pallas
from tfpose_tpu_torch import profiles
from tfpose_tpu_torch.estimator import TfPoseEstimator
from tfpose_tpu_torch.profiles import forward, ops, stages
from tfpose_tpu_torch.utils.profiling import device_event_durations_ms

torch.set_num_threads(2)

UP_H, UP_W = 184, 216


def _jax_stages():
    """``scripts/profile_stages.py``'s five stages, the kernels in
    interpret mode (the script runs them compiled on the TPU), each
    returning what the script's stage sums."""
    params = JaxDecodeParams()

    def heat_up(t):
        return jax_resize.resize_area(t[..., :19], UP_H, UP_W)

    def topk(t):
        return jax.vmap(lambda x: smooth_nms_topk_pallas(
            x, params.max_peaks, params.thresh_heat,
            params.smooth_kernel_size, params.smooth_sigma,
            interpret=True))(heat_up(t)[..., :18])

    def cands(t):
        scores, idx = topk(t)
        idx_safe = jnp.maximum(idx, 0)
        pk = jax_nms.Peaks(x=(idx_safe % UP_W).astype(jnp.int32),
                           y=(idx_safe // UP_W).astype(jnp.int32),
                           score=scores, valid=scores > params.thresh_heat)
        return jax.vmap(lambda p, m: jax_paf.score_candidates_pallas(
            p, m, UP_H, UP_W, params, interpret=True))(
                pk, t[..., 19:].astype(jnp.float32))

    def greedy(t):
        return jax.vmap(lambda c: jax_paf.greedy_connections(c, params))(
            cands(t)).score

    decode = jax.jit(jax_decode_batch, static_argnums=(1, 2, 3))
    return {"resize_heat": heat_up,
            "+smooth_nms_topk": topk,
            "+paf_sampling": lambda t: cands(t).score,
            "+greedy": greedy,
            "full_decode": lambda t: decode(t, UP_H, UP_W,
                                            params).human_scores}


def _sums(out):
    """Each result's sum in float64 (a float32 sum of the 1.5 M values
    of the upsampled heat depends on the summation order)."""
    out = out if isinstance(out, tuple) else (out,)
    return [float(np.sum(np.asarray(t), dtype=np.float64)) for t in out]


@pytest.fixture(scope="module")
def outputs():
    """B=2 network outputs, drawn as both scripts draw them."""
    return stages.net_outputs(2, 1)[0]


def test_net_outputs_are_the_jax_scripts():
    got = stages.net_outputs(2, 8).numpy()
    want = np.random.default_rng(0).normal(
        0, 0.3, (8, 2, 46, 54, 57)).astype(np.float32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("index", range(5))
def test_stage_equals_jax(outputs, index):
    """Stage ``index`` of the port on the CPU (the kernels' plain
    versions) against JAX's: the sum of each result (JAX's value, taken
    in float64) within rtol 1e-5, and not a degenerate one (the noise
    has peaks, candidates and connections). The timed scalar is those
    sums, added."""
    name, fn = stages.stages()[index]
    got = fn(outputs)
    want = _jax_stages()[name](jnp.asarray(outputs.numpy()))
    for g, w in zip(_sums(got), _sums(want)):
        assert g == pytest.approx(w, rel=1e-5), name
        assert g != 0.0
    assert float(stages.total(got)) == pytest.approx(sum(_sums(want)),
                                                     rel=1e-4)


def test_stage_names_are_the_jax_scripts():
    assert [n for n, _ in stages.stages()] == [
        "resize_heat", "+smooth_nms_topk", "+paf_sampling", "+greedy",
        "full_decode"]


@pytest.mark.parametrize("argv", [
    ["stages", "--device", "cpu"],
    ["stages", "--batch", "2", "--device", "cpu", "--json"],
    ["forward", "--quick", "--device", "cpu"],
    ["ops", "--model", "mobilenet_thin", "--width", "64", "--height", "48",
     "--batch", "1", "--device", "cpu"],
])
def test_profiles_refuse_the_cpu(argv):
    """Every profile needs the card: on the CPU the timers raise and
    name CUDA, before a number is printed."""
    with pytest.raises(ValueError, match="CUDA"):
        profiles.main(argv)


def test_profile_command_must_be_named():
    with pytest.raises(SystemExit, match="stages,forward,ops"):
        profiles.main(["nope"])


def test_report_prints_the_jax_scripts_lines():
    doc = {"batch": 1, "config": stages.CONFIG, "device": "card, 700.00 W",
           "stages": [{"stage": "resize_heat", "ms_per_img": 0.25,
                       "delta_ms": 0.25, "busy_ms_per_img": 0.125,
                       "kernels_per_call": 3.0, "syncs_per_call": 0.0}]}
    lines = stages.report(doc).splitlines()
    assert lines[0].startswith("batch=1 thin 432x368 up4x")
    assert "card, 700.00 W" in lines[0]
    assert lines[1].startswith("  resize_heat          0.250 ms | + 0.250 ms")
    assert lines[1].endswith("busy  0.1250 ms, 3 kernels, 0 syncs")


# ------------------------------------------------------------ forward
@pytest.mark.parametrize("model,w,h", [("mobilenet_thin", 96, 80),
                                       ("mobilenet_v2_small", 64, 64),
                                       ("cmu", 64, 48)])
def test_forward_flops_equal_get_flops(model, w, h):
    """The profile's GFLOP is ``get_flops``' count (bf16 network, one
    image), and scales with the batch."""
    est = TfPoseEstimator(model, target_size=(w, h), device="cpu")
    net = forward.seeded_network(model, "bfloat16", "cpu")
    x = torch.zeros((1, h, w, 3), dtype=torch.uint8)
    flops = forward.forward_flops(net, x)
    assert flops == est.get_flops() > 0
    assert forward.forward_flops(net, x.expand(3, h, w, 3)) == 3 * flops


def test_top_ops_sorts_and_shares():
    durs = {"a": [1.0, 1.0], "b": [5.0], "c": [0.5, 0.25, 0.25]}
    rows, total = forward.top_ops(durs, n=2)
    assert total == 8.0
    assert rows == [{"name": "b", "total_ms": 5.0, "n": 1, "pct": 62.5},
                    {"name": "a", "total_ms": 2.0, "n": 2, "pct": 25.0}]


def test_peaks_name_the_card():
    assert forward.PEAK_TFLOPS == {"bfloat16": 989.4, "float32": 66.9}
    assert "H100" in forward.PEAK_CARD and "700 W" in forward.PEAK_CARD


# ---------------------------------------------------------------- ops
@pytest.mark.parametrize("name,want", [
    # cuDNN / CUTLASS convolutions
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "conv"),
    ("void implicit_convolve_sgemm<float, float, 128, 5, 5, 3, 3, 3>",
     "conv"),
    ("void fft2d_r2c_32x32<float, false, 1u, false>(float2*)", "conv"),
    ("cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_"
     "optimized_bf16_64x64_64x5_nhwc_align8>", "conv"),
    ("void cudnn::winograd_nonfused::winogradForwardData4x4<float>",
     "conv"),
    ("void at::native::(anonymous namespace)::"
     "conv_depthwise2d_forward_kernel<3, float, int>", "conv"),
    ("sm80_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x16", "conv"),
    # copies
    ("Memcpy DtoH (Device -> Pageable)", "data-movement"),
    ("Memset (Device)", "data-movement"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "direct_copy_kernel_cuda(at::TensorIteratorBase&)>", "data-movement"),
    ("void at::native::im2col_kernel<float>", "data-movement"),
    ("void cudnn::ops::nchwToNhwcKernel<float, float, float, false>",
     "data-movement"),
    ("void nhwcAddPaddingKernel<__nv_bfloat16, __nv_bfloat16, float, true, "
     "(cudnnKernelDataType_t)0>(int, int)", "data-movement"),
    # elementwise and BatchNorm
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "CUDAFunctor_add<float>, at::detail::Array<char*, 3> >", "fusion"),
    ("void at::native::elementwise_kernel<128, 2, at::native::"
     "clamp_min_scalar_kernel_impl>", "fusion"),
    ("void cudnn::bn_fw_inf_1C11_kernel_NCHW<float, float, true, 1>",
     "fusion"),
    ("void at::native::batch_norm_transform_input_channels_last_kernel",
     "fusion"),
    # matmuls, the rest, and XLA's names (JAX's rules)
    ("ampere_sgemm_128x64_nn", "matmul"),
    ("nvjet_tst_128x256_64x4_1x4_h_bz_coopA_TNN", "matmul"),
    ("void cutlass::Kernel2<cutlass_75_tensorop_bf16_s1688gemm_bf16_64x64_"
     "tn_align1>", "matmul"),
    ("void at::native::(anonymous namespace)::max_pool_forward_nhwc"
     "<c10::BFloat16>", "other"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp>",
     "other"),
    ("convolution.12", "conv"),
    ("copy.3", "data-movement"),
    ("fusion.7", "fusion"),
    ("dot.1", "matmul"),
    ("convert_element_type", "other"),
])
def test_bucket_of_kernel_names(name, want):
    assert ops.bucket(name) == want


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur, "args": {"device": 0}}


def test_op_table_of_a_chrome_trace(tmp_path):
    """Two forwards' device events in a torch chrome trace: ms per
    forward by name and by bucket, host events left out."""
    events = [
        _kernel("sm90_xmma_fprop_implicit_gemm", 0.0, 1000.0),
        _kernel("sm90_xmma_fprop_implicit_gemm", 3000.0, 1000.0),
        _kernel("cudnn::bn_fw_inf_1C11_kernel_NCHW", 1000.0, 250.0),
        _kernel("cudnn::bn_fw_inf_1C11_kernel_NCHW", 4000.0, 250.0),
        _kernel("Memcpy HtoD (Pageable -> Device)", 1250.0, 600.0,
                cat="gpu_memcpy"),
        _kernel("max_pool_forward_nhwc", 1850.0, 100.0),
        {"ph": "X", "cat": "cpu_op", "name": "aten::conv2d", "pid": 1,
         "tid": 1, "ts": 0.0, "dur": 9000.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 1, "tid": 1, "ts": 0.0, "dur": 5.0},
    ]
    with open(tmp_path / "h.1.2.pt.trace.json", "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    table = ops.op_table(device_event_durations_ms(str(tmp_path)), runs=2,
                         top=3)
    assert table["op_total_ms"] == pytest.approx(1.6)
    assert table["buckets_ms"] == pytest.approx(
        {"conv": 1.0, "data-movement": 0.3, "fusion": 0.25, "other": 0.05})
    assert list(table["buckets_ms"]) == ["conv", "data-movement", "fusion",
                                         "other"]
    assert [(o["name"], o["count"], o["bucket"]) for o in table["ops"]] == [
        ("sm90_xmma_fprop_implicit_gemm", 2, "conv"),
        ("Memcpy HtoD (Pageable -> Device)", 1, "data-movement"),
        ("cudnn::bn_fw_inf_1C11_kernel_NCHW", 2, "fusion")]
    assert table["ops"][0]["ms"] == pytest.approx(1.0)


def test_ops_report_lists_buckets_and_ops():
    doc = {"model": "cmu", "hw": "656x368", "batch": 8,
           "device": "card, 700.00 W", "op_total_ms": 2.0,
           "device_p50_ms": 2.25,
           "buckets_ms": {"conv": 1.5, "fusion": 0.5},
           "ops": [{"name": "k", "ms": 1.5, "count": 16, "bucket": "conv"}]}
    text = ops.report(doc)
    assert "cmu 656x368 b=8" in text and "card, 700.00 W" in text
    assert "op-event total: 2.000 ms (device-busy p50 2.250 ms)" in text
    assert "conv                1.500 ms   75.0%" in text
    assert "x16   [conv] k" in text


# -------------------------------------------------- stage trace counting
def _rt(name, ts, corr=None):
    e = {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1,
         "tid": 1, "ts": ts, "dur": 1.0, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _dev(name, ts, corr, cat="kernel"):
    """A device event 1 s after its launch on the host's clock (drift)."""
    return _kernel(name, ts + 1e6, 1.0, cat=cat) | {
        "args": {"correlation": corr}}


def test_call_counts_of_a_chrome_trace():
    """Per ``device_p50_ms#i`` range: the kernels launched in it (by
    correlation id: their device timestamps need not lie in the range),
    and the syncs: stream and event synchronisations and blocking copies
    to the host; not ``cudaDeviceSynchronize`` (which ends every traced
    call), an asynchronous copy or a copy to the device."""
    ann = [{"ph": "X", "cat": "user_annotation", "name": f"device_p50_ms#{i}",
            "pid": 1, "tid": 1, "ts": lo, "dur": 100.0}
           for i, lo in enumerate((0.0, 200.0))]
    events = ann + [
        _rt("cudaLaunchKernel", 5.0, 1), _dev("k1", 5.0, 1),
        _rt("cudaLaunchKernel", 6.0, 2), _dev("k2", 6.0, 2),
        _rt("cudaLaunchKernel", 7.0, 3), _dev("k3", 7.0, 3),
        _rt("cudaStreamSynchronize", 30.0),
        _rt("cudaMemcpyAsync", 40.0, corr=7),
        _dev("Memcpy DtoH (Device -> Pageable)", 41.0, 7, cat="gpu_memcpy"),
        _rt("cudaDeviceSynchronize", 95.0),
        # second call: a blocking copy to the host, one to the device,
        # an event sync
        _rt("cudaLaunchKernel", 205.0, 4), _dev("k1", 205.0, 4),
        _rt("cudaMemcpy", 220.0, corr=8),
        _dev("Memcpy DtoH (Device -> Pinned)", 221.0, 8, cat="gpu_memcpy"),
        _rt("cudaMemcpy", 230.0, corr=9),
        _dev("Memcpy HtoD (Pageable -> Device)", 231.0, 9,
             cat="gpu_memcpy"),
        _rt("cudaEventSynchronize", 240.0),
        # launched outside every range
        _rt("cudaLaunchKernel", 400.0, 10), _dev("outside", 400.0, 10),
    ]
    assert stages.call_counts(events) == [{"kernels": 3, "syncs": 1},
                                          {"kernels": 1, "syncs": 2}]
