// K6: a conv's bias and its per-channel PReLU in one pass, written into the
// conv's own output and/or its channel slice of a concat buffer.
//
// Replaces no TPU kernel: the JAX package has no BODY_25 network. It was
// added for OpenPose BODY_25 (models/body25.py), whose 99 PReLU convs each
// feed a PReLU and, inside a stage's blocks, a concat of three chained 3x3
// convs. Eagerly each such conv costs three memory-bound passes after the
// tensor-core conv: the bias add, the PReLU and the torch.cat copy. Here
// the conv runs without its bias and one pass computes, for every value
//   v = y + bias[c];  r = v > 0 ? v : v * alpha[c]
// in fp32 (__fadd_rn, __fmul_rn: no fused multiply-add, as the plain
// PyTorch version rounds), rounded once to the output type (fp32 or bf16,
// round to nearest even as PyTorch's cast), and stores r to one or two
// destinations: the conv output in place (the next conv of a block reads
// it), and the block's concat buffer at the conv's channel slice (the
// next block reads the whole buffer, so no cat copy runs).
//
// Layout: channels last in every tensor. The main path holds activations
// channels-last (the network's NHWC input permuted), so the channel stride
// is 1 and a slice of the concat buffer is a run of C channels inside each
// pixel's row of C_total. Each thread moves 16 bytes (8 bf16 or 4 fp32
// channels) a step, pixels outer, channels inner; the wrapper refuses any
// other layout, a C that is no multiple of 16 bytes' worth of values, and
// a pointer or pixel stride off 16 bytes.
//
// In place: o0 may be y itself. Each thread reads its 16 bytes of y before
// it writes the same 16 bytes, and no other thread touches them, so y is
// not declared __restrict__.
//
// Bound on an H100 (BODY_25 at 656x368, B=16, 82 x 46 outputs a plane):
// bytes. Per conv, B x 82 x 46 x C values read once and written once or
// twice in bf16 (11.6 MB read for C = 96), 2 flops a value; a launch of
// 5.8 M values takes >= 10 us at 3.35 TB/s and does 11.6 MFLOP.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

// sizes (N, H, W, C) and the pixel strides (N, H, W; the channel stride is
// 1) of y and the two destinations, in elements
struct Dims {
  long long n, h, w, c;
  long long in[3], out0[3], out1[3];
};

__device__ __forceinline__ float load(float v) { return v; }
__device__ __forceinline__ float load(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// float -> bf16 bits, round to nearest even; NaN -> 0x7fc0 (as c10's cast)
__device__ __forceinline__ uint16_t to_bf16(float f) {
  const uint32_t u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0x7fc0;
  return static_cast<uint16_t>((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

__device__ __forceinline__ float act(float y, float b, float a) {
  const float v = __fadd_rn(y, b);
  return v > 0.0f ? v : __fmul_rn(v, a);
}

// VEC channels (16 bytes) a thread a step
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bias_prelu_vec(const T* y, const float* __restrict__ bias, const float* __restrict__ alpha,
               T* o0, T* o1, const __grid_constant__ Dims d, long long total, int n_out) {
  const int cv = static_cast<int>(d.c / VEC);
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    long long pix = i / cv;
    const int c0 = static_cast<int>(i - pix * cv) * VEC;
    const long long w = pix % d.w;
    pix /= d.w;
    const long long h = pix % d.h, n = pix / d.h;
    const long long pi = n * d.in[0] + h * d.in[1] + w * d.in[2] + c0;
    const long long p0 = n * d.out0[0] + h * d.out0[1] + w * d.out0[2] + c0;
    const long long p1 = n * d.out1[0] + h * d.out1[1] + w * d.out1[2] + c0;
    union {
      uint4 raw;
      T v[VEC];
    } src, dst;
    src.raw = *reinterpret_cast<const uint4*>(y + pi);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float r = act(load(src.v[k]), bias[c0 + k], alpha[c0 + k]);
      if constexpr (sizeof(T) == 2) {
        dst.v[k] = to_bf16(r);
      } else {
        dst.v[k] = r;
      }
    }
    *reinterpret_cast<uint4*>(o0 + p0) = dst.raw;
    if (n_out > 1) *reinterpret_cast<uint4*>(o1 + p1) = dst.raw;
  }
}

template <typename T>
int launch(const void* y, const float* bias, const float* alpha, void* o0, void* o1,
           const Dims& d, int n_out, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (d.c % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = d.n * d.h * d.w * (d.c / kVec);
  if (total == 0) return static_cast<int>(cudaSuccess);
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
  bias_prelu_vec<T, kVec><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(y), bias, alpha, static_cast<T*>(o0), static_cast<T*>(o1), d, total,
      n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* tfpose_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y: the conv output without its bias; bias, alpha: (C,) fp32; o0, o1:
// destinations of y's shape and type (o1 unused where n_out == 1; o0 may
// be y). sizes: N, H, W, C; strides: the N, H, W strides of y, o0 and o1
// in that order, in elements (the channel stride is 1 in all three).
// bf16 != 0: the tensors hold bf16, else fp32. C and every pixel stride
// are multiples of 16 bytes' worth of values and every pointer is 16-byte
// aligned (the wrapper checks). Returns cudaGetLastError().
extern "C" int bias_prelu_launch(const void* y, const float* bias, const float* alpha, void* o0,
                                 void* o1, const long long* sizes, const long long* strides,
                                 int n_out, int bf16, void* stream) {
  if (n_out < 1 || n_out > 2) return static_cast<int>(cudaErrorInvalidValue);
  Dims d;
  d.n = sizes[0];
  d.h = sizes[1];
  d.w = sizes[2];
  d.c = sizes[3];
  if (d.n < 0 || d.h < 0 || d.w < 0 || d.c < 0) return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < 3; ++k) {
    d.in[k] = strides[k];
    d.out0[k] = strides[3 + k];
    d.out1[k] = n_out > 1 ? strides[6 + k] : 0;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<uint16_t>(y, bias, alpha, o0, o1, d, n_out, s)
              : launch<float>(y, bias, alpha, o0, o1, d, n_out, s);
}
