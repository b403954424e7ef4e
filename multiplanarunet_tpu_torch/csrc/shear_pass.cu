// One elementary shear pass (banded 1-D resample along one axis) for Hopper.
//
// Replaces the Pallas TPU kernel `_build_pass_call` / its inner `kernel`
// in multiplanarunet_tpu/ops/pallas_shear.py (entered through
// `pass_pallas`). Semantics are those of `_pass_jnp` in
// multiplanarunet_tpu/ops/shear.py: for a rank-4 array A (S0, S1, S2, C),
// channels last with the validity channel last, and a pass that resamples
// spatial axis m at positions depending on output index t (along m) and
// index b along one other spatial axis q,
//
//   pos(t, b) = (alpha * (t + out_lo) + gamma - in_lo) + beta * (b + q_lo)
//   out[.., t, .., c] = sum_k K(s_k - pos) * A[.., s_k, .., c]
//
// with s_k = floor(pos) + k over the 2 (linear) or 4 (Catmull-Rom) taps of
// the kernel; taps outside [0, L_in) weigh 0. The output has the input's
// axis order with axis m resized to T, and is written contiguous.
//
// What bounds it on an H100: memory bandwidth. Each output position reads
// taps * C input values and writes C, about (taps*C + C) * bytes per output
// (bf16: 20 B for the 2-channel cubic stack pass, 48 B for the 8-channel
// linear remap pass), against a handful of flops; neighbouring t share
// taps, and those re-reads hit L1/L2 rather than HBM. The TPU kernel built
// a dense (QB, TT, S_TILE) weight block for the MXU because matrix work was
// free there; on this card the band is only 2-4 wide, so each thread
// evaluates its taps directly from floor(pos) and never builds W.
//
// Design: one thread per output spatial position (i0, i1, i2), looping over
// the C channels (contiguous; 2 or 8 on the main path). 64-bit indexing:
// stages at 512^3 x 8 channels exceed 2^31 elements. The input is addressed
// through its 4 strides, so no transpose or padding is needed (the TPU
// wrapper canonicalised to (Q, S, R*C) and padded to 8/128 tiles). This
// simple form is the correct first one; shared-memory/TMA tiling of the
// source window and tensor-core contraction are later work.
//
// Numerics mirror the JAX executor exactly where a floor boundary could
// flip a tap: positions and weights are float32 in the order of
// `_pass_positions` and `_tap_parts`, with explicit round-to-nearest
// intrinsics so nvcc cannot contract them into FMAs; the tap sum is float32
// in tap order, and the store rounds once to the storage type.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct PassArgs {
  int64_t in_size[3];     // input spatial sizes (axis m has L_in)
  int64_t in_stride[4];   // input strides in elements (3 spatial + channel)
  int64_t out_size[3];    // output spatial sizes (axis m has T)
  int64_t channels;
  int64_t n_out;          // out_size[0] * out_size[1] * out_size[2]
  int m, q;               // pass axis, coefficient axis (-1: none)
  float alpha, beta, gamma, out_lo, in_lo, q_lo;
};

template <typename T, int TAPS>
__global__ void shear_pass_kernel(const T* __restrict__ src,
                                  T* __restrict__ dst, PassArgs a) {
  const int64_t L_in = a.in_size[a.m];
  const int64_t C = a.channels;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < a.n_out; idx += (int64_t)gridDim.x * blockDim.x) {
    int64_t i[3];
    i[2] = idx % a.out_size[2];
    const int64_t r = idx / a.out_size[2];
    i[1] = r % a.out_size[1];
    i[0] = r / a.out_size[1];

    // pos = alpha*(t + out_lo) + gamma - in_lo  [+ beta*(b + q_lo)]
    float pos = __fmul_rn(a.alpha, __fadd_rn((float)i[a.m], a.out_lo));
    pos = __fsub_rn(__fadd_rn(pos, a.gamma), a.in_lo);
    if (a.q >= 0) {
      pos = __fadd_rn(pos, __fmul_rn(a.beta, __fadd_rn((float)i[a.q], a.q_lo)));
    }
    const float fl = floorf(pos);
    const float f = __fsub_rn(pos, fl);
    const int64_t s0 = (int64_t)fl;

    float w[TAPS];
    if (TAPS == 2) {
      w[0] = __fsub_rn(1.0f, f);
      w[1] = f;
    } else {
      // Catmull-Rom in the order of _tap_parts (f3 = (f*f)*f)
      const float f2 = __fmul_rn(f, f);
      const float f3 = __fmul_rn(f2, f);
      w[0] = __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, f), f2), __fmul_rn(0.5f, f3));
      w[1] = __fadd_rn(__fsub_rn(1.0f, __fmul_rn(2.5f, f2)), __fmul_rn(1.5f, f3));
      w[2] = __fsub_rn(__fadd_rn(__fmul_rn(0.5f, f), __fmul_rn(2.0f, f2)),
                       __fmul_rn(1.5f, f3));
      w[3] = __fadd_rn(__fmul_rn(-0.5f, f2), __fmul_rn(0.5f, f3));
    }
    const int64_t first = (TAPS == 2) ? s0 : s0 - 1;

    // Input offset of this position with the pass axis term left out
    int64_t base = 0;
    for (int ax = 0; ax < 3; ++ax) {
      if (ax != a.m) base += i[ax] * a.in_stride[ax];
    }
    const int64_t sm = a.in_stride[a.m];
    T* out = dst + idx * C;
    for (int64_t c = 0; c < C; ++c) {
      const T* in_c = src + base + c * a.in_stride[3];
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < TAPS; ++k) {
        const int64_t s = first + k;
        if (s >= 0 && s < L_in) {
          acc = __fadd_rn(acc, __fmul_rn(load_f(in_c + s * sm), w[k]));
        }
      }
      store_f(out + c, acc);
    }
  }
}

template <typename T>
cudaError_t launch(const void* src, void* dst, const PassArgs& a, int taps,
                   cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (a.n_out + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  if (taps == 2) {
    shear_pass_kernel<T, 2><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), a);
  } else {
    shear_pass_kernel<T, 4><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(src), static_cast<T*>(dst), a);
  }
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16. taps: 2 = linear, 4 = Catmull-Rom. q < 0: no q axis.
// Returns the cudaError_t of the launch (0 = success); allocates nothing
// and does not synchronise.
extern "C" int mp_shear_pass(
    const void* src, void* dst, int dtype, int taps,
    int64_t s0, int64_t s1, int64_t s2, int64_t channels,
    int64_t st0, int64_t st1, int64_t st2, int64_t stc,
    int m, int q, int64_t t_out,
    float alpha, float beta, float gamma, float out_lo, float in_lo,
    float q_lo, void* stream) {
  if (m < 0 || m > 2 || q > 2 || q == m || (taps != 2 && taps != 4) ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  PassArgs a;
  a.in_size[0] = s0;
  a.in_size[1] = s1;
  a.in_size[2] = s2;
  a.in_stride[0] = st0;
  a.in_stride[1] = st1;
  a.in_stride[2] = st2;
  a.in_stride[3] = stc;
  for (int ax = 0; ax < 3; ++ax) a.out_size[ax] = a.in_size[ax];
  a.out_size[m] = t_out;
  a.channels = channels;
  a.n_out = a.out_size[0] * a.out_size[1] * a.out_size[2];
  a.m = m;
  a.q = q;
  a.alpha = alpha;
  a.beta = beta;
  a.gamma = gamma;
  a.out_lo = out_lo;
  a.in_lo = in_lo;
  a.q_lo = q_lo;
  if (a.n_out == 0 || channels == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? (int)launch<float>(src, dst, a, taps, st)
                    : (int)launch<__nv_bfloat16>(src, dst, a, taps, st);
}
