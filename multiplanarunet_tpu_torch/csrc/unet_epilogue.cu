// The epilogue of the U-Net's bf16 convolutions in eval mode, for NVIDIA
// Hopper (sm_90a): the conv's bias, the activation (ReLU or linear) and
// an eval BatchNorm in one in-place pass over the conv's output.
//
// Replaces no TPU kernel. The JAX package leaves this epilogue to XLA,
// which fuses the bias add, the activation and the BatchNorm after each
// convolution of multiplanarunet_tpu/models/unet.py. The port's U-Net
// (multiplanarunet_tpu_torch/models/unet.py) runs the convolution in cuDNN
// without its bias, then this pass; torch would otherwise run the bias add
// (aten's, after cuDNN), the activation, the cast to float32, cuDNN's
// BatchNorm and the cast back as up to five passes, each reading and
// writing the whole tensor, two of them in float32.
//
// The conv's output is a bf16 tensor dense in one of two memory orders:
// NCHW (N, C, *spatial), where element i is of channel (i / S) % C for S
// spatial elements, or channels-last (N, *spatial, C), where it is of
// channel i % C (cuDNN answers in that order where its input's strides
// suggest it). The caller passes rows of row_len elements of one channel
// each: N * C rows of S, or N * S * C rows of 1. Per element x of
// channel c, with the roundings of those ops:
//   t = bf16(float(x) + float(bf16(bias[c])))
//   r = max(t, 0) for ReLU (NaN kept), t for linear
//   y = bf16(fma(weight[c] * (float(r) - mean[c]), invstd, beta[c])),
//       invstd = rsqrtf(var[c] + eps), in float32
// and y = r without the BatchNorm. The BatchNorm's steps are those of
// cuDNN's eval kernel (bn_fw_inf_1C11_kernel_NCHW, which F.batch_norm
// runs on a float32 NCHW tensor): on an H100 with cuDNN 9.22 and CUDA
// 12.8 that form, with rsqrtf's approximate reciprocal square root,
// reproduced its float32 output exactly in every channel tried, where the
// textbook ((x - mean) * invstd) * weight + beta matched about half of
// the values.
// The float steps are round-to-nearest intrinsics, so that nvcc can
// neither contract nor reorder them.
//
// What bounds it: 2 bytes read and 2 written an element, against a few
// float operations: HBM at 3.35 TB/s. The main path's largest tensor, 46
// planes x 96 channels x 256^2 (289,406,976 elements), takes at least
// 0.346 ms. The design moves nothing else: 16-byte vector loads and
// stores (8 elements) where the tensor is 16-byte aligned and either
// the row length is a multiple of 8, so no vector straddles two channels
// (NCHW: every shape of the main path, 256^2 down to 16^2 planes and 64^3
// boxes), or rows are single elements and C a multiple of 8, so a vector
// holds 8 consecutive channels from a multiple of 8 (channels-last; their
// values read as two 16-byte loads a buffer); each block takes a
// contiguous stretch of kVec * kBlock vectors and each thread starts its
// kVec loads before it computes, for bytes in flight; the per-channel
// values are read straight from the float32 buffers (cached: a stretch
// spans few channels, or C of them), so no launch precomputes them; a
// block finds its place with one 64-bit division, each vector with a
// 32-bit one. Offsets are 64-bit. Elsewhere a scalar grid-stride loop.
// Launched on the caller's stream; no synchronisation, no allocation.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;
constexpr int kVec = 4;                    // 16-byte vectors a thread
constexpr int kStretch = kBlock * kVec;    // vectors a block

struct Args {
  const float* bias;
  const float* mean;
  const float* var;
  const float* weight;
  const float* beta;
  float eps;
};

struct Channel {
  float bias, mean, invstd, weight, beta;
};

__device__ __forceinline__ float bf16_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ uint32_t float_to_bf16(float f) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(f));
}

template <bool BN>
__device__ __forceinline__ Channel channel(const Args& a, int c) {
  Channel p;
  p.bias = bf16_to_float(float_to_bf16(__ldg(a.bias + c)));
  if (BN) {
    p.mean = __ldg(a.mean + c);
    p.invstd = rsqrtf(__fadd_rn(__ldg(a.var + c), a.eps));
    p.weight = __ldg(a.weight + c);
    p.beta = __ldg(a.beta + c);
  }
  return p;
}

template <bool RELU, bool BN>
__device__ __forceinline__ uint32_t apply(uint32_t bits, const Channel& p) {
  const float t = bf16_to_float(float_to_bf16(
      __fadd_rn(bf16_to_float(bits), p.bias)));
  const float r = (!RELU || t > 0.0f || t != t) ? t : 0.0f;
  if (!BN) return float_to_bf16(r);
  return float_to_bf16(__fmaf_rn(__fmul_rn(p.weight, __fsub_rn(r, p.mean)),
                                 p.invstd, p.beta));
}

// Two bf16 values of one 32-bit word
template <bool RELU, bool BN>
__device__ __forceinline__ uint32_t apply2(uint32_t w, const Channel& p) {
  return apply<RELU, BN>(w & 0xFFFFu, p) |
         (apply<RELU, BN>(w >> 16, p) << 16);
}

// n_vec 16-byte vectors, vpr of them a row, row r of channel r % channels
template <bool RELU, bool BN>
__global__ void __launch_bounds__(kBlock)
epilogue_vec(uint4* __restrict__ x, int64_t n_vec, uint32_t vpr,
             int channels, Args a) {
  const int64_t base = (int64_t)blockIdx.x * kStretch;
  const int64_t row0 = base / vpr;
  const uint32_t rem0 = (uint32_t)(base - row0 * vpr);
  const uint32_t c0 = (uint32_t)(row0 % channels);
  uint4 v[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int64_t i = base + k * kBlock + threadIdx.x;
    if (i < n_vec) v[k] = x[i];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const uint32_t j = k * kBlock + threadIdx.x;
    const int64_t i = base + j;
    if (i >= n_vec) break;
    const int c = (int)((c0 + (rem0 + j) / vpr) % (uint32_t)channels);
    const Channel p = channel<BN>(a, c);
    uint4 o;
    o.x = apply2<RELU, BN>(v[k].x, p);
    o.y = apply2<RELU, BN>(v[k].y, p);
    o.z = apply2<RELU, BN>(v[k].z, p);
    o.w = apply2<RELU, BN>(v[k].w, p);
    x[i] = o;
  }
}

// n_vec 16-byte vectors of a channels-last tensor (rows of one element),
// vpc of them a pixel's channels: vector v holds channels 8 (v % vpc) to
// 8 (v % vpc) + 7
template <bool RELU, bool BN>
__global__ void __launch_bounds__(kBlock)
epilogue_vec_cl(uint4* __restrict__ x, int64_t n_vec, uint32_t vpc,
                Args a) {
  const int64_t base = (int64_t)blockIdx.x * kStretch;
  const uint32_t rem0 = (uint32_t)(base % vpc);
  uint4 v[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const int64_t i = base + k * kBlock + threadIdx.x;
    if (i < n_vec) v[k] = x[i];
  }
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    const uint32_t j = k * kBlock + threadIdx.x;
    const int64_t i = base + j;
    if (i >= n_vec) break;
    const int c = 8 * (int)((rem0 + j) % vpc);
    float in[8], out[8];
    const float4* b = reinterpret_cast<const float4*>(a.bias + c);
    const float4 b0 = __ldg(b), b1 = __ldg(b + 1);
    const float bias[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    float mean[8], var[8], weight[8], beta[8];
    if (BN) {
      const float* src[4] = {a.mean, a.var, a.weight, a.beta};
      float* dst[4] = {mean, var, weight, beta};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4* q = reinterpret_cast<const float4*>(src[t] + c);
        const float4 q0 = __ldg(q), q1 = __ldg(q + 1);
        dst[t][0] = q0.x; dst[t][1] = q0.y; dst[t][2] = q0.z;
        dst[t][3] = q0.w; dst[t][4] = q1.x; dst[t][5] = q1.y;
        dst[t][6] = q1.z; dst[t][7] = q1.w;
      }
    }
    const uint32_t w[4] = {v[k].x, v[k].y, v[k].z, v[k].w};
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      Channel p;
      p.bias = bf16_to_float(float_to_bf16(bias[e]));
      if (BN) {
        p.mean = mean[e];
        p.invstd = rsqrtf(__fadd_rn(var[e], a.eps));
        p.weight = weight[e];
        p.beta = beta[e];
      }
      const uint32_t y = apply<RELU, BN>((w[e / 2] >> (16 * (e % 2))) &
                                         0xFFFFu, p);
      if (e % 2 == 0) o[e / 2] = y; else o[e / 2] |= y << 16;
    }
    x[i] = make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// n elements, row_len of them a row
template <bool RELU, bool BN>
__global__ void __launch_bounds__(kBlock)
epilogue_scalar(uint16_t* __restrict__ x, int64_t n, int64_t row_len,
                int channels, Args a) {
  const int64_t stride = (int64_t)gridDim.x * kBlock;
  for (int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride) {
    const Channel p = channel<BN>(a, (int)((i / row_len) % channels));
    x[i] = (uint16_t)apply<RELU, BN>(x[i], p);
  }
}

enum class Path { kScalar, kVec, kVecChannelsLast };

template <bool RELU, bool BN>
void launch(void* x, int64_t n, int64_t row_len, int channels,
            const Args& a, Path path, cudaStream_t s) {
  if (path == Path::kVecChannelsLast) {
    const int64_t n_vec = n / 8;
    const int64_t blocks = (n_vec + kStretch - 1) / kStretch;
    epilogue_vec_cl<RELU, BN><<<(unsigned)blocks, kBlock, 0, s>>>(
        static_cast<uint4*>(x), n_vec, (uint32_t)(channels / 8), a);
  } else if (path == Path::kVec) {
    const int64_t n_vec = n / 8;
    const int64_t blocks = (n_vec + kStretch - 1) / kStretch;
    epilogue_vec<RELU, BN><<<(unsigned)blocks, kBlock, 0, s>>>(
        static_cast<uint4*>(x), n_vec, (uint32_t)(row_len / 8), channels,
        a);
  } else {
    // A grid-stride loop over at most 2^20 blocks: enough to fill the
    // card many times over, and any n fits
    const int64_t want = (n + kBlock - 1) / kBlock;
    const unsigned grid = (unsigned)(want < (1 << 20) ? want : (1 << 20));
    epilogue_scalar<RELU, BN><<<grid, kBlock, 0, s>>>(
        static_cast<uint16_t*>(x), n, row_len, channels, a);
  }
}

}  // namespace

// In place on x, a dense bf16 (rows, row_len) tensor whose row r is of
// channel r % channels (row_len the spatial size in NCHW order, 1 in
// channels-last order): the bias (float32[channels]), then ReLU (relu 1)
// or nothing (relu 0), then, where mean is not null, the eval BatchNorm
// of float32[channels] mean, var, weight and beta and eps, on `stream`.
// Returns the launch's cudaError_t (0 on success).
extern "C" int mp_unet_epilogue(void* x, int64_t rows, int64_t row_len,
                                int channels, const float* bias, int relu,
                                const float* mean, const float* var,
                                const float* weight, const float* beta,
                                float eps, void* stream) {
  if (rows <= 0 || row_len <= 0) return 0;
  const bool bn = mean != nullptr;
  if (channels <= 0 || rows % channels != 0 || bias == nullptr ||
      (relu != 0 && relu != 1) ||
      (bn && (var == nullptr || weight == nullptr || beta == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a{bias, mean, var, weight, beta, eps};
  const int64_t n = rows * row_len;
  // A vector path's block count must fit the grid, and a row's vector
  // index plus a stretch 32 bits; the channels-last one reads the
  // per-channel values as 16-byte vectors
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool fits = aligned(x) && n / 8 / kStretch < (int64_t(1) << 31) - 1;
  Path path = Path::kScalar;
  if (fits && row_len % 8 == 0 && row_len / 8 < (int64_t(1) << 30)) {
    path = Path::kVec;
  } else if (fits && row_len == 1 && channels % 8 == 0 && aligned(bias) &&
             (!bn || (aligned(mean) && aligned(var) && aligned(weight) &&
                      aligned(beta)))) {
    path = Path::kVecChannelsLast;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (relu && bn) {
    launch<true, true>(x, n, row_len, channels, a, path, s);
  } else if (relu) {
    launch<true, false>(x, n, row_len, channels, a, path, s);
  } else if (bn) {
    launch<false, true>(x, n, row_len, channels, a, path, s);
  } else {
    launch<false, false>(x, n, row_len, channels, a, path, s);
  }
  return (int)cudaGetLastError();
}
