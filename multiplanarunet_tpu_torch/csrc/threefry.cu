// threefry2x32 draws for NVIDIA Hopper (sm_90a), bit-exact to jax.random.
//
// Replaces the random draws that XLA computes for the JAX package with
// jax.random's default PRNG (threefry2x32, jax_threefry_partitionable on):
// the Elastic noise fields (multiplanarunet_tpu/ops/elastic.py:124-126,
// 150-152), the glorot-uniform initial weights (flax init from a PRNGKey,
// multiplanarunet_tpu/models/unet.py:39) and the sort keys of
// jax.random.permutation (multiplanarunet_tpu/bin/train_fusion.py:115,
// multiplanarunet_tpu/utils/fusion/fuse_and_predict.py:1342). The JAX
// package has no Pallas kernel for these.
//
// One thread per output value i (64-bit): the counter pair (hi, lo) of
// i = hi * 2^32 + lo goes through the 20 rounds and 6 key injections of
// threefry2x32 under the key (k0, k1), and the value is the XOR of the two
// output words (jax/_src/prng.py:_threefry_random_bits_partitionable).
// mode 0 writes that 32-bit draw; mode 1 writes the float32 uniform of
// jax/_src/random.py:_uniform, max(minval, u * span + minval) with
// u = bitcast((bits >> 9) | 0x3F800000) - 1, times `scale` (a
// variance-scaling initializer's sqrt(3 * variance), 1 otherwise). The
// float steps are round-to-nearest intrinsics so that nvcc cannot contract
// them into an FMA, which XLA does not do either.
//
// What bounds it: about 75 int32 operations per value (60 in the rounds,
// 12 injections, the XOR and the counter split) against 4 bytes written;
// at Hopper's 64 int32 lanes per SM that is the ALU, not HBM, by a factor
// of about 4. The design does the least work per value: no shared memory,
// no loads, the key schedule hoisted out of the loop, rotations as
// funnel shifts (one instruction each), one coalesced 4-byte store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define MP_ROUND(r)    \
  x0 += x1;            \
  x1 = rotl(x1, r);    \
  x1 ^= x0;

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t k2, uint32_t hi,
                                                  uint32_t lo) {
  uint32_t x0 = hi + k0;
  uint32_t x1 = lo + k1;
  MP_ROUND(13) MP_ROUND(15) MP_ROUND(26) MP_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  MP_ROUND(17) MP_ROUND(29) MP_ROUND(16) MP_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  MP_ROUND(13) MP_ROUND(15) MP_ROUND(26) MP_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  MP_ROUND(17) MP_ROUND(29) MP_ROUND(16) MP_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  MP_ROUND(13) MP_ROUND(15) MP_ROUND(26) MP_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
  return x0 ^ x1;
}

#undef MP_ROUND

template <bool UNIFORM>
__global__ void __launch_bounds__(kBlock)
threefry_kernel(void* __restrict__ out, int64_t n, uint32_t k0, uint32_t k1,
                float span, float minval, float scale) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  const int64_t stride = (int64_t)gridDim.x * kBlock;
  for (int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x; i < n;
       i += stride) {
    const uint32_t bits = threefry_bits(k0, k1, k2, (uint32_t)(i >> 32),
                                        (uint32_t)i);
    if (UNIFORM) {
      const float u =
          __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f);
      const float v = fmaxf(minval, __fadd_rn(__fmul_rn(u, span), minval));
      static_cast<float*>(out)[i] = __fmul_rn(v, scale);
    } else {
      static_cast<uint32_t*>(out)[i] = bits;
    }
  }
}

}  // namespace

// n values of key (k0, k1)'s stream into `out` (uint32 for mode 0, float32
// for mode 1) on `stream`. Returns the launch's cudaError_t (0 on success).
extern "C" int mp_threefry2x32(void* out, int64_t n, uint32_t k0,
                               uint32_t k1, int mode, float span,
                               float minval, float scale, void* stream) {
  if (n <= 0) return 0;
  if (mode != 0 && mode != 1) return (int)cudaErrorInvalidValue;
  // A grid-stride loop over at most 2^20 blocks: enough to fill the card
  // many times over, and any n fits
  const int64_t want = (n + kBlock - 1) / kBlock;
  const unsigned grid = (unsigned)(want < (1 << 20) ? want : (1 << 20));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    threefry_kernel<true><<<grid, kBlock, 0, s>>>(out, n, k0, k1, span,
                                                  minval, scale);
  } else {
    threefry_kernel<false><<<grid, kBlock, 0, s>>>(out, n, k0, k1, span,
                                                   minval, scale);
  }
  return (int)cudaGetLastError();
}
