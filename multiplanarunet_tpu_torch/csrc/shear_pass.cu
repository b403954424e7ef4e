// One elementary shear pass (banded 1-D resample along one axis) for Hopper.
//
// Replaces the Pallas TPU kernel `_build_pass_call` / its inner `kernel`
// in multiplanarunet_tpu/ops/pallas_shear.py (entered through
// `pass_pallas`). Semantics are those of `_pass_jnp` in
// multiplanarunet_tpu/ops/shear.py: for a contiguous rank-4 array A
// (S0, S1, S2, C), channels last with the validity channel last, and a pass
// that resamples spatial axis m at positions depending on output index t
// (along m) and index b along one other spatial axis q,
//
//   pos(t, b) = (alpha * (t + out_lo) + gamma - in_lo) + beta * (b + q_lo)
//   out[.., t, .., c] = sum_k K(s_k - pos) * A[.., s_k, .., c]
//
// with s_k = floor(pos) + k over the 2 (linear) or 4 (Catmull-Rom) taps of
// the kernel; taps outside [0, L_in) weigh 0. The output has the input's
// axis order with axis m resized to T, and is written contiguous.
//
// What bounds it on an H100: memory bandwidth. A pass must read its input
// stage once and write its output stage once, against a handful of flops
// per element. On the main path (256^3, view 0, bf16) the 6-pass stack plan
// (cubic, C=2) moves at least 1.250 GB, 0.373 ms at 3.35 TB/s, and the remap
// plan (linear, C=8) 4.953 GB, 1.478 ms.
//
// Design (the host half is `tile_plan` in ops/shear_pass.py):
//
// * Specialised layouts, no per-element division. The contiguous stage is
//   walked as [row r][line s along m][column]: m=0 rows are i1 and columns
//   i2*C+c; m=1 rows are i0, columns i2*C+c; m=2 rows are i0*S1+i1 and a
//   line is the C channels. The kernel is templated on m, on where the q
//   index comes from (QK: none, the row, the row / S1, the row % S1, or
//   the column / C) -- the six (m, q) pairs of the planner's _ELIM_ORDER
//   plus q = none for each m -- on TAPS, on the element type and on EP, the
//   elements of one 16-byte vector that share one position. Tile
//   coordinates come from blockIdx and a loop; divisions are 32-bit, once
//   per tile or by host-computed multipliers (FastDiv). 64-bit arithmetic
//   only forms row and line base offsets (stages at 512^3 pass 2^31
//   elements). No array is indexed at run time, so ptxas reports a 0-byte
//   stack frame.
// * 16-byte accesses. A thread owns one 16-byte vector of a line: at C=8
//   bf16 (the remap) one position's channels; at C=2 bf16 (the stack) four
//   consecutive positions (EP=2: each pair of channels has its own
//   position where the position varies along the line). Any layout the
//   vectors do not fit (C=3/5 grouped remap along some axes, odd extents,
//   misaligned pointers) takes EP=1, the scalar specialisation of the same
//   kernel, with the same window.
// * A shared-memory source window. A block takes a tile of TT outputs along
//   m times IW columns (m=0/1) or RB rows times TT outputs (m=2, where a
//   line is only C wide). Position is affine in t and in the q index and
//   every float32 step of it is monotone, so the tile's extreme positions
//   lie at its corners, as `_plan_tiles` reckons them in the Pallas kernel:
//   the block evaluates the corners with the same arithmetic as the taps
//   and copies the source lines [s_lo, s_hi] that its in-range taps can
//   touch into shared memory with 16-byte cp.async. Each source element
//   then leaves device memory about once instead of TAPS times. Blocks are
//   persistent and double-buffer the window: the next tile's copy is in
//   flight while this tile's taps are summed (the Pallas kernel's own
//   pipeline, pallas_shear.py:135-163). The host bounds the window lines
//   (|alpha|*(TT-1) + |beta|*(q span-1) + TAPS + 1) and the shared memory
//   of a block (<= 227 KB).
// * No tensor cores, on purpose. The TPU kernel built a dense
//   (QB, TT, S_TILE) weight block for the MXU because matrix work was free
//   there. Here the band is 2-4 taps wide: a wgmma contraction would
//   multiply S_TILE/TAPS zeros per useful product, on an operation of a few
//   flops per byte, far below the card's 295 op/byte ridge. Each thread
//   evaluates its taps from floor(pos) and never builds W.
//
// Numerics mirror the JAX executor exactly where a floor boundary could
// flip a tap: positions and weights are float32 in the order of
// `_pass_positions` and `_tap_parts`, with explicit round-to-nearest
// intrinsics so nvcc cannot contract them into FMAs; the tap sum is float32
// in tap order, and the store rounds once to the storage type. The kernel
// is bit-equal to `shear_pass_reference`.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// q index source
constexpr int QK_NONE = 0;  // no q term
constexpr int QK_ROW = 1;   // q index = row (m=0: q=1; m=1: q=0)
constexpr int QK_DIV = 2;   // q index = row / S1 (m=2, q=0)
constexpr int QK_MOD = 3;   // q index = row % S1 (m=2, q=1)
constexpr int QK_COL = 4;   // q index = column / C (m=0/1, q=2)

// n / d for 0 <= n < 2^31 by a multiply and a shift (d >= 1)
struct FastDiv {
  uint32_t mul, shift;
  __device__ __forceinline__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, mul) + n) >> shift;
  }
};

FastDiv make_fastdiv(uint32_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const uint64_t one = 1;
  FastDiv f;
  f.mul = (uint32_t)(((one << 32) * ((one << shift) - d)) / d + 1);
  f.shift = shift;
  return f;
}

struct Args {
  int64_t row_in, line_in;    // input element strides of a row and a line
  int64_t row_out, line_out;  // the same for the output
  int L_in, T, W, C;          // pass extents, line width, channels
  int S1;                     // m=2: rows per i0
  int TT, IW, lg_iwv, RB;     // tile: outputs along m, columns,
                              // log2(IW / vector), rows (m=2)
  int R_max, pitch, align;    // window lines, smem elements of a tile
                              // row's window, first-line alignment
  int n_t, n_c, n_r;          // tiles along t, columns, rows (m=2: per i0)
  int n_tiles;
  FastDiv div_C, div_nvo, div_nr1;  // by C; by TT*C/vector and by n_r (m=2)
  float alpha, beta, gamma, out_lo, in_lo, q_lo;
};

template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Load N consecutive elements (N * sizeof(T) in {4, 8, 16} bytes, aligned)
// into float registers, and store them back rounded once
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float (&x)[N]) {
  constexpr int B = N * (int)sizeof(T);
  static_assert(B == 4 || B == 8 || B == 16, "vector width");
  if constexpr (B == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f(e[i]);
  } else if constexpr (B == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f(e[i]);
  } else {
    const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = to_f(e[i]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_16(T* p, const float (&x)[N]) {
  static_assert(N * sizeof(T) == 16, "16-byte store");
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) from_f(e + i, x[i]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// pos(t, b) in the evaluation order of the JAX package's _pass_positions
template <int QK>
__device__ __forceinline__ float position(const Args& a, int t, int b) {
  float pos = __fmul_rn(a.alpha, __fadd_rn((float)t, a.out_lo));
  pos = __fsub_rn(__fadd_rn(pos, a.gamma), a.in_lo);
  if constexpr (QK != QK_NONE) {
    pos = __fadd_rn(pos, __fmul_rn(a.beta, __fadd_rn((float)b, a.q_lo)));
  }
  return pos;
}

// First tap index and the tap weights (the order of _tap_parts)
template <int TAPS>
__device__ __forceinline__ int taps_at(float pos, float (&w)[TAPS]) {
  const float fl = floorf(pos);
  const float f = __fsub_rn(pos, fl);
  if constexpr (TAPS == 2) {
    w[0] = __fsub_rn(1.0f, f);
    w[1] = f;
    return (int)fl;
  } else {
    const float f2 = __fmul_rn(f, f);
    const float f3 = __fmul_rn(f2, f);
    w[0] = __fsub_rn(__fadd_rn(__fmul_rn(-0.5f, f), f2), __fmul_rn(0.5f, f3));
    w[1] = __fadd_rn(__fsub_rn(1.0f, __fmul_rn(2.5f, f2)), __fmul_rn(1.5f, f3));
    w[2] = __fsub_rn(__fadd_rn(__fmul_rn(0.5f, f), __fmul_rn(2.0f, f2)),
                     __fmul_rn(1.5f, f3));
    w[3] = __fadd_rn(__fmul_rn(-0.5f, f2), __fmul_rn(0.5f, f3));
    return (int)fl - 1;
  }
}

// One tile: its rows, outputs along m, columns, q range and source window
struct Tile {
  int64_t src_base, out_base;  // element offsets of the window / output corner
  int r0, nrows;               // first row, rows (m=2; 1 otherwise)
  int t0, tn;                  // first output along m, outputs
  int c0, cw;                  // first column, columns (m=0/1)
  int qa, qb;                  // q index range
  int s_lo, nr;                // first window line, window lines
};

template <int M, int QK, int TAPS>
__device__ __forceinline__ Tile make_tile(const Args& a, int tile) {
  Tile g;
  const int ci = tile % a.n_c;
  const int rest = tile / a.n_c;
  const int ti = rest % a.n_t;
  const int rt = rest / a.n_t;
  g.t0 = ti * a.TT;
  g.tn = min(a.TT, a.T - g.t0);
  if constexpr (M == 2) {
    const int i0 = (int)a.div_nr1.div((uint32_t)rt);
    const int i1 = (rt - i0 * a.n_r) * a.RB;
    g.r0 = i0 * a.S1 + i1;
    g.nrows = min(a.RB, a.S1 - i1);
    g.c0 = 0;
    g.cw = a.C;
    g.qa = (QK == QK_DIV) ? i0 : i1;
    g.qb = (QK == QK_DIV) ? i0 : i1 + g.nrows - 1;
  } else {
    g.r0 = rt;
    g.nrows = 1;
    g.c0 = ci * a.IW;
    g.cw = min(a.IW, a.W - g.c0);
    if constexpr (QK == QK_COL) {
      g.qa = (int)a.div_C.div((uint32_t)g.c0);
      g.qb = (int)a.div_C.div((uint32_t)(g.c0 + g.cw - 1));
    } else {
      g.qa = g.qb = rt;
    }
  }
  // Extreme positions at the tile's corners (each float32 step is
  // monotone in t and in the q index)
  const int t1 = g.t0 + g.tn - 1;
  const float p00 = position<QK>(a, g.t0, g.qa);
  const float p10 = position<QK>(a, t1, g.qa);
  float lo = fminf(p00, p10), hi = fmaxf(p00, p10);
  if constexpr (QK != QK_NONE) {
    const float p01 = position<QK>(a, g.t0, g.qb);
    const float p11 = position<QK>(a, t1, g.qb);
    lo = fminf(lo, fminf(p01, p11));
    hi = fmaxf(hi, fmaxf(p01, p11));
  }
  constexpr int LO_OFF = (TAPS == 2) ? 0 : -1;
  constexpr int HI_OFF = (TAPS == 2) ? 1 : 2;
  int s_lo = max((int)floorf(lo) + LO_OFF, 0);
  const int s_hi = min((int)floorf(hi) + HI_OFF, a.L_in - 1);
  s_lo &= ~(a.align - 1);  // 16-byte aligned m=2 row segments
  g.s_lo = s_lo;
  g.nr = min(max(s_hi - s_lo + 1, 0), a.R_max);
  g.src_base = (int64_t)g.r0 * a.row_in + (int64_t)s_lo * a.line_in + g.c0;
  g.out_base = (int64_t)g.r0 * a.row_out + (int64_t)g.t0 * a.line_out + g.c0;
  return g;
}

// Copy the tile's window into shared memory: [rows][lines][columns]
template <int M, typename T, int EP>
__device__ __forceinline__ void copy_window(const Args& a, const Tile& g,
                                            const T* __restrict__ src,
                                            T* win) {
  constexpr int V = Vec<T>::N;
  if constexpr (M == 2) {
    // One row's window is nr*C contiguous elements
    const int n = g.nr * a.C;
    for (int rr = 0; rr < g.nrows; ++rr) {
      const T* s = src + g.src_base + (int64_t)rr * a.row_in;
      T* d = win + rr * a.pitch;
      if constexpr (EP > 1) {
        for (int v = threadIdx.x * V; v < n; v += kThreads * V)
          cp_async16(d + v, s + v);
      } else {
        for (int v = threadIdx.x; v < n; v += kThreads) d[v] = s[v];
      }
    }
  } else {
    const int iwv = 1 << a.lg_iwv;  // vectors (or elements) per line
    const int total = g.nr << a.lg_iwv;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int k = idx >> a.lg_iwv;
      const int col = (idx & (iwv - 1)) * (EP > 1 ? V : 1);
      if (col >= g.cw) continue;
      const T* s = src + g.src_base + (int64_t)k * a.line_in + col;
      T* d = win + k * a.IW + col;
      if constexpr (EP > 1) {
        cp_async16(d, s);
      } else {
        *d = *s;
      }
    }
  }
}

// Sum the taps of one output vector (or element) from the window
template <int TAPS, typename T, int N>
__device__ __forceinline__ void accumulate(const Args& a, const T* win_col,
                                           int line, float pos, int s_lo,
                                           float (&acc)[N]) {
  float w[TAPS];
  const int first = taps_at<TAPS>(pos, w);
#pragma unroll
  for (int k = 0; k < TAPS; ++k) {
    const int s = first + k;
    if (s >= 0 && s < a.L_in) {
      float x[N];
      if constexpr (N == 1) {
        x[0] = to_f(win_col[(s - s_lo) * line]);
      } else {
        load_n<T, N>(win_col + (s - s_lo) * line, x);
      }
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc[e] = __fadd_rn(acc[e], __fmul_rn(x[e], w[k]));
    }
  }
}

template <int M, int QK, int TAPS, typename T, int EP>
__device__ __forceinline__ void compute_tile(const Args& a, const Tile& g,
                                             const T* win,
                                             T* __restrict__ dst) {
  constexpr int V = Vec<T>::N;
  constexpr int NV = (EP > 1) ? V : 1;  // elements a thread owns
  if constexpr (M == 2) {
    // Row rr, element f of the tile's output segment (t_rel * C + ch)
    const int nvo = (a.TT * a.C) / NV;
    const int total = g.nrows * nvo;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int rr = (int)a.div_nvo.div((uint32_t)idx);
      const int f = (idx - rr * nvo) * NV;
      if (f >= g.tn * a.C) continue;
      const int qi = (QK == QK_DIV) ? g.qa : g.qa + rr;
      const T* wrow = win + rr * a.pitch;
      T* out = dst + g.out_base + (int64_t)rr * a.row_out + f;
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.0f;
      if constexpr (EP == V) {  // C % V == 0: one position per vector
        const int tr = (int)a.div_C.div((uint32_t)f);
        const int ch = f - tr * a.C;
        accumulate<TAPS, T, V>(a, wrow + ch, a.C,
                               position<QK>(a, g.t0 + tr, qi), g.s_lo, acc);
      } else if constexpr (EP == 2) {  // C == 2: V/2 positions per vector
#pragma unroll
        for (int p = 0; p < V / 2; ++p) {
          float part[2] = {0.0f, 0.0f};
          accumulate<TAPS, T, 2>(a, wrow, 2,
                                 position<QK>(a, g.t0 + f / 2 + p, qi),
                                 g.s_lo, part);
          acc[2 * p] = part[0];
          acc[2 * p + 1] = part[1];
        }
      } else {
        const int tr = (int)a.div_C.div((uint32_t)f);
        const int ch = f - tr * a.C;
        accumulate<TAPS, T, 1>(a, wrow + ch, a.C,
                               position<QK>(a, g.t0 + tr, qi), g.s_lo, acc);
      }
      if constexpr (EP > 1) {
        store_16<T, V>(out, acc);
      } else {
        from_f(out, acc[0]);
      }
    }
  } else {
    const int iwv = 1 << a.lg_iwv;
    const int total = g.tn << a.lg_iwv;
    for (int idx = threadIdx.x; idx < total; idx += kThreads) {
      const int tr = idx >> a.lg_iwv;
      const int col = (idx & (iwv - 1)) * NV;
      if (col >= g.cw) continue;
      const int t = g.t0 + tr;
      T* out = dst + g.out_base + (int64_t)tr * a.line_out + col;
      float acc[NV];
#pragma unroll
      for (int e = 0; e < NV; ++e) acc[e] = 0.0f;
      if constexpr (EP == 2 && QK == QK_COL) {  // C == 2: V/2 positions
#pragma unroll
        for (int p = 0; p < V / 2; ++p) {
          float part[2] = {0.0f, 0.0f};
          const int qi = (g.c0 + col) / 2 + p;
          accumulate<TAPS, T, 2>(a, win + col + 2 * p, a.IW,
                                 position<QK>(a, t, qi), g.s_lo, part);
          acc[2 * p] = part[0];
          acc[2 * p + 1] = part[1];
        }
      } else {
        // One position for the whole vector: q from the row, or the
        // column's position when C % V == 0
        const int qi = (QK == QK_COL)
                           ? (int)a.div_C.div((uint32_t)(g.c0 + col))
                           : g.qa;
        accumulate<TAPS, T, NV>(a, win + col, a.IW, position<QK>(a, t, qi),
                                g.s_lo, acc);
      }
      if constexpr (EP > 1) {
        store_16<T, V>(out, acc);
      } else {
        from_f(out, acc[0]);
      }
    }
  }
}

// Persistent blocks walk the tiles; the window of the next tile is copied
// into the other buffer while this tile's taps are summed
// (A tile's geometry is recomputed where it is used rather than carried
// across the loop: it is a few dozen instructions per tile, and keeps the
// registers of two tiles from being live at once.)
template <int M, int QK, int TAPS, typename T, int EP>
__global__ void __launch_bounds__(kThreads, 2)
    shear_pass_kernel(const T* __restrict__ src, T* __restrict__ dst,
                      const Args a) {
  extern __shared__ uint4 smem_raw[];
  T* buf0 = reinterpret_cast<T*>(smem_raw);
  T* buf1 = buf0 + a.RB * a.pitch;
  int tile = blockIdx.x;
  if (tile >= a.n_tiles) return;
  copy_window<M, T, EP>(a, make_tile<M, QK, TAPS>(a, tile), src, buf0);
  cp_async_commit();
  bool second = false;
  for (; tile < a.n_tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < a.n_tiles) {
      copy_window<M, T, EP>(a, make_tile<M, QK, TAPS>(a, next), src,
                            second ? buf0 : buf1);
    }
    cp_async_commit();
    cp_async_wait_1();  // this tile's window has landed
    __syncthreads();
    compute_tile<M, QK, TAPS, T, EP>(a, make_tile<M, QK, TAPS>(a, tile),
                                     second ? buf1 : buf0, dst);
    __syncthreads();  // the buffer is free for the tile after next
    second = !second;
  }
}

template <int M, int QK, int TAPS, typename T, int EP>
cudaError_t launch_one(const void* src, void* dst, const Args& a,
                       int smem_bytes, int n_sm, cudaStream_t stream) {
  auto kern = shear_pass_kernel<M, QK, TAPS, T, EP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem_bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  int blocks = per_sm * n_sm;
  if (blocks > a.n_tiles) blocks = a.n_tiles;
  kern<<<blocks, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), a);
  return cudaGetLastError();
}

template <int M, int QK, int TAPS, typename T>
cudaError_t pick_ep(const void* src, void* dst, const Args& a, int ep,
                    int smem, int n_sm, cudaStream_t st) {
  constexpr int V = Vec<T>::N;
  if (ep == V)
    return launch_one<M, QK, TAPS, T, V>(src, dst, a, smem, n_sm, st);
  if (ep == 1)
    return launch_one<M, QK, TAPS, T, 1>(src, dst, a, smem, n_sm, st);
  // Two-channel positions only where the position varies along a line
  if constexpr (QK == QK_COL || M == 2) {
    if (ep == 2)
      return launch_one<M, QK, TAPS, T, 2>(src, dst, a, smem, n_sm, st);
  }
  return cudaErrorInvalidValue;
}

template <int M, int QK, typename T>
cudaError_t pick_taps(const void* src, void* dst, const Args& a, int taps,
                      int ep, int smem, int n_sm, cudaStream_t st) {
  return taps == 2 ? pick_ep<M, QK, 2, T>(src, dst, a, ep, smem, n_sm, st)
                   : pick_ep<M, QK, 4, T>(src, dst, a, ep, smem, n_sm, st);
}

template <typename T>
cudaError_t pick_layout(const void* src, void* dst, const Args& a, int m,
                        int qk, int taps, int ep, int smem, int n_sm,
                        cudaStream_t st) {
#define MP_LAYOUT(MM, QQ)                                                \
  if (m == MM && qk == QQ)                                               \
    return pick_taps<MM, QQ, T>(src, dst, a, taps, ep, smem, n_sm, st);
  MP_LAYOUT(0, QK_NONE) MP_LAYOUT(0, QK_ROW) MP_LAYOUT(0, QK_COL)
  MP_LAYOUT(1, QK_NONE) MP_LAYOUT(1, QK_ROW) MP_LAYOUT(1, QK_COL)
  MP_LAYOUT(2, QK_NONE) MP_LAYOUT(2, QK_DIV) MP_LAYOUT(2, QK_MOD)
#undef MP_LAYOUT
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16. taps: 2 = linear, 4 = Catmull-Rom. q < 0: no q axis.
// The tile geometry (tt, iw, rb, r_max, pitch, align, ep) comes from
// `tile_plan` in ops/shear_pass.py. Returns the cudaError_t of the launch
// (0 = success); allocates nothing and does not synchronise.
extern "C" int mp_shear_pass(
    const void* src, void* dst, int dtype, int taps,
    int64_t s0, int64_t s1, int64_t s2, int64_t channels,
    int m, int q, int64_t t_out,
    float alpha, float beta, float gamma, float out_lo, float in_lo,
    float q_lo, int tt, int iw, int rb, int r_max, int pitch, int align,
    int ep, void* stream) {
  if (m < 0 || m > 2 || q > 2 || q == m || (taps != 2 && taps != 4) ||
      (dtype != 0 && dtype != 1) || tt < 1 || iw < 1 || (iw & (iw - 1)) ||
      rb < 1 || r_max < 1 || align < 1 || (align & (align - 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t S[3] = {s0, s1, s2};
  const int64_t C = channels;
  const int64_t L_in = S[m], T = t_out;
  if (L_in * C == 0 || T * C == 0 || S[0] * S[1] * S[2] == 0) return 0;
  Args a;
  a.L_in = (int)L_in;
  a.T = (int)T;
  a.C = (int)C;
  a.S1 = (int)s1;
  a.alpha = alpha;
  a.beta = q < 0 ? 0.0f : beta;
  a.gamma = gamma;
  a.out_lo = out_lo;
  a.in_lo = in_lo;
  a.q_lo = q < 0 ? 0.0f : q_lo;
  int qk = QK_NONE;
  int64_t rows;
  if (m == 2) {
    a.W = (int)C;
    rows = s0 * s1;
    a.row_in = L_in * C;
    a.line_in = C;
    a.row_out = T * C;
    a.line_out = C;
    if (q == 0) qk = QK_DIV;
    if (q == 1) qk = QK_MOD;
  } else {
    const int64_t W = s2 * C;
    a.W = (int)W;
    if (m == 0) {  // rows are i1 (interleaved along the lines)
      rows = s1;
      a.row_in = W;
      a.line_in = s1 * W;
      a.row_out = W;
      a.line_out = s1 * W;
      if (q == 1) qk = QK_ROW;
    } else {  // m == 1: rows are i0
      rows = s0;
      a.row_in = L_in * W;
      a.line_in = W;
      a.row_out = T * W;
      a.line_out = W;
      if (q == 0) qk = QK_ROW;
    }
    if (q == 2) qk = QK_COL;
  }
  const int V = dtype == 0 ? 4 : 8;
  const int esize = dtype == 0 ? 4 : 2;
  a.TT = tt;
  a.IW = iw;
  int lg = 0;
  while ((1 << lg) < (ep > 1 ? iw / V : iw)) ++lg;
  a.lg_iwv = lg;
  a.RB = rb;
  a.R_max = r_max;
  a.pitch = pitch;
  a.align = align;
  a.n_t = (int)((T + tt - 1) / tt);
  if (m == 2) {
    a.n_c = 1;
    a.n_r = (int)((s1 + rb - 1) / rb);
    rows = s0 * a.n_r;
  } else {
    a.n_c = (int)((a.W + iw - 1) / iw);
    a.n_r = (int)rows;
  }
  const int64_t n_tiles = rows * a.n_t * a.n_c;
  if (n_tiles >= ((int64_t)1 << 31) || (int64_t)tt * C * rb >= (1 << 30)) {
    return (int)cudaErrorInvalidValue;
  }
  a.n_tiles = (int)n_tiles;
  a.div_C = make_fastdiv((uint32_t)C);
  a.div_nvo = make_fastdiv((uint32_t)((tt * C) / (ep > 1 ? V : 1)));
  a.div_nr1 = make_fastdiv((uint32_t)a.n_r);
  const int64_t smem = 2 * (int64_t)rb * pitch * esize;
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? (int)pick_layout<float>(src, dst, a, m, qk, taps, ep,
                                       (int)smem, n_sm, st)
             : (int)pick_layout<__nv_bfloat16>(src, dst, a, m, qk, taps, ep,
                                               (int)smem, n_sm, st);
}
