// Building blocks of the fused PFN encoder layer, shared by its forward
// (pfn_fused_layer_fwd.cu) and its backward (pfn_fused_layer_bwd.cu), each of
// which is compiled into a library of its own:
//   * a bf16 cast;
//   * the f32 body's GEMM, gemm_f32: FMA on the CUDA cores (no TF32), 128 x
//     128 output tiles over 16-deep K tiles, 256 threads with an 8 x 8
//     register tile each, read as float4 from operands staged (K, 128) in a
//     four-deep cp.async ring (an operand stored with K along its rows is
//     transposed on the store); A and W may be read transposed in place (TA,
//     TB), a batch of products may share one launch, a weight gradient may
//     split its K rows (split-K, summed in order), and the epilogue runs from
//     the registers: the bias, GELU, GELU's derivative, a residual or a
//     scale, and the column sums of each 128-row tile that a bias gradient
//     takes. The bf16 products run on the wgmma GEMM of pfn_gemm_sm90.cuh,
//     which takes the same epilogue modes (pfn_fused_layer.cuh dispatches);
//   * the f32 PFN attention: the forward's per (32 query rows, head, item)
//     with a (32, T) score row buffer, normalised from the row; the
//     backward's recompute from a saved lse, attn_recompute_f32, per 64
//     query rows on the register tiles of pfn_flash_f32.cuh, whose layout the
//     backward's f32 softmax kernel shares; the bf16 attention is
//     attn_fwd_sm90 (pfn_fused_layer.cuh);
//   * the f32 LayerNorm and its row statistics.
// Rounding follows pfn_tpu/ops/fused_layer.py (see each source's note).
//
// What bounds the f32 GEMM: every product is an FMA, 67 TFLOP/s on an H100
// SXM, and at the fused layer's shapes (M = B*T rows against K and N of
// 512-1536) the products are bound by operations. A thread's 8 x 8 tile
// takes two float4 of A and two of W for 64 FMAs a k: at four shared-memory
// wavefronts a warp's float4, as many wavefronts as FMA clocks. 256 threads
// of at most 128 registers keep two blocks, 16 warps, on an SM. On an H100
// 80GB HBM3 at 700 W a full wave (the weight gradients, split to fill one)
// runs at ~45 TFLOP/s, 2/3 of the peak; at the flagship (B 64, T 100) the
// 200, 400 and 600 tiles of N = 512, 1024 and 1536 fill 0.76, 1.52 and 2.27
// waves of the 264 slots, and those products run at 27-37 TFLOP/s. Tried
// and no faster: 8 x 16 register tiles on 128 threads (240-255 registers, 8
// warps an SM), both operands staged as they lie with 16-byte copies,
// 32-deep K tiles, explicitly double-buffered fragments.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "pfn_flash_f32.cuh"

#define RETURN_IF_ERROR(call)                 \
  do {                                        \
    const cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

namespace {

constexpr int NTHREADS = 128;  // four warps in every kernel
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;
constexpr int PAD = 4;  // f32 row padding in shared memory: keeps rows 16-byte aligned, spreads banks

template <typename T>
constexpr bool is_bf16_v = std::is_same<T, __nv_bfloat16>::value;

__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ float gelu(float v) {
  const float u = GELU_C * (v + GELU_A * v * v * v);
  return 0.5f * v * (1.0f + tanhf(u));
}

// d gelu / dv, as `_gelu_grad`.
__device__ __forceinline__ float gelu_grad(float v) {
  const float t = tanhf(GELU_C * (v + GELU_A * v * v * v));
  const float du = GELU_C * (1.0f + 3.0f * GELU_A * v * v);
  return 0.5f * (1.0f + t) + 0.5f * v * (1.0f - t * t) * du;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy the (ROWS, COLS) block at (row0, col0) of a row-major source with row
// stride `ld_src` into shared memory (row stride LD) with 16-byte loads;
// elements past (nrows, ncols) are zero. col0 is a multiple of the vector
// width, and a vector that starts before ncols is loaded whole: the source
// row must hold it (ncols a multiple of the vector width, or a padded row).
template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, size_t ld_src, int row0, int nrows,
                                          int col0, int ncols) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = COLS / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = (i % CH) * VEC;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows && col0 + c < ncols)
      raw = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld_src + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = raw;
  }
}

// cp.async and float4 loads: pfn_flash_f32.cuh's.
namespace f32t = pfn_flash_f32;
using f32t::cp_async16;
using f32t::cp_async4;
using f32t::cp_async_commit;
using f32t::cp_async_wait;
using f32t::ld4;

// ---- x.astype(cdt) ------------------------------------------------------------

// out = bf16(x), four elements a thread per step; n is a multiple of 4.
__global__ void __launch_bounds__(NTHREADS)
    cast_bf16_kernel(const float4* __restrict__ x, __nv_bfloat162* __restrict__ out, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)NTHREADS + threadIdx.x; i < n4; i += (size_t)gridDim.x * NTHREADS) {
    const float4 v = x[i];
    out[2 * i] = __floats2bfloat162_rn(v.x, v.y);
    out[2 * i + 1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

inline cudaError_t cast_bf16(const void* x, void* out, size_t n, cudaStream_t s) {
  const size_t n4 = n / 4;
  const size_t want = (n4 + NTHREADS - 1) / NTHREADS;
  const int blocks = (int)(want < 4096 ? want : 4096);
  if (blocks == 0) return cudaSuccess;
  cast_bf16_kernel<<<blocks, NTHREADS, 0, s>>>(static_cast<const float4*>(x), static_cast<__nv_bfloat162*>(out), n4);
  return cudaGetLastError();
}

// ---- f32 GEMM: out = epilogue(op(A) op(W)) ----------------------------------

// Block tile 128 x 128 over 16-deep K tiles, 256 threads (eight warps of 32
// x 64: four along M, two along N), each thread an 8 x 8 register tile; a
// ring of GSTAGES K tiles in shared memory filled by cp.async, so the loads
// of tile k + 3 overlap the products on tile k. Both operands are staged
// (K, 128): a k row holds the tile's 128 rows of A (or columns of W)
// side by side, so that a thread reads its 8 A values and 8 W values of one
// k as two float4 each. An operand whose rows in memory run along K (A not
// transposed, W transposed) is transposed on its way in, 4 bytes a copy; the
// other is copied 16 bytes at a time.
constexpr int GBM = 128, GBN = 128, GBK = 16, GSTAGES = 4, GTHREADS = 256;
constexpr int GLD = GBM + 4;  // row stride of a staged tile: the transposing copies' 16 k of one row meet 2-way
constexpr int GTILE = GBK * GLD;  // floats per staged operand tile

// The epilogue modes of both GEMMs; cdt is the compute dtype (the identity
// in f32), and out and out2 are in the dtype named.
enum Epilogue {
  EPI_ROUND = 0,        // out (cdt)   = cdt(acc + bias)
  EPI_ROUND_RESID = 1,  // out (float) = aux + cdt(acc + bias)
  EPI_GELU = 2,         // out (cdt)   = cdt(gelu(acc + bias))
  EPI_RESID = 3,        // out (float) = aux + (acc + bias)
  EPI_F32_GELU = 4,     // out (float) = acc + bias, out2 (cdt) = cdt(gelu(acc + bias))
  EPI_GELU_GRAD = 5,    // out (float) = acc * gelu'(aux), out2 (cdt) = cdt(out) if out2
  EPI_SCALE = 6,        // out (float) = acc * scale,      out2 (cdt) = cdt(out) if out2
};

// One product, or a batch of them on blockIdx.z: batch z reads A at
// a_hi * (z / zdiv) + a_lo * (z % zdiv) elements, and likewise W and the
// outputs (out, out2 and aux share one element index). A is (M, K) row-major
// with row stride lda, or, read transposed (TA), stored (K, M) with row
// stride lda; W is (K, N) with row stride ldw, or, read transposed (TB),
// stored (N, K) with row stride ldw; the outputs (M, N) with row stride ldo;
// all f32. bias (N,) f32 may be null (no bias). Rows of A and W past K read
// as zero. An operand stored with K along its rows (A, or W with TB) is read
// element by element; the other (A with TA, W) in vectors of 4 f32, loaded
// whole once they start inside the bounds, so its rows are padded with zeros
// by the caller (M for A transposed, N for W multiples of 4 or padded). N,
// ldo and the output offsets are multiples of 4. With ksplit > 0, batch z
// sums only its rows [z * ksplit, (z + 1) * ksplit) of K (split-K: the batch
// offsets of A and W step by ksplit rows, each z writes its own partial).
// With colsum, the GELU' and scale modes also write the sums of their f32
// output's columns over each 128-row tile, in row order: row (z / zdiv) *
// ceil(M / 128) + row tile of colsum (row stride ldo, columns offset by
// (z % zdiv) * o_lo), which the caller adds in order.
struct GemmArgs {
  const void* A;
  const void* W;
  const float* bias;
  const float* aux;
  void* out;
  void* out2;
  float* colsum;
  int M, N, K, lda, ldw, ldo, zdiv, ksplit;
  long long a_hi, a_lo, w_hi, w_lo, o_hi, o_lo;
  float scale;
};

// K rows [k0, k0 + GBK) of an operand stored (K, L) with row stride ld, its
// columns [l0, l0 + 128), into a staged tile; zeros past K and L.
__device__ __forceinline__ void stage_rows(float* dst, const float* __restrict__ src, int ld, int k0, int K, int l0,
                                           int L) {
#pragma unroll
  for (int it = 0; it < GBK * GBM / 4 / GTHREADS; ++it) {
    const int i = it * GTHREADS + threadIdx.x, r = i / (GBM / 4), c = (i % (GBM / 4)) * 4;
    const bool in = k0 + r < K && l0 + c < L;
    cp_async16(dst + r * GLD + c, in ? src + (size_t)(k0 + r) * ld + l0 + c : src, in);
  }
}

// The same tile of an operand stored (L, K) with row stride ld, transposed on
// the store: element (l, k) lands in k row k. Sixteen neighbouring threads
// read one row's 16 k (64 bytes).
__device__ __forceinline__ void stage_cols(float* dst, const float* __restrict__ src, int ld, int k0, int K, int l0,
                                           int L) {
#pragma unroll
  for (int it = 0; it < GBK * GBM / GTHREADS; ++it) {
    const int i = it * GTHREADS + threadIdx.x, k = i % GBK, l = i / GBK;
    const bool in = k0 + k < K && l0 + l < L;
    cp_async4(dst + k * GLD + l, in ? src + (size_t)(l0 + l) * ld + k0 + k : src, in);
  }
}

// Grid (ceil(N/128), ceil(M/128), batches). Warp w covers rows (w % 4) * 32
// and columns (w / 4) * 64 of the tile; lane (lr, lc) = (lane / 8, lane % 8)
// owns rows lr * 4 + {0..3, 16..19} and columns lc * 4 + {0..3, 32..35} of
// its warp's part, so a warp's four loads of one k read 4 and 8 distinct
// float4 (64 and 128 contiguous bytes), and its stores write whole 128-byte
// row segments.
template <int EPI, bool TA, bool TB>
__global__ void __launch_bounds__(GTHREADS, 2) gemm_f32(const GemmArgs g) {
  extern __shared__ __align__(128) float gsm[];
  const long long zh = blockIdx.z / g.zdiv, zl = blockIdx.z % g.zdiv;
  const float* A = static_cast<const float*>(g.A) + zh * g.a_hi + zl * g.a_lo;
  const float* W = static_cast<const float*>(g.W) + zh * g.w_hi + zl * g.w_lo;
  const int M = g.M, N = g.N;
  const int K = g.ksplit ? min(g.ksplit, g.K - (int)blockIdx.z * g.ksplit) : g.K;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int k_tiles = (K + GBK - 1) / GBK;
  auto load = [&](int kt) {
    float* a_s = gsm + (kt % GSTAGES) * 2 * GTILE;
    if constexpr (TA) {
      stage_rows(a_s, A, g.lda, kt * GBK, K, m0, M);
    } else {
      stage_cols(a_s, A, g.lda, kt * GBK, K, m0, M);
    }
    if constexpr (TB) {
      stage_cols(a_s + GTILE, W, g.ldw, kt * GBK, K, n0, N);
    } else {
      stage_rows(a_s + GTILE, W, g.ldw, kt * GBK, K, n0, N);
    }
  };
#pragma unroll
  for (int kt = 0; kt < GSTAGES - 1; ++kt) {
    if (kt < k_tiles) load(kt);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int am = (warp % 4) * 32 + (lane / 8) * 4, bn = (warp / 4) * 64 + (lane % 8) * 4;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();  // tile kt has landed, and every thread is done with the slot refilled next
    if (kt + GSTAGES - 1 < k_tiles) load(kt + GSTAGES - 1);
    cp_async_commit();
    const float* as = gsm + (kt % GSTAGES) * 2 * GTILE + am;
    const float* ws = gsm + (kt % GSTAGES) * 2 * GTILE + GTILE + bn;
#pragma unroll
    for (int k = 0; k < GBK; ++k) {
      const float4 a0 = ld4(as + k * GLD), a1 = ld4(as + k * GLD + 16);
      const float4 b0 = ld4(ws + k * GLD), b1 = ld4(ws + k * GLD + 32);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  // The epilogue, from the registers: a float4 of 4 columns at a time.
  constexpr bool kSums = EPI == EPI_GELU_GRAD || EPI == EPI_SCALE;
  const size_t obase = (size_t)(zh * g.o_hi + zl * g.o_lo);
  float* out = static_cast<float*>(g.out);
  float* out2 = static_cast<float*>(g.out2);
  float4 sums[2] = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), make_float4(0.0f, 0.0f, 0.0f, 0.0f)};
#pragma unroll
  for (int jg = 0; jg < 2; ++jg) {
    const int n = n0 + bn + 32 * jg;
    if (n >= N) continue;
    const float4 bias = g.bias ? ld4(g.bias + n) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + am + (i < 4 ? i : 12 + i);
      if (m >= M) continue;
      const size_t o = obase + (size_t)m * g.ldo + n;
      float v[4] = {acc[i][4 * jg] + bias.x, acc[i][4 * jg + 1] + bias.y, acc[i][4 * jg + 2] + bias.z,
                    acc[i][4 * jg + 3] + bias.w};
      if constexpr (EPI == EPI_ROUND_RESID || EPI == EPI_RESID || EPI == EPI_GELU_GRAD) {
        const float4 x = ld4(g.aux + o);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = EPI == EPI_GELU_GRAD ? v[c] * gelu_grad(xs[c]) : xs[c] + v[c];
      } else if constexpr (EPI == EPI_GELU) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = gelu(v[c]);
      } else if constexpr (EPI == EPI_SCALE) {
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] *= g.scale;
      }
      *reinterpret_cast<float4*>(out + o) = make_float4(v[0], v[1], v[2], v[3]);
      if constexpr (EPI == EPI_F32_GELU) {
        *reinterpret_cast<float4*>(out2 + o) = make_float4(gelu(v[0]), gelu(v[1]), gelu(v[2]), gelu(v[3]));
      } else if constexpr (kSums) {
        if (out2) *reinterpret_cast<float4*>(out2 + o) = make_float4(v[0], v[1], v[2], v[3]);
        sums[jg] = make_float4(sums[jg].x + v[0], sums[jg].y + v[1], sums[jg].z + v[2], sums[jg].w + v[3]);
      }
    }
  }
  if (kSums && g.colsum != nullptr) {  // uniform over the launch
    // A thread's 8 rows, then the 4 lanes of one column (lr = 0..3), then
    // the 4 warps along M, each in a fixed order.
    float* warp_sums = gsm + GSTAGES * 2 * GTILE;  // (4, GBN)
#pragma unroll
    for (int jg = 0; jg < 2; ++jg) {
#pragma unroll
      for (int off = 8; off < 32; off <<= 1) {
        sums[jg].x += __shfl_xor_sync(0xffffffffu, sums[jg].x, off);
        sums[jg].y += __shfl_xor_sync(0xffffffffu, sums[jg].y, off);
        sums[jg].z += __shfl_xor_sync(0xffffffffu, sums[jg].z, off);
        sums[jg].w += __shfl_xor_sync(0xffffffffu, sums[jg].w, off);
      }
      if (lane < 8) *reinterpret_cast<float4*>(warp_sums + (warp % 4) * GBN + bn + 32 * jg) = sums[jg];
    }
    __syncthreads();
    const int col = threadIdx.x;
    if (col < GBN && n0 + col < N) {
      const float s = warp_sums[col] + warp_sums[GBN + col] + warp_sums[2 * GBN + col] + warp_sums[3 * GBN + col];
      const int tiles_m = (M + GBM - 1) / GBM;
      g.colsum[((size_t)zh * tiles_m + blockIdx.y) * g.ldo + zl * g.o_lo + n0 + col] = s;
    }
  }
}

template <int EPI, bool TA = false, bool TB = false>
cudaError_t gemm(const GemmArgs& a, int batches, cudaStream_t stream) {
  auto kernel = gemm_f32<EPI, TA, TB>;
  constexpr int bytes = (GSTAGES * 2 * GTILE + 4 * GBN) * 4;  // the ring, then the column sums
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + GBN - 1) / GBN, (a.M + GBM - 1) / GBM, batches);
  kernel<<<grid, GTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

// One (M, K) x (K, N) product, all row-major and dense.
inline GemmArgs dense_args(const void* A, const void* W, const void* bias, const void* aux, void* out, int M, int N,
                           int K) {
  GemmArgs a{};
  a.A = A;
  a.W = W;
  a.bias = static_cast<const float*>(bias);
  a.aux = static_cast<const float*>(aux);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.lda = K;
  a.ldw = N;
  a.ldo = N;
  a.zdiv = 1;
  a.scale = 1.0f;
  return a;
}

// out[i] = sum of the `splits` partials in[s * n + i], in order of s.
__global__ void __launch_bounds__(NTHREADS)
    split_sum_kernel(const float* __restrict__ in, float* __restrict__ out, size_t n, int splits) {
  for (size_t i = blockIdx.x * (size_t)NTHREADS + threadIdx.x; i < n; i += (size_t)gridDim.x * NTHREADS) {
    float s = 0.0f;
    for (int k = 0; k < splits; ++k) s += in[k * n + i];
    out[i] = s;
  }
}

// out = the sum of `splits` (n,) f32 partials, in order.
inline cudaError_t split_sum(const void* partial, void* out, size_t n, int splits, cudaStream_t stream) {
  const size_t want = (n + NTHREADS - 1) / NTHREADS;
  split_sum_kernel<<<(int)(want < 4096 ? want : 4096), NTHREADS, 0, stream>>>(static_cast<const float*>(partial),
                                                                              static_cast<float*>(out), n, splits);
  return cudaGetLastError();
}

// A weight gradient: dW (Kin, N) = X^T dY summed over the M rows, X (M, Kin)
// and dY (M, N) row-major, all f32. With splits > 1 the M rows are cut into
// `splits` chunks (multiples of the K tile), each chunk's product goes to its
// own (Kin, N) slice of `partial`, and the slices are summed in order: more
// blocks than the (Kin / 128) x (N / 128) output tiles, and no atomics.
inline cudaError_t gemm_weight_grad(const void* X, const void* dY, void* dW, int M, int Kin, int N, int splits,
                             void* partial, cudaStream_t stream) {
  GemmArgs a = dense_args(X, dY, nullptr, nullptr, splits > 1 ? partial : dW, Kin, N, M);
  a.lda = Kin;
  if (splits > 1) {
    a.ksplit = ((M + splits - 1) / splits + GBK - 1) / GBK * GBK;
    a.a_hi = (long long)a.ksplit * Kin;
    a.w_hi = (long long)a.ksplit * N;
    a.o_hi = (long long)Kin * N;
  }
  RETURN_IF_ERROR((gemm<EPI_SCALE, true>(a, splits, stream)));
  return splits > 1 ? split_sum(partial, dW, (size_t)Kin * N, splits, stream) : cudaSuccess;
}

// ---- f32 PFN attention over one item's qkv, all heads ------------------------

constexpr int ABQ = 32;  // query rows per block
constexpr int ABK = 64;  // keys per K/V tile

// Shared-memory layout of an attention block for sequence length `seq`; every
// region starts on a 128-byte boundary.
template <int DH>
struct AttnLayout {
  static constexpr int LDH = DH + PAD;  // q rows, K/V tile rows
  static constexpr int LDO = DH + 4;    // output accumulator
  int LDS, LDP, q_off, kv_off, o_off, s_off, p_off, bytes;
  __host__ __device__ explicit AttnLayout(int seq) {
    const int tpad = (seq + ABK - 1) / ABK * ABK;
    LDS = tpad + 4;    // scores, then e
    LDP = tpad + PAD;  // probabilities
    q_off = 0;
    kv_off = q_off + round128(ABQ * LDH * 4);
    o_off = kv_off + round128(ABK * LDH * 4);
    s_off = o_off + round128(ABQ * LDO * 4);
    p_off = s_off + round128(ABQ * LDS * 4);
    bytes = p_off + round128(ABQ * LDP * 4);
  }
};

// S[:, key0 : key0 + ABK] = scale * Q K^T for the K tile in ks.
template <int DH>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks, float* ss, int LDS, int key0,
                                            float scale) {
  constexpr int LDH = AttnLayout<DH>::LDH;
  // Thread (ty, tx) owns rows ty*4 .. ty*4+3 and key columns tx + 16*j.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][ABK / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ABK / 16; ++j) acc[i][j] = 0.0f;
  for (int d = 0; d < DH; ++d) {
    float kv[ABK / 16];
#pragma unroll
    for (int j = 0; j < ABK / 16; ++j) kv[j] = ks[(tx + 16 * j) * LDH + d];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float qv = qs[(ty * 4 + i) * LDH + d];
#pragma unroll
      for (int j = 0; j < ABK / 16; ++j) acc[i][j] = fmaf(qv, kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < ABK / 16; ++j) ss[(ty * 4 + i) * LDS + key0 + tx + 16 * j] = acc[i][j] * scale;
}

// O += P[:, key0 : key0 + ABK] V for the V tile in vs.
template <int DH>
__device__ __forceinline__ void tile_accumulate(float* os, const float* ps, const float* vs, int LDP, int key0) {
  constexpr int LDH = AttnLayout<DH>::LDH;
  constexpr int LDO = AttnLayout<DH>::LDO;
  // Thread (ty, tx) owns rows ty*4 .. ty*4+3 and columns tx + 16*j.
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][DH / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) acc[i][j] = os[(ty * 4 + i) * LDO + tx + 16 * j];
  for (int kk = 0; kk < ABK; ++kk) {
    float vv[DH / 16];
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) vv[j] = vs[kk * LDH + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = ps[(ty * 4 + i) * LDP + key0 + kk];
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) os[(ty * 4 + i) * LDO + tx + 16 * j] = acc[i][j];
}

// The key tiles of ABK keys that hold an allowed key for query rows [q0, q0
// + rows): the train prefix [0, sep), then the tiles of the rows' own
// diagonal keys. No other entry of S or P is read or used.
struct KeyTiles {
  int n_prefix, diag_first, n;
  __device__ KeyTiles(int sep, int q0, int seq, int rows = ABQ) {
    n_prefix = (sep + ABK - 1) / ABK;
    diag_first = max(n_prefix, q0 / ABK);
    const int diag_last = (min(q0 + rows, seq) - 1) / ABK;
    n = n_prefix + max(0, diag_last - diag_first + 1);
  }
  __device__ int key0(int i) const { return (i < n_prefix ? i : diag_first + (i - n_prefix)) * ABK; }
};

// S for the block's rows over the allowed key tiles: qs holds the rows, each
// K (or V) tile of head h at column offset `col` of the item's rows is
// staged in kvs.
template <int DH>
__device__ __forceinline__ void block_scores(const float* qs, float* kvs, float* ss, int LDS, const float* item,
                                             size_t ld, int col, int seq, const KeyTiles& tiles, float scale) {
  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.key0(i);
    load_tile<float, ABK, DH, AttnLayout<DH>::LDH>(kvs, item + col, ld, key0, seq, 0, DH);
    __syncthreads();
    tile_scores<DH>(qs, kvs, ss, LDS, key0, scale);
    __syncthreads();
  }
}

// The forward's attention: one block per (32 query rows, head h, item b).
// qkv (B*seq, 3D); writes attn (B*seq, D) (head h at columns h*DH ..) and
// the lse of each row's softmax (B, seq, H) (`_attn_item` :105-111).
template <int DH>
__global__ void __launch_bounds__(NTHREADS)
    attn_kernel(const float* __restrict__ qkv, float* __restrict__ attn, float* __restrict__ lse,
                const int* __restrict__ sep_ptr, int seq, int D, int H) {
  const AttnLayout<DH> L(seq);
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L.q_off);
  float* kvs = reinterpret_cast<float*>(smem + L.kv_off);
  float* os = reinterpret_cast<float*>(smem + L.o_off);
  float* ss = reinterpret_cast<float*>(smem + L.s_off);
  float* ps = reinterpret_cast<float*>(smem + L.p_off);

  const int q0 = blockIdx.x * ABQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);  // 1 / sqrt(dh), correctly rounded
  const size_t ld = 3 * (size_t)D;
  const float* item = qkv + (size_t)b * seq * ld;

  load_tile<float, ABQ, DH, AttnLayout<DH>::LDH>(qs, item + h * DH, ld, q0, seq, 0, DH);
  for (int i = threadIdx.x; i < ABQ * AttnLayout<DH>::LDO; i += NTHREADS) os[i] = 0.0f;
  const KeyTiles tiles(sep, q0, seq);
  block_scores<DH>(qs, kvs, ss, L.LDS, item, ld, D + h * DH, seq, tiles, scale);

  // Softmax over each whole row. Every row holds its diagonal, so the max is
  // finite. Warp w owns rows w*8 .. w*8+7.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tpad = L.LDS - 4;
  for (int rr = 0; rr < ABQ / (NTHREADS / 32); ++rr) {
    const int r = warp * (ABQ / (NTHREADS / 32)) + rr;
    const int query = q0 + r;
    float* srow = ss + r * L.LDS;
    float* prow = ps + r * L.LDP;
    if (query >= seq) {
      for (int c = lane; c < tpad; c += 32) prow[c] = 0.0f;
      continue;
    }
    float mx = -INFINITY;
    for (int c = lane; c < tpad; c += 32)
      if (c < sep || c == query) mx = fmaxf(mx, srow[c]);
    mx = warp_max(mx);
    float l = 0.0f;
    for (int c = lane; c < tpad; c += 32) {
      const float e = (c < sep || c == query) ? expf(srow[c] - mx) : 0.0f;
      srow[c] = e;
      l += e;
    }
    l = warp_sum(l);
    for (int c = lane; c < tpad; c += 32) prow[c] = srow[c] / l;
    if (lane == 0) lse[((size_t)b * seq + query) * H + h] = mx + logf(l);
  }
  __syncthreads();

  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.key0(i);
    load_tile<float, ABK, DH, AttnLayout<DH>::LDH>(kvs, item + 2 * D + h * DH, ld, key0, seq, 0, DH);
    __syncthreads();
    tile_accumulate<DH>(os, ps, kvs, L.LDP, key0);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < ABQ * DH; i += NTHREADS) {
    const int r = i / DH, c = i % DH;
    if (q0 + r < seq) attn[((size_t)b * seq + q0 + r) * D + h * DH + c] = os[r * AttnLayout<DH>::LDO + c];
  }
}

// ---- the f32 attention's recompute from a saved lse, on register tiles -------
//
// The backward's recompute (`_attn_item` :112-114 as `_bwd_attn_kernel`
// calls it): attn = p V with p = exp(s - lse) from the forward's lse, s =
// scale q k^T. One block of 256 threads per (64 query rows, head h, item b),
// on pfn_flash_f32.cuh's register tiles: thread (tx, ty) owns rows ty + 16 r
// (r < 4); S (4 x 4 a thread) and the head output (4 x DH / 16) stay in
// registers, p passes through shared memory once a key tile as the A operand
// of O += P V. q, K and V are copied from qkv's rows in place by cp.async,
// rows past T zero-filled.
constexpr int RBQ = 64;  // query rows per block of the f32 recompute and softmax backward
constexpr int RM_ROWS = RBQ / 16;  // a thread's rows

// Allowed (query, key) pairs of the PFN rule (rows past T have none).
__device__ __forceinline__ bool pfn_allowed(int row, int key, int sep, int seq) {
  return row < seq && key < seq && (key < sep || key == row);
}

template <int DH>
struct RecomputeSmem {  // in floats
  static constexpr int LDX = f32t::ld_tile(DH);
  static constexpr int LDP = f32t::ld_scores(ABK);
  static constexpr int k_off = RBQ * LDX, v_off = k_off + ABK * LDX, p_off = v_off + ABK * LDX;
  static constexpr int bytes = (p_off + RBQ * LDP) * 4;
};

// qkv (B*seq, 3D), lse (B, seq, H); writes attn (B*seq, D), head h at
// columns h*DH. Grid (ceil(seq / 64), H, B).
template <int DH>
__global__ void __launch_bounds__(f32t::kThreads, 1)
    attn_recompute_f32(const float* __restrict__ qkv, float* __restrict__ attn, const float* __restrict__ lse,
                       const int* __restrict__ sep_ptr, int seq, int D, int H) {
  using L = RecomputeSmem<DH>;
  constexpr int RM = RM_ROWS;
  extern __shared__ __align__(16) float rsm[];
  float* qs = rsm;
  float* ks = rsm + L::k_off;
  float* vs = rsm + L::v_off;
  float* ps = rsm + L::p_off;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * RBQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);  // 1 / sqrt(dh), correctly rounded
  const int ld = 3 * D;
  const float* item = qkv + (size_t)b * seq * ld;
  const KeyTiles tiles(sep, q0, seq, RBQ);
  f32t::load_tile_async<DH, RBQ>(qs, item + h * DH, q0, seq, ld);
  f32t::cp_async_commit();
  float ls[RM], acc[RM][DH / 16];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + ty + 16 * r;
    ls[r] = row < seq ? lse[((size_t)b * seq + row) * H + h] : 0.0f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[r][c] = 0.0f;
  }
  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.key0(i);
    f32t::load_tile_async<DH, ABK>(ks, item + D + h * DH, key0, seq, ld);
    f32t::load_tile_async<DH, ABK>(vs, item + 2 * D + h * DH, key0, seq, ld);
    f32t::cp_async_commit();
    f32t::cp_async_wait<0>();
    __syncthreads();  // q, K and V are in
    float sc[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[r][j] = 0.0f;
    f32t::mma_nt<RM, 4, DH>(sc, qs + ty * L::LDX, 16 * L::LDX, ks + tx * L::LDX, 16 * L::LDX);
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * r, key = key0 + tx + 16 * j;
        ps[(ty + 16 * r) * L::LDP + tx + 16 * j] =
            pfn_allowed(row, key, sep, seq) ? expf(sc[r][j] * scale - ls[r]) : 0.0f;
      }
    __syncthreads();  // P is in
    f32t::mma_nn<RM, DH, ABK>(acc, ps + ty * L::LDP, 16 * L::LDP, vs, L::LDX, tx);
    __syncthreads();  // every thread is done with K, V and P
  }
  f32t::cp_async_wait<0>();
  const float one[RM] = {1.0f, 1.0f, 1.0f, 1.0f};
  f32t::store_rows<RM, DH>(attn + (size_t)b * seq * D + h * DH, acc, one, q0, seq, tx, ty, D);
}

// Calls launch(std::integral_constant<int, DH>{}) for the head dim dh, one
// of 16, 32, 64 and 128.
template <typename Launch>
cudaError_t by_head_dim(int dh, Launch launch) {
  switch (dh) {
    case 16:
      return launch(std::integral_constant<int, 16>{});
    case 32:
      return launch(std::integral_constant<int, 32>{});
    case 64:
      return launch(std::integral_constant<int, 64>{});
    case 128:
      return launch(std::integral_constant<int, 128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// The forward's f32 attention over all heads (attn_kernel), writing lse.
inline cudaError_t attention_f32(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D,
                                 int H, cudaStream_t stream) {
  return by_head_dim(D / H, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    const AttnLayout<DH> L(seq);
    auto kernel = attn_kernel<DH>;
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes));
    kernel<<<dim3((seq + ABQ - 1) / ABQ, H, B), NTHREADS, L.bytes, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(attn), static_cast<float*>(lse),
        static_cast<const int*>(sep), seq, D, H);
    return cudaGetLastError();
  });
}

// The backward's f32 recompute over all heads (attn_recompute_f32) from the
// forward's lse.
inline cudaError_t attention_recompute_f32(const void* qkv, void* attn, const void* lse, const void* sep, int B,
                                           int seq, int D, int H, cudaStream_t stream) {
  return by_head_dim(D / H, [&](auto dh) {
    constexpr int DH = decltype(dh)::value;
    using L = RecomputeSmem<DH>;
    auto kernel = attn_recompute_f32<DH>;
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
    kernel<<<dim3((seq + RBQ - 1) / RBQ, H, B), f32t::kThreads, L::bytes, stream>>>(
        static_cast<const float*>(qkv), static_cast<float*>(attn), static_cast<const float*>(lse),
        static_cast<const int*>(sep), seq, D, H);
    return cudaGetLastError();
  });
}

// ---- LayerNorm over rows of D, f32 ------------------------------------------

constexpr int LN_ROWS = NTHREADS / 32;  // one warp per row

// mean and rstd of one row, eps inside the rsqrt (`_ln_fwd`).
__device__ __forceinline__ void row_stats(const float* x, int D, int lane, float& mu, float& rstd) {
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += x[c];
  mu = warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = x[c] - mu;
    v += d * d;
  }
  rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
}

// out = LN(in) * g + b, and out_c = cdt(out) when out_c is not null. `in` may
// equal `out`: each lane writes only the elements it has read.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    layernorm_kernel(const float* in, const float* __restrict__ g, const float* __restrict__ beta, float* out,
                     T* __restrict__ out_c, int M, int D) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* x = in + (size_t)row * D;
  float mu, rstd;
  row_stats(x, D, lane, mu, rstd);
  for (int c = lane; c < D; c += 32) {
    const float val = (x[c] - mu) * rstd * g[c] + beta[c];
    out[(size_t)row * D + c] = val;
    if (out_c) out_c[(size_t)row * D + c] = from_float<T>(val);
  }
}

template <typename T>
cudaError_t layernorm(const void* in, const void* g, const void* b, void* out, void* out_c, int M, int D,
                      cudaStream_t stream) {
  layernorm_kernel<T><<<(M + LN_ROWS - 1) / LN_ROWS, NTHREADS, 0, stream>>>(
      static_cast<const float*>(in), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<T*>(out_c), M, D);
  return cudaGetLastError();
}

}  // namespace
