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
//   * the f32 PFN attention, attn_f32<DH, SAVED_LSE>, per 64 query rows on
//     the register tiles of pfn_flash_f32.cuh: the forward's, with an online
//     softmax that writes lse, and the backward's recompute from that lse,
//     each behind a launcher of its own; the backward's f32 softmax kernel
//     shares its layout; the bf16 attention is attn_fwd_sm90
//     (pfn_fused_layer.cuh);
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

template <typename T>
constexpr bool is_bf16_v = std::is_same<T, __nv_bfloat16>::value;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

// ---- the f32 PFN attention on register tiles ---------------------------------
//
// `_attn_item` (:85-115): attn = p V per head, with s = scale q k^T on the PFN
// rule's allowed keys (key < sep, or key == row). One kernel, attn_f32<DH,
// SAVED_LSE>, serves both of its uses: the forward (`_fwd_kernel`, lse_rows
// None), which forms the softmax from the row and writes lse, and the
// backward's recompute (`_bwd_attn_kernel`), which takes p = exp(s - lse)
// from the forward's lse. One block of 256 threads per (64 query rows, head
// h, item b), on pfn_flash_f32.cuh's register tiles: thread (tx, ty) owns
// rows ty + 16 r (r < 4) and keys tx + 16 j of each key tile; S (4 x 4 a
// thread) and the head's output (4 x DH / 16) stay in registers, and P passes
// through shared memory once a key tile as the A operand of O += P V. q, K
// and V are copied from qkv's rows in place by cp.async, rows past T
// zero-filled; K and V take turns in flight as in fwd_f32: V(i) loads while
// S = Q K(i)^T is computed, K(i + 1) while O += P V(i) is. The forward's
// softmax is online, as fwd_f32's: the running max m and the thread's
// partial row sum l in registers, O rescaled as m grows and divided by l at
// the end. So O = (sum_j e_j v_j) / l, where `_attn_item` forms p = e / l
// first: another order of f32 roundings, within the fused forward's 3e-5.
// Every row below T holds its own diagonal, so its max is finite and lse = m
// + log(l) is the plain version's. What bounds it: at the flagship (B 64, T
// 100, DH 128) its two products are 1.3 GFLOP of the layer's 27.5, and its
// 512 blocks of 119 KB run one an SM, so latency more than rate; 150-152
// registers at DH 128, no spill. On an H100 80GB HBM3 at 700 W: 0.077 ms of
// device time in the forward (the first port's (32, T) row-buffer body 0.198
// ms), 0.073 ms as the recompute.
constexpr int RBQ = 64;  // query rows per block of the f32 attention and softmax backward
constexpr int ABK = 64;  // keys per K/V tile
constexpr int RM_ROWS = RBQ / 16;  // a thread's rows

// The key tiles of ABK keys that hold an allowed key for query rows [q0, q0
// + RBQ): the train prefix [0, sep), then the tiles of the rows' own
// diagonal keys. No other entry of S or P is read or used.
struct KeyTiles {
  int n_prefix, diag_first, n;
  __device__ KeyTiles(int sep, int q0, int seq) {
    n_prefix = (sep + ABK - 1) / ABK;
    diag_first = max(n_prefix, q0 / ABK);
    const int diag_last = (min(q0 + RBQ, seq) - 1) / ABK;
    n = n_prefix + max(0, diag_last - diag_first + 1);
  }
  __device__ int key0(int i) const { return (i < n_prefix ? i : diag_first + (i - n_prefix)) * ABK; }
};

// Allowed (query, key) pairs of the PFN rule (rows past T have none).
__device__ __forceinline__ bool pfn_allowed(int row, int key, int sep, int seq) {
  return row < seq && key < seq && (key < sep || key == row);
}

template <int DH>
struct AttnF32Smem {  // in floats: q, K, V, P
  static constexpr int LDX = f32t::ld_tile(DH);
  static constexpr int LDP = f32t::ld_scores(ABK);
  static constexpr int k_off = RBQ * LDX, v_off = k_off + ABK * LDX, p_off = v_off + ABK * LDX;
  static constexpr int bytes = (p_off + RBQ * LDP) * 4;
};

// qkv (B*seq, 3D); lse (B, seq, H), written (SAVED_LSE false) or read
// (true); writes attn (B*seq, D), head h at columns h*DH. Grid (ceil(seq /
// 64), H, B).
template <int DH, bool SAVED_LSE>
__global__ void __launch_bounds__(f32t::kThreads, 1)
    attn_f32(const float* __restrict__ qkv, float* __restrict__ attn, float* __restrict__ lse,
             const int* __restrict__ sep_ptr, int seq, int D, int H) {
  using L = AttnF32Smem<DH>;
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
  const float* kb = item + D + h * DH;
  const float* vb = item + 2 * D + h * DH;
  const KeyTiles tiles(sep, q0, seq);
  f32t::load_tile_async<DH, RBQ>(qs, item + h * DH, q0, seq, ld);
  if (tiles.n > 0) f32t::load_tile_async<DH, ABK>(ks, kb, tiles.key0(0), seq, ld);
  f32t::cp_async_commit();

  // Rows ty + 16 r: m, the saved lse (SAVED_LSE) or the running max; l, the
  // thread's partial row sum (its 4 of a tile's 64 keys); the output.
  float m[RM], l[RM], acc[RM][DH / 16];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + ty + 16 * r;
    if constexpr (SAVED_LSE) {
      m[r] = row < seq ? lse[((size_t)b * seq + row) * H + h] : 0.0f;
    } else {
      m[r] = -INFINITY;
    }
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) acc[r][c] = 0.0f;
  }

  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.key0(i);
    f32t::cp_async_wait<0>();
    __syncthreads();  // K(i) is in; every thread is done with V(i - 1) and P
    f32t::load_tile_async<DH, ABK>(vs, vb, key0, seq, ld);
    f32t::cp_async_commit();

    float sc[RM][4];  // S: rows ty + 16 r, keys key0 + tx + 16 j
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[r][j] = 0.0f;
    f32t::mma_nt<RM, 4, DH>(sc, qs + ty * L::LDX, 16 * L::LDX, ks + tx * L::LDX, 16 * L::LDX);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = q0 + ty + 16 * r;
      float* prow = ps + (ty + 16 * r) * L::LDP + tx;
      if constexpr (SAVED_LSE) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          prow[16 * j] = pfn_allowed(row, key0 + tx + 16 * j, sep, seq) ? expf(sc[r][j] * scale - m[r]) : 0.0f;
      } else {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[r][j] = pfn_allowed(row, key0 + tx + 16 * j, sep, seq) ? sc[r][j] * scale : -INFINITY;
          mx = fmaxf(mx, sc[r][j]);
        }
        const float m_new = fmaxf(m[r], f32t::group_max(mx));
        const float m_ref = m_new == -INFINITY ? 0.0f : m_new;  // the row has seen no allowed key yet
        const float alpha = expf(m[r] - m_ref);                 // 0 while it has seen none
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float e = expf(sc[r][j] - m_ref);
          prow[16 * j] = e;
          sum += e;
        }
        l[r] = fmaf(l[r], alpha, sum);
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < DH / 16; ++c) acc[r][c] *= alpha;
      }
    }
    f32t::cp_async_wait<0>();
    __syncthreads();  // V(i) and P are in; every thread is done with K(i)
    if (i + 1 < tiles.n) f32t::load_tile_async<DH, ABK>(ks, kb, tiles.key0(i + 1), seq, ld);
    f32t::cp_async_commit();
    f32t::mma_nn<RM, DH, ABK>(acc, ps + ty * L::LDP, 16 * L::LDP, vs, L::LDX, tx);  // O += P V
  }
  f32t::cp_async_wait<0>();  // with no key tile (rows past T only) q's copy is still in flight

  float inv[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    if constexpr (SAVED_LSE) {
      inv[r] = 1.0f;
    } else {
      const float lt = fmaxf(f32t::group_sum(l[r]), 1e-30f);
      inv[r] = 1.0f / lt;
      const int row = q0 + ty + 16 * r;
      if (tx == 0 && row < seq) lse[((size_t)b * seq + row) * H + h] = m[r] + logf(lt);
    }
  }
  f32t::store_rows<RM, DH>(attn + (size_t)b * seq * D + h * DH, acc, inv, q0, seq, tx, ty, D);
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

template <int DH, bool SAVED_LSE>
cudaError_t launch_attn_f32(const void* qkv, void* attn, float* lse, const void* sep, int B, int seq, int D, int H,
                            cudaStream_t stream) {
  using L = AttnF32Smem<DH>;
  auto kernel = attn_f32<DH, SAVED_LSE>;
  RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
  kernel<<<dim3((seq + RBQ - 1) / RBQ, H, B), f32t::kThreads, L::bytes, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(attn), lse, static_cast<const int*>(sep), seq, D, H);
  return cudaGetLastError();
}

// The forward's f32 attention over all heads, writing lse.
inline cudaError_t attention_f32(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D,
                                 int H, cudaStream_t stream) {
  return by_head_dim(D / H, [&](auto dh) {
    return launch_attn_f32<decltype(dh)::value, false>(qkv, attn, static_cast<float*>(lse), sep, B, seq, D, H,
                                                       stream);
  });
}

// The backward's f32 recompute over all heads from the forward's lse, which
// the kernel only reads.
inline cudaError_t attention_recompute_f32(const void* qkv, void* attn, const void* lse, const void* sep, int B,
                                           int seq, int D, int H, cudaStream_t stream) {
  return by_head_dim(D / H, [&](auto dh) {
    return launch_attn_f32<decltype(dh)::value, true>(qkv, attn, const_cast<float*>(static_cast<const float*>(lse)),
                                                      sep, B, seq, D, H, stream);
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
