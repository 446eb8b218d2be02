// Building blocks of the fused PFN encoder layer, shared by its forward
// (pfn_fused_layer_fwd.cu) and its backward (pfn_fused_layer_bwd.cu), each of
// which is compiled into a library of its own:
//   * a bf16 cast;
//   * the f32 body's GEMM: 128 x 64 output tiles over 32-deep K tiles, four
//     warps, a three-deep cp.async ring, FMA (no TF32); A and W may be read
//     transposed (TA, TB), a batch of products may share one launch, and the
//     epilogue fuses the bias, GELU, GELU's derivative, a residual or a
//     scale; a weight gradient may split its K rows (split-K, summed in
//     order). The bf16 products run on the wgmma GEMM of pfn_gemm_sm90.cuh,
//     which takes the same epilogue modes (pfn_fused_layer.cuh dispatches);
//   * the f32 PFN attention per (32 query rows, head, item) with a (32, T)
//     score row buffer, normalised from the row (the forward) or from a
//     saved lse (the backward's recompute), and its score loop, which the
//     backward's f32 softmax kernel reuses; the bf16 attention is
//     attn_fwd_sm90 (pfn_fused_layer.cuh);
//   * the f32 LayerNorm and its row statistics.
// Rounding follows pfn_tpu/ops/fused_layer.py (see each source's note).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The same copy with cp.async (16 bytes a thread, zero-filled outside the
// bounds), so that it overlaps the products on the tile before it.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in_bounds) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(in_bounds ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int ROWS, int COLS, int LD>
__device__ __forceinline__ void cp_async_tile(T* dst, const T* __restrict__ src, size_t ld_src, int row0, int nrows,
                                              int col0, int ncols) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = COLS / VEC;
  for (int i = threadIdx.x; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH;
    const int c = (i % CH) * VEC;
    const bool in = row0 + r < nrows && col0 + c < ncols;
    cp_async16(dst + r * LD + c, in ? src + (size_t)(row0 + r) * ld_src + col0 + c : src, in);
  }
}

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

// Block tile 128 x 64 over 32-deep K tiles, four warps of 64 x 32; a ring of
// GSTAGES K tiles in shared memory filled by cp.async, so the loads of tile
// k + 2 overlap the products on tile k.
constexpr int GBM = 128, GBN = 64, GBK = 32, GSTAGES = 3;

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
// as zero. A vector of 4 f32 along A's or W's rows is loaded whole once it
// starts inside the bounds, so ragged rows are padded with zeros by the
// caller (K for A not transposed, M for A transposed, N for W are multiples
// of the vector width or padded). With ksplit > 0, batch z
// sums only its rows [z * ksplit, (z + 1) * ksplit) of K (split-K: the batch
// offsets of A and W step by ksplit rows, each z writes its own partial).
struct GemmArgs {
  const void* A;
  const void* W;
  const float* bias;
  const float* aux;
  void* out;
  void* out2;
  int M, N, K, lda, ldw, ldo, zdiv, ksplit;
  long long a_hi, a_lo, w_hi, w_lo, o_hi, o_lo;
  float scale;
};

template <bool TA, bool TB>
struct GemmSmem {
  static constexpr int LDA = (TA ? GBM : GBK) + PAD;  // A tile: (GBM, GBK), or (GBK, GBM) transposed
  static constexpr int LDW = (TB ? GBK : GBN) + PAD;  // W tile: (GBK, GBN), or (GBN, GBK) transposed
  static constexpr int LDC = GBN + 4;  // staging of the output tile
  static constexpr int w_off = round128((TA ? GBK : GBM) * LDA * 4);
  static constexpr int stage = w_off + round128((TB ? GBN : GBK) * LDW * 4);
  static constexpr int c_bytes = GBM * LDC * 4;
  // The output staging reuses the ring once the last K tile is consumed.
  static constexpr int bytes = GSTAGES * stage > c_bytes ? GSTAGES * stage : c_bytes;
};

// Grid (ceil(N/64), ceil(M/128), batches).
template <int EPI, bool TA, bool TB = false>
__global__ void __launch_bounds__(NTHREADS) gemm_kernel(const GemmArgs g) {
  using L = GemmSmem<TA, TB>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto a_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * L::stage); };
  auto w_tile = [&](int s) { return reinterpret_cast<float*>(smem + s * L::stage + L::w_off); };
  float* cs = reinterpret_cast<float*>(smem);

  const long long zh = blockIdx.z / g.zdiv, zl = blockIdx.z % g.zdiv;
  const float* A = static_cast<const float*>(g.A) + zh * g.a_hi + zl * g.a_lo;
  const float* W = static_cast<const float*>(g.W) + zh * g.w_hi + zl * g.w_lo;
  const size_t obase = (size_t)(zh * g.o_hi + zl * g.o_lo);
  const int M = g.M, N = g.N;
  const int K = g.ksplit ? min(g.ksplit, g.K - (int)blockIdx.z * g.ksplit) : g.K;
  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int k_tiles = (K + GBK - 1) / GBK;
  auto load = [&](int kt) {
    const int s = kt % GSTAGES;
    if constexpr (TA) {
      cp_async_tile<float, GBK, GBM, L::LDA>(a_tile(s), A, g.lda, kt * GBK, K, m0, M);
    } else {
      cp_async_tile<float, GBM, GBK, L::LDA>(a_tile(s), A, g.lda, m0, M, kt * GBK, K);
    }
    if constexpr (TB) {
      cp_async_tile<float, GBN, GBK, L::LDW>(w_tile(s), W, g.ldw, n0, N, kt * GBK, K);
    } else {
      cp_async_tile<float, GBK, GBN, L::LDW>(w_tile(s), W, g.ldw, kt * GBK, K, n0, N);
    }
  };
#pragma unroll
  for (int kt = 0; kt < GSTAGES - 1; ++kt) {
    if (kt < k_tiles) load(kt);
    cp_async_commit();
  }

  // Thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx + 8*j.
  const int tx = threadIdx.x % 8, ty = threadIdx.x / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<GSTAGES - 2>();
    __syncthreads();
    if (kt + GSTAGES - 1 < k_tiles) load(kt + GSTAGES - 1);
    cp_async_commit();
    const float* as = a_tile(kt % GSTAGES);
    const float* ws = w_tile(kt % GSTAGES);
#pragma unroll 4
    for (int k = 0; k < GBK; ++k) {
      float w[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = TB ? ws[(tx + 8 * j) * L::LDW + k] : ws[k * L::LDW + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = ty * 8 + i;
        const float a = TA ? as[k * L::LDA + m] : as[m * L::LDA + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, w[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) cs[(ty * 8 + i) * L::LDC + tx + 8 * j] = acc[i][j];
  __syncthreads();

  for (int i = threadIdx.x; i < GBM * GBN; i += NTHREADS) {
    const int r = i / GBN, c = i % GBN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const size_t o = obase + (size_t)m * g.ldo + n;
    float v = cs[r * L::LDC + c];
    if (g.bias) v += g.bias[n];
    float* out = static_cast<float*>(g.out);
    if constexpr (EPI == EPI_ROUND) {
      out[o] = v;
    } else if constexpr (EPI == EPI_ROUND_RESID || EPI == EPI_RESID) {
      out[o] = g.aux[o] + v;
    } else if constexpr (EPI == EPI_GELU) {
      out[o] = gelu(v);
    } else if constexpr (EPI == EPI_F32_GELU) {
      out[o] = v;
      static_cast<float*>(g.out2)[o] = gelu(v);
    } else {
      const float d = EPI == EPI_GELU_GRAD ? v * gelu_grad(g.aux[o]) : v * g.scale;
      out[o] = d;
      if (g.out2) static_cast<float*>(g.out2)[o] = d;
    }
  }
}

template <int EPI, bool TA = false, bool TB = false>
cudaError_t gemm(const GemmArgs& a, int batches, cudaStream_t stream) {
  auto kernel = gemm_kernel<EPI, TA, TB>;
  const int bytes = GemmSmem<TA, TB>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + GBN - 1) / GBN, (a.M + GBM - 1) / GBM, batches);
  kernel<<<grid, NTHREADS, bytes, stream>>>(a);
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
// blocks than the (Kin / 128) x (N / 64) output tiles, and no atomics.
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

// The key tiles that hold an allowed key for query rows [q0, q0 + ABQ): the
// train prefix [0, sep), then the tiles of the rows' own diagonal keys. No
// other entry of S or P is read or used.
struct KeyTiles {
  int n_prefix, diag_first, n;
  __device__ KeyTiles(int sep, int q0, int seq) {
    n_prefix = (sep + ABK - 1) / ABK;
    diag_first = max(n_prefix, q0 / ABK);
    const int diag_last = (min(q0 + ABQ, seq) - 1) / ABK;
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

// One block per (32 query rows, head h, item b). qkv (B*seq, 3D); writes
// attn (B*seq, D) (head h at columns h*DH ..). SAVED_LSE false: the softmax
// of each row, writing its lse (B, seq, H) (`_attn_item` :105-111); true:
// p = exp(s - lse) from the given lse, the backward's recompute (:112-114).
template <int DH, bool SAVED_LSE>
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
    if constexpr (SAVED_LSE) {
      const float ls = lse[((size_t)b * seq + query) * H + h];
      for (int c = lane; c < tpad; c += 32) prow[c] = (c < sep || c == query) ? expf(srow[c] - ls) : 0.0f;
    } else {
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

template <int DH, bool SAVED_LSE>
cudaError_t attention_f32_dh(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D, int H,
                             cudaStream_t stream) {
  const AttnLayout<DH> L(seq);
  auto kernel = attn_kernel<DH, SAVED_LSE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + ABQ - 1) / ABQ, H, B);
  kernel<<<grid, NTHREADS, L.bytes, stream>>>(static_cast<const float*>(qkv), static_cast<float*>(attn),
                                               static_cast<float*>(lse), static_cast<const int*>(sep), seq, D, H);
  return cudaGetLastError();
}

template <bool SAVED_LSE>
cudaError_t attention_f32(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D, int H,
                          cudaStream_t s) {
  switch (D / H) {
    case 16:
      return attention_f32_dh<16, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
    case 32:
      return attention_f32_dh<32, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
    case 64:
      return attention_f32_dh<64, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
    case 128:
      return attention_f32_dh<128, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
    default:
      return cudaErrorInvalidValue;
  }
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
