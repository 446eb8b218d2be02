// Fused PFN encoder layer, forward, for Hopper (sm_90a).
//
// Replaces: pfn_tpu/ops/fused_layer.py, `_fwd_kernel` (:125-159) with its
// attention body `_attn_item` (:85-119), as called by `_fwd_call`
// (pl.pallas_call at :324). One post-LN encoder layer:
//   qkv = cdt(x Wqkv + bqkv); PFN attention over all heads (key j allowed for
//   query i when j < sep or j == i); ao = cdt(attn Wout + bout);
//   r = LN1(x + ao); g = cdt(gelu_tanh(cdt(r) W1 + b1)); y = LN2(r + g W2 + b2).
// Every product runs in this file's kernels: no cuBLAS, no library call.
//
// Layout: x (B, T, D) f32; wqkv (D, 3D), wout (D, D), w1 (D, F), w2 (F, D) in
// the compute dtype (f32 or bf16), row-major as in the JAX package; biases
// and LayerNorm parameters f32. Outputs y and r (B, T, D) f32 and lse
// (B, T, H) f32, as `_fwd_call` gives them. Scratch from the caller: qkv
// (B*T, 3D), attn (B*T, D), rc = cdt(r) (B*T, D), g (B*T, F), all in the
// compute dtype. `sep` is read from an int32 in device memory, so one launch
// configuration serves every sep and a captured CUDA graph stays valid.
//
// Numerics follow `_fwd_kernel`, not the unfused model: qkv is rounded to the
// compute dtype after its f32 bias add; scores are f32 products of the
// rounded q and k; softmax in f32, p = e / l rounded to the compute dtype
// before P.V; the head outputs and ao are rounded; the residuals, both
// LayerNorms (eps 1e-5), the FFN hidden h1 (into the GELU) and f stay f32.
// bf16 products run on the tensor cores through WMMA (mma.sync 16x16x16, f32
// accumulate); f32 takes an FMA path, so f32 stays f32 (no TF32).
//
// Design. The TPU kernel holds the four weight matrices and a whole item's
// qkv and (T, T) scores in VMEM. A Hopper block has 227 KB of shared memory,
// less than one item's qkv at D = 512, so the layer is one call that enqueues
// a chain of kernels on the caller's stream (eight in bf16, seven in f32),
// and the intermediates pass through device memory (they and the weights,
// ~20 MB at the flagship shape, stay in the 50 MB L2):
//   0. cast  xc   = cdt(x), into the rc scratch (bf16 only)
//   1. gemm  qkv  = cdt(xc Wqkv + bqkv)
//   2. attn  per (32 query rows, head, item): scores into a (32, T) f32 row
//            buffer over the key tiles that hold an allowed key, softmax on
//            the whole row, then P.V over the same tiles; lse written
//   3. gemm  r1   = x + cdt(attn Wout + bout)          (into y)
//   4. ln    r    = LN1(r1), rc = cdt(r)
//   5. gemm  g    = cdt(gelu(rc W1 + b1))
//   6. gemm  r2   = r + (g W2 + b2)                    (into y)
//   7. ln    y    = LN2(r2), in place
// The GEMMs are 128 x 64 output tiles over 32-deep K tiles, four warps, with
// a three-deep cp.async ring so that loads overlap the products; ragged
// edges of M, N and K are masked. T is at most 512 (the (32, T) row buffer).
//
// What bounds it at the flagship shape (B 64, T 100, D 512, H 4, F 1024,
// bf16): ~28 GFLOP of products (qkv 10.1, attention <= 1.3, out 3.4, FFN
// 13.4), 28.5 us at the bf16 tensor-core peak, against ~43.5 MB of unique
// bytes (x, y, r in f32, the weights in bf16), 13 us at HBM rate. So it is
// compute bound, and nearly all of it is the four GEMMs. This design is far
// from that bound: WMMA (mma.sync) from padded shared memory rather than
// wgmma fed by TMA, 128 x 64 tiles with four warps, intermediates written
// to and re-read from L2 between the kernels, the LayerNorms as separate
// passes, and an attention kernel that stages scores and probabilities in
// shared memory. Later work: wgmma with TMA-fed rings, LayerNorm in the
// epilogue of a whole-row GEMM (N = D), one persistent kernel per layer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 128;  // four warps in every kernel
constexpr float LN_EPS = 1e-5f;
constexpr float GELU_C = 0.7978845608028654f;  // sqrt(2/pi)
constexpr float GELU_A = 0.044715f;

template <typename T>
struct Pad;  // row padding in elements: keeps rows 16-byte aligned, spreads banks
template <>
struct Pad<float> {
  static constexpr int v = 4;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int v = 8;
};

template <typename T>
constexpr bool is_bf16_v = std::is_same<T, __nv_bfloat16>::value;

__host__ __device__ constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

__device__ __forceinline__ float to_float(float x) { return x; }
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
// elements past (nrows, ncols) are zero. ncols and col0 are multiples of the
// vector width, so a vector is either wholly inside or wholly outside.
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

// ---- GEMM: out = epilogue(A W + bias) ---------------------------------------

// Block tile 128 x 64 over 32-deep K tiles, four warps of 64 x 32; a ring of
// GSTAGES K tiles in shared memory filled by cp.async, so the loads of tile
// k + 2 overlap the products on tile k.
constexpr int GBM = 128, GBN = 64, GBK = 32, GSTAGES = 3;

enum Epilogue {
  EPI_ROUND = 0,        // out (T)     = cdt(acc + bias)
  EPI_ROUND_RESID = 1,  // out (float) = resid + cdt(acc + bias)
  EPI_GELU = 2,         // out (T)     = cdt(gelu(acc + bias))
  EPI_RESID = 3,        // out (float) = resid + (acc + bias)
};

template <typename T>
struct GemmSmem {
  static constexpr int LDA = GBK + Pad<T>::v;
  static constexpr int LDW = GBN + Pad<T>::v;
  static constexpr int LDC = GBN + 4;  // f32 staging of the output tile
  static constexpr int w_off = round128(GBM * LDA * (int)sizeof(T));
  static constexpr int stage = w_off + round128(GBK * LDW * (int)sizeof(T));
  static constexpr int c_bytes = GBM * LDC * 4;
  // The output staging reuses the ring once the last K tile is consumed.
  static constexpr int bytes = GSTAGES * stage > c_bytes ? GSTAGES * stage : c_bytes;
};

// A (M, K), W (K, N), both row-major in T; bias (N,) f32; resid and a float
// out (M, N) f32. Grid (ceil(N/64), ceil(M/128)); K, N multiples of 16.
template <typename T, int EPI>
__global__ void __launch_bounds__(NTHREADS)
    gemm_kernel(const T* __restrict__ A, const T* __restrict__ W, const float* __restrict__ bias,
                const float* __restrict__ resid, void* __restrict__ out, int M, int N, int K) {
  using L = GemmSmem<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto a_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * L::stage); };
  auto w_tile = [&](int s) { return reinterpret_cast<T*>(smem + s * L::stage + L::w_off); };
  float* cs = reinterpret_cast<float*>(smem);

  const int m0 = blockIdx.y * GBM, n0 = blockIdx.x * GBN;
  const int k_tiles = (K + GBK - 1) / GBK;
  auto load = [&](int kt) {
    const int s = kt % GSTAGES;
    cp_async_tile<T, GBM, GBK, L::LDA>(a_tile(s), A, K, m0, M, kt * GBK, K);
    cp_async_tile<T, GBK, GBN, L::LDW>(w_tile(s), W, N, kt * GBK, K, n0, N);
  };
#pragma unroll
  for (int kt = 0; kt < GSTAGES - 1; ++kt) {
    if (kt < k_tiles) load(kt);
    cp_async_commit();
  }

  if constexpr (is_bf16_v<T>) {
    using namespace nvcuda;
    // Warp w owns the 64 x 32 quarter (w / 2, w % 2): 4 x 2 fragments.
    const int warp = threadIdx.x / 32;
    const int wr = (warp / 2) * 64, wc = (warp % 2) * 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
    for (int kt = 0; kt < k_tiles; ++kt) {
      cp_async_wait<GSTAGES - 2>();  // tile kt has landed
      __syncthreads();               // and every warp is done with tile kt - 1
      if (kt + GSTAGES - 1 < k_tiles) load(kt + GSTAGES - 1);
      cp_async_commit();
      const T* as = a_tile(kt % GSTAGES);
      const T* ws = w_tile(kt % GSTAGES);
#pragma unroll
      for (int kk = 0; kk < GBK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) wmma::load_matrix_sync(a[i], as + (wr + 16 * i) * L::LDA + kk, L::LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], ws + kk * L::LDW + wc + 16 * j, L::LDW);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the staging below overwrites the ring
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wr + 16 * i) * L::LDC + wc + 16 * j, acc[i][j], L::LDC, wmma::mem_row_major);
  } else {
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
      const T* as = a_tile(kt % GSTAGES);
      const T* ws = w_tile(kt % GSTAGES);
#pragma unroll 4
      for (int k = 0; k < GBK; ++k) {
        float w[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = to_float(ws[k * L::LDW + tx + 8 * j]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float a = to_float(as[(ty * 8 + i) * L::LDA + k]);
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
  }
  __syncthreads();

  for (int i = threadIdx.x; i < GBM * GBN; i += NTHREADS) {
    const int r = i / GBN, c = i % GBN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    const size_t o = (size_t)m * N + n;
    const float v = cs[r * L::LDC + c] + bias[n];
    if constexpr (EPI == EPI_ROUND) {
      static_cast<T*>(out)[o] = from_float<T>(v);
    } else if constexpr (EPI == EPI_ROUND_RESID) {
      static_cast<float*>(out)[o] = resid[o] + to_float(from_float<T>(v));
    } else if constexpr (EPI == EPI_GELU) {
      const float u = GELU_C * (v + GELU_A * v * v * v);
      static_cast<T*>(out)[o] = from_float<T>(0.5f * v * (1.0f + tanhf(u)));
    } else {
      static_cast<float*>(out)[o] = resid[o] + v;
    }
  }
}

// ---- PFN attention over one item's qkv, all heads ----------------------------

constexpr int ABQ = 32;  // query rows per block
constexpr int ABK = 64;  // keys per K/V tile

// Shared-memory layout of an attention block for sequence length `seq`; every
// region starts on a 128-byte boundary (WMMA needs 32-byte aligned fragments).
template <typename T, int DH>
struct AttnLayout {
  static constexpr int LDH = DH + Pad<T>::v;  // q rows, K/V tile rows (T)
  static constexpr int LDO = DH + 4;          // f32 output accumulator
  int LDS, LDP, q_off, kv_off, o_off, s_off, p_off, bytes;
  __host__ __device__ explicit AttnLayout(int seq) {
    const int tpad = (seq + ABK - 1) / ABK * ABK;
    LDS = tpad + 4;          // f32 scores, then e
    LDP = tpad + Pad<T>::v;  // probabilities in T
    q_off = 0;
    kv_off = q_off + round128(ABQ * LDH * (int)sizeof(T));
    o_off = kv_off + round128(ABK * LDH * (int)sizeof(T));
    s_off = o_off + round128(ABQ * LDO * 4);
    p_off = s_off + round128(ABQ * LDS * 4);
    bytes = p_off + round128(ABQ * LDP * (int)sizeof(T));
  }
};

// S[:, key0 : key0 + ABK] = scale * Q K^T for the K tile in ks.
template <typename T, int DH>
__device__ __forceinline__ void tile_scores(const T* qs, const T* ks, float* ss, int LDS, int key0, float scale) {
  constexpr int LDH = AttnLayout<T, DH>::LDH;
  if constexpr (is_bf16_v<T>) {
    using namespace nvcuda;
    // Warp w: rows 16*(w % 2), key columns 32*(w / 2) .. +32.
    const int warp = threadIdx.x / 32;
    const int r0 = (warp % 2) * 16, c0 = (warp / 2) * 32;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kd = 0; kd < DH; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + r0 * LDH + kd, LDH);
        wmma::load_matrix_sync(b, ks + (c0 + 16 * j) * LDH + kd, LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
#pragma unroll
      for (int e = 0; e < acc.num_elements; ++e) acc.x[e] *= scale;
      wmma::store_matrix_sync(ss + r0 * LDS + key0 + c0 + 16 * j, acc, LDS, wmma::mem_row_major);
    }
  } else {
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
      for (int j = 0; j < ABK / 16; ++j) kv[j] = to_float(ks[(tx + 16 * j) * LDH + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = to_float(qs[(ty * 4 + i) * LDH + d]);
#pragma unroll
        for (int j = 0; j < ABK / 16; ++j) acc[i][j] = fmaf(qv, kv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < ABK / 16; ++j) ss[(ty * 4 + i) * LDS + key0 + tx + 16 * j] = acc[i][j] * scale;
  }
}

// O += P[:, key0 : key0 + ABK] V for the V tile in vs.
template <typename T, int DH>
__device__ __forceinline__ void tile_accumulate(float* os, const T* ps, const T* vs, int LDP, int key0) {
  constexpr int LDH = AttnLayout<T, DH>::LDH;
  constexpr int LDO = AttnLayout<T, DH>::LDO;
  if constexpr (is_bf16_v<T>) {
    using namespace nvcuda;
    // The (ABQ / 16) x (DH / 16) output fragments, dealt round the warps.
    constexpr int NF = (ABQ / 16) * (DH / 16);
    for (int f = threadIdx.x / 32; f < NF; f += NTHREADS / 32) {
      const int r0 = (f % (ABQ / 16)) * 16, c0 = (f / (ABQ / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + r0 * LDO + c0, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < ABK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + r0 * LDP + key0 + kk, LDP);
        wmma::load_matrix_sync(b, vs + kk * LDH + c0, LDH);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(os + r0 * LDO + c0, acc, LDO, wmma::mem_row_major);
    }
  } else {
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
      for (int j = 0; j < DH / 16; ++j) vv[j] = to_float(vs[kk * LDH + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = to_float(ps[(ty * 4 + i) * LDP + key0 + kk]);
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) os[(ty * 4 + i) * LDO + tx + 16 * j] = acc[i][j];
  }
}

// One block per (32 query rows, head h, item b). qkv (B*seq, 3D) in T;
// writes attn (B*seq, D) in T (head h at columns h*DH ..) and lse (B, seq, H).
template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
    attn_kernel(const T* __restrict__ qkv, T* __restrict__ attn, float* __restrict__ lse,
                const int* __restrict__ sep_ptr, int seq, int D, int H) {
  const AttnLayout<T, DH> L(seq);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L.q_off);
  T* kvs = reinterpret_cast<T*>(smem + L.kv_off);
  float* os = reinterpret_cast<float*>(smem + L.o_off);
  float* ss = reinterpret_cast<float*>(smem + L.s_off);
  T* ps = reinterpret_cast<T*>(smem + L.p_off);

  const int q0 = blockIdx.x * ABQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);  // 1 / sqrt(dh), correctly rounded
  const size_t ld = 3 * (size_t)D;
  const T* item = qkv + (size_t)b * seq * ld;

  load_tile<T, ABQ, DH, AttnLayout<T, DH>::LDH>(qs, item + h * DH, ld, q0, seq, 0, DH);
  for (int i = threadIdx.x; i < ABQ * AttnLayout<T, DH>::LDO; i += NTHREADS) os[i] = 0.0f;

  // The key tiles that hold an allowed key for these rows: the train prefix
  // [0, sep), then the tiles of the rows' own diagonal keys [q0, q0 + ABQ).
  // No other entry of S or P is read or used.
  const int n_prefix = (sep + ABK - 1) / ABK;
  const int diag_first = max(n_prefix, q0 / ABK);
  const int diag_last = (min(q0 + ABQ, seq) - 1) / ABK;
  const int n_tiles = n_prefix + max(0, diag_last - diag_first + 1);
  auto tile_of = [&](int i) { return i < n_prefix ? i : diag_first + (i - n_prefix); };

  for (int i = 0; i < n_tiles; ++i) {
    const int key0 = tile_of(i) * ABK;
    load_tile<T, ABK, DH, AttnLayout<T, DH>::LDH>(kvs, item + D + h * DH, ld, key0, seq, 0, DH);
    __syncthreads();
    tile_scores<T, DH>(qs, kvs, ss, L.LDS, key0, scale);
    __syncthreads();
  }

  // Softmax over each whole row (`_attn_item` :105-111). Every row holds its
  // diagonal, so the max is finite. Warp w owns rows w*8 .. w*8+7.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tpad = L.LDS - 4;
  for (int rr = 0; rr < ABQ / (NTHREADS / 32); ++rr) {
    const int r = warp * (ABQ / (NTHREADS / 32)) + rr;
    const int query = q0 + r;
    float* srow = ss + r * L.LDS;
    T* prow = ps + r * L.LDP;
    if (query >= seq) {
      for (int c = lane; c < tpad; c += 32) prow[c] = from_float<T>(0.0f);
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
    for (int c = lane; c < tpad; c += 32) prow[c] = from_float<T>(srow[c] / l);
    if (lane == 0) lse[((size_t)b * seq + query) * H + h] = mx + logf(l);
  }
  __syncthreads();

  for (int i = 0; i < n_tiles; ++i) {
    const int key0 = tile_of(i) * ABK;
    load_tile<T, ABK, DH, AttnLayout<T, DH>::LDH>(kvs, item + 2 * D + h * DH, ld, key0, seq, 0, DH);
    __syncthreads();
    tile_accumulate<T, DH>(os, ps, kvs, L.LDP, key0);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < ABQ * DH; i += NTHREADS) {
    const int r = i / DH, c = i % DH;
    if (q0 + r < seq)
      attn[((size_t)b * seq + q0 + r) * D + h * DH + c] = from_float<T>(os[r * AttnLayout<T, DH>::LDO + c]);
  }
}

// ---- LayerNorm over rows of D, f32 ------------------------------------------

constexpr int LN_ROWS = NTHREADS / 32;  // one warp per row

// out = LN(in) * g + b (eps inside the rsqrt, `_ln_fwd`), and out_c = cdt(out)
// when out_c is not null. `in` may equal `out`: each lane writes only the
// elements it has read.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    layernorm_kernel(const float* in, const float* __restrict__ g, const float* __restrict__ beta, float* out,
                     T* __restrict__ out_c, int M, int D) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* x = in + (size_t)row * D;
  float s = 0.0f;
  for (int c = lane; c < D; c += 32) s += x[c];
  const float mu = warp_sum(s) / D;
  float v = 0.0f;
  for (int c = lane; c < D; c += 32) {
    const float d = x[c] - mu;
    v += d * d;
  }
  const float rstd = rsqrtf(warp_sum(v) / D + LN_EPS);
  for (int c = lane; c < D; c += 32) {
    const float val = (x[c] - mu) * rstd * g[c] + beta[c];
    out[(size_t)row * D + c] = val;
    if (out_c) out_c[(size_t)row * D + c] = from_float<T>(val);
  }
}

// ---- host side ---------------------------------------------------------------

template <typename T, int EPI>
cudaError_t gemm(const void* A, const void* W, const void* bias, const void* resid, void* out, int M, int N, int K,
                 cudaStream_t stream) {
  auto kernel = gemm_kernel<T, EPI>;
  const int bytes = GemmSmem<T>::bytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + GBN - 1) / GBN, (M + GBM - 1) / GBM);
  kernel<<<grid, NTHREADS, bytes, stream>>>(static_cast<const T*>(A), static_cast<const T*>(W),
                                             static_cast<const float*>(bias), static_cast<const float*>(resid), out,
                                             M, N, K);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t attention(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D, int H,
                      cudaStream_t stream) {
  const AttnLayout<T, DH> L(seq);
  auto kernel = attn_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + ABQ - 1) / ABQ, H, B);
  kernel<<<grid, NTHREADS, L.bytes, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(attn),
                                               static_cast<float*>(lse), static_cast<const int*>(sep), seq, D, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t layernorm(const void* in, const void* g, const void* b, void* out, void* out_c, int M, int D,
                      cudaStream_t stream) {
  layernorm_kernel<T><<<(M + LN_ROWS - 1) / LN_ROWS, NTHREADS, 0, stream>>>(
      static_cast<const float*>(in), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<float*>(out), static_cast<T*>(out_c), M, D);
  return cudaGetLastError();
}

#define RETURN_IF_ERROR(call)                 \
  do {                                        \
    const cudaError_t e_ = (call);            \
    if (e_ != cudaSuccess) return e_;         \
  } while (0)

template <typename T>
cudaError_t layer(const void* x, const void* wqkv, const void* bqkv, const void* wout, const void* bout,
                  const void* g1, const void* be1, const void* w1, const void* b1, const void* w2, const void* b2,
                  const void* g2, const void* be2, void* y, void* r, void* lse, void* qkv, void* attn, void* rc,
                  void* g, const void* sep, int B, int seq, int D, int H, int F, cudaStream_t s) {
  const int M = B * seq;
  // x.astype(cdt) into rc, which LN1 overwrites later; in f32 x is used as it is.
  const void* xc = x;
  if constexpr (is_bf16_v<T>) {
    const size_t n4 = (size_t)M * D / 4;
    const size_t want = (n4 + NTHREADS - 1) / NTHREADS;
    const int blocks = (int)(want < 4096 ? want : 4096);
    cast_bf16_kernel<<<blocks, NTHREADS, 0, s>>>(static_cast<const float4*>(x), static_cast<__nv_bfloat162*>(rc),
                                                 n4);
    RETURN_IF_ERROR(cudaGetLastError());
    xc = rc;
  }
  RETURN_IF_ERROR((gemm<T, EPI_ROUND>(xc, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)));
  switch (D / H) {
    case 16:
      RETURN_IF_ERROR((attention<T, 16>(qkv, attn, lse, sep, B, seq, D, H, s)));
      break;
    case 32:
      RETURN_IF_ERROR((attention<T, 32>(qkv, attn, lse, sep, B, seq, D, H, s)));
      break;
    case 64:
      RETURN_IF_ERROR((attention<T, 64>(qkv, attn, lse, sep, B, seq, D, H, s)));
      break;
    case 128:
      RETURN_IF_ERROR((attention<T, 128>(qkv, attn, lse, sep, B, seq, D, H, s)));
      break;
    default:
      return cudaErrorInvalidValue;
  }
  RETURN_IF_ERROR((gemm<T, EPI_ROUND_RESID>(attn, wout, bout, x, y, M, D, D, s)));
  RETURN_IF_ERROR((layernorm<T>(y, g1, be1, r, rc, M, D, s)));
  RETURN_IF_ERROR((gemm<T, EPI_GELU>(rc, w1, b1, nullptr, g, M, F, D, s)));
  RETURN_IF_ERROR((gemm<T, EPI_RESID>(g, w2, b2, r, y, M, D, F, s)));
  RETURN_IF_ERROR((layernorm<T>(y, g2, be2, y, nullptr, M, D, s)));
  return cudaSuccess;
}

}  // namespace

// C entry point, bound with ctypes. Enqueues the layer's kernels on
// `stream` and returns the first cudaError_t (0 on success); does not
// synchronise. The caller checks shapes: D, F multiples of 16, D / H in
// {16, 32, 64, 128}, T <= 512.
extern "C" int pfn_fused_layer_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                   const void* bout, const void* g1, const void* be1, const void* w1, const void* b1,
                                   const void* w2, const void* b2, const void* g2, const void* be2, void* y, void* r,
                                   void* lse, void* qkv, void* attn, void* rc, void* g, const void* sep, int B,
                                   int T, int D, int H, int F, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? layer<__nv_bfloat16>(x, wqkv, bqkv, wout, bout, g1, be1, w1, b1, w2, b2, g2, be2, y, r, lse, qkv,
                                     attn, rc, g, sep, B, T, D, H, F, s)
              : layer<float>(x, wqkv, bqkv, wout, bout, g1, be1, w1, b1, w2, b2, g2, be2, y, r, lse, qkv, attn, rc,
                             g, sep, B, T, D, H, F, s);
  return static_cast<int>(err);
}
