// PFN flash-attention backward for Hopper (sm_90a): the dq kernel and the
// dk/dv kernel.
//
// Replaces: pfn_tpu/ops/flash_attention.py, `_bwd_impl`'s two Pallas calls,
// both variants (`include_diag=true`, the PFN rule of `_flash`; and
// `include_diag=false`, the prefix rule of `_flash_prefix`, Tq may differ
// from Tk):
//   * `_bwd_dq_kernel` (:123-160, pl.pallas_call at :315):
//       dq_i = sum_j ds_ij k_j;
//   * `_bwd_dkv_kernel` (:163-209, pl.pallas_call at :340):
//       dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i;
// with s = q k^T (q pre-scaled by the caller), p = exp(s - lse) on the
// allowed entries and 0 elsewhere, dp = dO v^T and ds = p (dp - delta).
// delta = rowsum(dO * o) (minus dlse in the prefix variant) is computed by
// the caller in f32, as `_bwd_impl` computes it outside its kernels (:296).
//
// Layout: q, dO (BH, Tq, D) and k, v (BH, Tk, D), contiguous, all float or
// all bf16; lse and delta (BH, Tq) f32, lse from the forward kernel. Writes
// dq (BH, Tq, D) and dk, dv (BH, Tk, D) in the input dtype. `sep` is read
// from an int32 in device memory, as in the forward.
//
// Design. The JAX package's split into two kernels is kept, so that neither
// needs atomics and the backward is deterministic.
//   * dq: one block per (64-row query tile, b*h), four warps. It loops over
//     the KV tiles that the forward visits: tiles 0 .. ceil(sep/64)-1, then,
//     in the diagonal variant, the tile(s) holding the block's own diagonal.
//   * dk/dv: one block per (64-key tile, b*h). A tile that starts below sep
//     loops over every query tile; a tile at or past sep loops only over the
//     query tile(s) holding its diagonal (diagonal variant) or over none
//     (prefix variant), and then writes zeros.
// Masked entries get p = 0 explicitly, never exp(s - lse): a prefix row with
// no allowed key has lse = -1e30, which would give exp(-1e30 + 1e30) = 1.
// Rows past Tq and keys past Tk are masked by bounds, so the caller pads
// nothing. Rounding follows the TPU kernels: s, dp and ds in f32; p rounded
// to dO's dtype before P^T dO; ds rounded to the input dtype before dS K and
// dS^T Q; every accumulator f32. bf16 products run on the tensor cores
// through WMMA (mma.sync 16x16x16, f32 accumulate); f32 inputs take an FMA
// path, so f32 stays f32 (no TF32).
//
// Shared memory: every tile, the f32 score tiles and the f32 accumulators
// live in shared memory. At f32 and D = 128 a 64-row query tile would put
// the dk/dv block at ~235 KB, over the 227 KB a block may use, so that one
// instantiation walks 32-row query tiles (186 KB); f32 writes p and ds over
// s and dp in place.
//
// What bounds it at the main-path shape (B*H = 16, T = 2010, D = 128, bf16,
// sep ~ 1000): the dq kernel does three T x sep x D products per head and
// the dk/dv kernel four, ~7 * 2 * T * sep * D = 58 GFLOP in all, 58 us at
// the bf16 tensor-core peak; the unique bytes (q, k, v, o, dO, dq, dk, dv:
// ~66 MB) take ~20 us at HBM rate. So both kernels should be compute bound.
// This first design is not: S, dP, P and dS make a round trip through
// shared memory per tile, the accumulators are reloaded from shared memory
// per tile, and nothing overlaps a tile's loads with the previous tile's
// math.
//
// Left on the table for later work, first of all the uneven work of the
// dk/dv grid: tiles below sep loop over all ceil(T/64) query tiles while
// tiles past sep take one, so a persistent schedule that balances them is
// the first thing to do. Then wgmma with TMA-fed operands, accumulators in
// registers, and the softmax recomputation on register fragments.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per dq block
constexpr int BK = 64;  // keys per KV tile, in both kernels
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one block may use

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

// Row padding (in elements) that keeps every row 16-byte aligned and spreads
// rows over the shared-memory banks.
template <typename T>
constexpr int pad = is_bf16<T> ? 8 : 4;

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Query rows per step of the dk/dv kernel (see the shared-memory note).
template <typename T, int D>
constexpr int dkv_rows = (!is_bf16<T> && D == 128) ? 32 : 64;

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

// Copy rows [row0, row0 + ROWS) of a (nrows, D) matrix into shared memory
// (row stride LD) with 16-byte loads; rows past nrows are zero-filled.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0, int nrows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// Per-row f32 values (lse or delta) of rows [row0, row0 + ROWS); 0 past nrows.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int row0, int nrows) {
  for (int r = threadIdx.x; r < ROWS; r += NTHREADS) dst[r] = row0 + r < nrows ? src[row0 + r] : 0.0f;
}

// C (M x N, f32, row stride ldc) = [C +] op(A) op(B), every operand in
// shared memory, computed by the whole block:
//   op(A)(i, k) = TA ? A[k * lda + i] : A[i * lda + k]    (M x K)
//   op(B)(k, j) = TB ? B[j * ldb + k] : B[k * ldb + j]    (K x N)
template <typename T, int M, int N, int K, bool TA, bool TB, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda, const T* B, int ldb) {
  if constexpr (is_bf16<T>) {
    using namespace nvcuda;
    using LA = typename std::conditional<TA, wmma::col_major, wmma::row_major>::type;
    using LB = typename std::conditional<TB, wmma::col_major, wmma::row_major>::type;
    // Warp w computes the 16x16 output tiles w, w + 4, w + 8, ...
    for (int t = threadIdx.x / 32; t < (M / 16) * (N / 16); t += NWARPS) {
      const int i0 = (t / (N / 16)) * 16, j0 = (t % (N / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      if (ACC) {
        wmma::load_matrix_sync(acc, C + i0 * ldc + j0, ldc, wmma::mem_row_major);
      } else {
        wmma::fill_fragment(acc, 0.0f);
      }
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
        wmma::load_matrix_sync(a, TA ? A + k0 * lda + i0 : A + i0 * lda + k0, lda);
        wmma::load_matrix_sync(b, TB ? B + j0 * ldb + k0 : B + k0 * ldb + j0, ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + i0 * ldc + j0, acc, ldc, wmma::mem_row_major);
    }
  } else {
    // Thread (ty, tx) owns rows ty*RM .. ty*RM+RM-1 and columns tx + 16*j.
    constexpr int RM = M / 8, CN = N / 16;
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = ACC ? C[(ty * RM + i) * ldc + tx + 16 * j] : 0.0f;
    for (int k = 0; k < K; ++k) {
      float b[CN];
#pragma unroll
      for (int j = 0; j < CN; ++j) b[j] = to_float(TB ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = to_float(TA ? A[k * lda + ty * RM + i] : A[(ty * RM + i) * lda + k]);
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) C[(ty * RM + i) * ldc + tx + 16 * j] = acc[i][j];
  }
}

// From S and dP (ROWS x BK, f32, row stride lds) of query rows q0.. and keys
// key0..: p = exp(s - lse) on allowed entries and 0 elsewhere, ds = p (dp -
// delta). Writes ds, and with WRITE_P also p, in T (row stride ldp). For f32
// the outputs may overwrite S and dP: each entry is read and written by one
// thread.
template <typename T, bool DIAG, bool WRITE_P, int ROWS>
__device__ __forceinline__ void tile_ds(const float* ss, const float* dps, int lds, T* ps, T* dss, int ldp,
                                        const float* lse_s, const float* delta_s, int q0, int key0, int sep, int Tq,
                                        int Tk) {
  for (int i = threadIdx.x; i < ROWS * BK; i += NTHREADS) {
    const int r = i / BK, c = i % BK;
    const int query = q0 + r, key = key0 + c;
    const bool allowed = query < Tq && key < Tk && (key < sep || (DIAG && key == query));
    const float p = allowed ? expf(ss[r * lds + c] - lse_s[r]) : 0.0f;
    const float ds = p * (dps[r * lds + c] - delta_s[r]);
    if (WRITE_P) ps[r * ldp + c] = from_float<T>(p);
    dss[r * ldp + c] = from_float<T>(ds);
  }
}

// Shared-memory layout of a dq block. Every region starts on a 128-byte
// boundary; WMMA needs 32-byte aligned fragment pointers.
template <typename T, int D>
struct DqSmem {
  static constexpr int LDX = D + pad<T>;   // q, dO, k, v tiles (elements of T)
  static constexpr int LDS = BK + 4;         // f32 S and dP
  static constexpr int LDP = BK + pad<T>;  // dS in T; f32 writes it over S
  static constexpr int LDA = D + 4;          // f32 dq accumulator
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + round128(BQ * LDX * (int)sizeof(T));
  static constexpr int k_off = do_off + round128(BQ * LDX * (int)sizeof(T));
  static constexpr int v_off = k_off + round128(BK * LDX * (int)sizeof(T));
  static constexpr int s_off = v_off + round128(BK * LDX * (int)sizeof(T));
  static constexpr int dp_off = s_off + round128(BQ * LDS * 4);
  static constexpr int ds_off = dp_off + round128(BQ * LDS * 4);
  static constexpr int acc_off = ds_off + (is_bf16<T> ? round128(BQ * LDP * (int)sizeof(T)) : 0);
  static constexpr int lse_off = acc_off + round128(BQ * LDA * 4);
  static constexpr int delta_off = lse_off + round128(BQ * 4);
  static constexpr int bytes = delta_off + round128(BQ * 4);
  static_assert(is_bf16<T> || LDP == LDS, "f32 dS is written over S");
  static_assert(bytes <= SMEM_LIMIT, "dq block over the shared-memory limit");
};

template <typename T, int D, bool DIAG>
__global__ void __launch_bounds__(NTHREADS)
    pfn_flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                            const T* __restrict__ dO, const float* __restrict__ lse,
                            const float* __restrict__ delta, T* __restrict__ dq, const int* __restrict__ sep_ptr,
                            int Tq, int Tk) {
  using L = DqSmem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* dos = reinterpret_cast<T*>(smem + L::do_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  T* dss = is_bf16<T> ? reinterpret_cast<T*>(smem + L::ds_off) : reinterpret_cast<T*>(ss);
  float* acc = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const int sep = min(max(*sep_ptr, 0), Tk);

  load_tile<T, D, BQ, L::LDX>(qs, q + (size_t)bh * Tq * D, q0, Tq);
  load_tile<T, D, BQ, L::LDX>(dos, dO + (size_t)bh * Tq * D, q0, Tq);
  load_rows<BQ>(lse_s, lse + (size_t)bh * Tq, q0, Tq);
  load_rows<BQ>(delta_s, delta + (size_t)bh * Tq, q0, Tq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += NTHREADS) acc[i] = 0.0f;
  __syncthreads();

  auto step = [&](int tile) {
    const int key0 = tile * BK;
    load_tile<T, D, BK, L::LDX>(ks, kb, key0, Tk);
    load_tile<T, D, BK, L::LDX>(vs, vb, key0, Tk);
    __syncthreads();
    mm<T, BQ, BK, D, false, true, false>(ss, L::LDS, qs, L::LDX, ks, L::LDX);    // S = Q K^T
    mm<T, BQ, BK, D, false, true, false>(dps, L::LDS, dos, L::LDX, vs, L::LDX);  // dP = dO V^T
    __syncthreads();
    tile_ds<T, DIAG, false, BQ>(ss, dps, L::LDS, nullptr, dss, L::LDP, lse_s, delta_s, q0, key0, sep, Tq, Tk);
    __syncthreads();
    mm<T, BQ, D, BK, false, false, true>(acc, L::LDA, dss, L::LDP, ks, L::LDX);  // dQ += dS K
    __syncthreads();  // the next tile overwrites ks, vs, ss, dps and dss
  };

  // The forward's loop bound: the train prefix [0, sep), then the diagonal
  // keys [q0, q0 + BQ) not yet covered (Tq == Tk in that variant).
  const int n_prefix = (sep + BK - 1) / BK;
  for (int tile = 0; tile < n_prefix; ++tile) step(tile);
  if (DIAG) {
    const int last = (min(q0 + BQ, Tk) - 1) / BK;
    for (int tile = max(n_prefix, q0 / BK); tile <= last; ++tile) step(tile);
  }

  // A row that saw no allowed key keeps dq = 0.
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < Tq) dq[((size_t)bh * Tq + q0 + r) * D + c] = from_float<T>(acc[r * L::LDA + c]);
  }
}

// Shared-memory layout of a dk/dv block.
template <typename T, int D>
struct DkvSmem {
  static constexpr int BQ2 = dkv_rows<T, D>;
  static constexpr int LDX = D + pad<T>;
  static constexpr int LDS = BK + 4;
  static constexpr int LDP = BK + pad<T>;  // P and dS in T; f32 writes them over S and dP
  static constexpr int LDA = D + 4;          // f32 dk and dv accumulators
  static constexpr int PB = is_bf16<T> ? round128(BQ2 * LDP * (int)sizeof(T)) : 0;
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + round128(BK * LDX * (int)sizeof(T));
  static constexpr int q_off = v_off + round128(BK * LDX * (int)sizeof(T));
  static constexpr int do_off = q_off + round128(BQ2 * LDX * (int)sizeof(T));
  static constexpr int s_off = do_off + round128(BQ2 * LDX * (int)sizeof(T));
  static constexpr int dp_off = s_off + round128(BQ2 * LDS * 4);
  static constexpr int p_off = dp_off + round128(BQ2 * LDS * 4);
  static constexpr int ds_off = p_off + PB;
  static constexpr int dk_off = ds_off + PB;
  static constexpr int dv_off = dk_off + round128(BK * LDA * 4);
  static constexpr int lse_off = dv_off + round128(BK * LDA * 4);
  static constexpr int delta_off = lse_off + round128(BQ2 * 4);
  static constexpr int bytes = delta_off + round128(BQ2 * 4);
  static_assert(is_bf16<T> || LDP == LDS, "f32 P and dS are written over S and dP");
  static_assert(bytes <= SMEM_LIMIT, "dk/dv block over the shared-memory limit");
};

template <typename T, int D, bool DIAG>
__global__ void __launch_bounds__(NTHREADS)
    pfn_flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ dO, const float* __restrict__ lse,
                             const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                             const int* __restrict__ sep_ptr, int Tq, int Tk) {
  using L = DkvSmem<T, D>;
  constexpr int BQ2 = L::BQ2;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* dos = reinterpret_cast<T*>(smem + L::do_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  T* ps = is_bf16<T> ? reinterpret_cast<T*>(smem + L::p_off) : reinterpret_cast<T*>(ss);
  T* dss = is_bf16<T> ? reinterpret_cast<T*>(smem + L::ds_off) : reinterpret_cast<T*>(dps);
  float* dk_acc = reinterpret_cast<float*>(smem + L::dk_off);
  float* dv_acc = reinterpret_cast<float*>(smem + L::dv_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int bh = blockIdx.y;
  const int key0 = blockIdx.x * BK;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* dob = dO + (size_t)bh * Tq * D;
  const float* lseb = lse + (size_t)bh * Tq;
  const float* deltab = delta + (size_t)bh * Tq;
  const int sep = min(max(*sep_ptr, 0), Tk);

  load_tile<T, D, BK, L::LDX>(ks, k + (size_t)bh * Tk * D, key0, Tk);
  load_tile<T, D, BK, L::LDX>(vs, v + (size_t)bh * Tk * D, key0, Tk);
  for (int i = threadIdx.x; i < BK * L::LDA; i += NTHREADS) {
    dk_acc[i] = 0.0f;
    dv_acc[i] = 0.0f;
  }

  auto step = [&](int qt) {
    const int q0 = qt * BQ2;
    load_tile<T, D, BQ2, L::LDX>(qs, qb, q0, Tq);
    load_tile<T, D, BQ2, L::LDX>(dos, dob, q0, Tq);
    load_rows<BQ2>(lse_s, lseb, q0, Tq);
    load_rows<BQ2>(delta_s, deltab, q0, Tq);
    __syncthreads();
    mm<T, BQ2, BK, D, false, true, false>(ss, L::LDS, qs, L::LDX, ks, L::LDX);    // S = Q K^T
    mm<T, BQ2, BK, D, false, true, false>(dps, L::LDS, dos, L::LDX, vs, L::LDX);  // dP = dO V^T
    __syncthreads();
    tile_ds<T, DIAG, true, BQ2>(ss, dps, L::LDS, ps, dss, L::LDP, lse_s, delta_s, q0, key0, sep, Tq, Tk);
    __syncthreads();
    mm<T, BK, D, BQ2, true, false, true>(dv_acc, L::LDA, ps, L::LDP, dos, L::LDX);  // dV += P^T dO
    mm<T, BK, D, BQ2, true, false, true>(dk_acc, L::LDA, dss, L::LDP, qs, L::LDX);  // dK += dS^T Q
    __syncthreads();  // the next query tile overwrites qs, dos and the score tiles
  };

  if (key0 < sep) {
    // Every query attends to the keys below sep.
    const int nq = (Tq + BQ2 - 1) / BQ2;
    for (int qt = 0; qt < nq; ++qt) step(qt);
  } else if (DIAG) {
    // Past sep only the diagonal: the query tiles that hold [key0, key0 + BK).
    const int last = (min(key0 + BK, Tq) - 1) / BQ2;
    for (int qt = key0 / BQ2; qt <= last; ++qt) step(qt);
  }
  __syncthreads();

  // A key no query attends to keeps dk = dv = 0.
  for (int i = threadIdx.x; i < BK * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (key0 + r < Tk) {
      const size_t at = ((size_t)bh * Tk + key0 + r) * D + c;
      dk[at] = from_float<T>(dk_acc[r * L::LDA + c]);
      dv[at] = from_float<T>(dv_acc[r * L::LDA + c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dO, *lse, *delta;
  void *out0, *out1;  // dq; or dk and dv
  const void* sep;
  int BH, Tq, Tk;
  cudaStream_t stream;
};

template <typename T, int D, bool DIAG>
cudaError_t launch_dq(const Args& a) {
  using L = DqSmem<T, D>;
  auto kernel = pfn_flash_bwd_dq_kernel<T, D, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tq + BQ - 1) / BQ, a.BH);
  kernel<<<grid, NTHREADS, L::bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<const int*>(a.sep), a.Tq, a.Tk);
  return cudaGetLastError();
}

template <typename T, int D, bool DIAG>
cudaError_t launch_dkv(const Args& a) {
  using L = DkvSmem<T, D>;
  auto kernel = pfn_flash_bwd_dkv_kernel<T, D, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Tk + BK - 1) / BK, a.BH);
  kernel<<<grid, NTHREADS, L::bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dO), static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), static_cast<const int*>(a.sep), a.Tq, a.Tk);
  return cudaGetLastError();
}

// The two launchers as class templates, so that one dispatch picks the
// instantiation of either by (dtype, head dim, variant).
template <typename T, int D, bool DIAG>
struct DqLaunch {
  static cudaError_t run(const Args& a) { return launch_dq<T, D, DIAG>(a); }
};
template <typename T, int D, bool DIAG>
struct DkvLaunch {
  static cudaError_t run(const Args& a) { return launch_dkv<T, D, DIAG>(a); }
};

template <template <typename, int, bool> class Launch, typename T, bool DIAG>
cudaError_t by_head_dim(const Args& a, int D) {
  switch (D) {
    case 32:
      return Launch<T, 32, DIAG>::run(a);
    case 64:
      return Launch<T, 64, DIAG>::run(a);
    case 128:
      return Launch<T, 128, DIAG>::run(a);
    default:
      return cudaErrorInvalidValue;
  }
}

template <template <typename, int, bool> class Launch>
cudaError_t dispatch(const Args& a, int D, int bf16, int include_diag) {
  if (bf16) {
    return include_diag ? by_head_dim<Launch, __nv_bfloat16, true>(a, D)
                        : by_head_dim<Launch, __nv_bfloat16, false>(a, D);
  }
  return include_diag ? by_head_dim<Launch, float, true>(a, D) : by_head_dim<Launch, float, false>(a, D);
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the cudaError_t of the launch (0 on success); neither synchronises.
extern "C" int pfn_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                                const void* delta, void* dq, const void* sep, int BH, int Tq, int Tk, int D,
                                int bf16, int include_diag, void* stream) {
  const Args a{q, k, v, dO, lse, delta, dq, nullptr, sep, BH, Tq, Tk, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<DqLaunch>(a, D, bf16, include_diag));
}

extern "C" int pfn_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dO, const void* lse,
                                 const void* delta, void* dk, void* dv, const void* sep, int BH, int Tq, int Tk,
                                 int D, int bf16, int include_diag, void* stream) {
  const Args a{q, k, v, dO, lse, delta, dk, dv, sep, BH, Tq, Tk, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dispatch<DkvLaunch>(a, D, bf16, include_diag));
}
