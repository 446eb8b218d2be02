// PFN flash-attention forward for Hopper (sm_90a).
//
// Replaces: pfn_tpu/ops/flash_attention.py, `_fwd_kernel` (:78-120) as called
// by `_fwd_impl` (pl.pallas_call at :255), both variants: `include_diag=true`
// (the PFN rule: query i attends to keys j < sep and to itself; used by
// `pfn_flash_attention`) and `include_diag=false` (prefix only: keys j < sep;
// used by `pfn_flash_prefix_attention`, Tq may differ from Tk).
//
// Layout: q (BH, Tq, D), k and v (BH, Tk, D), contiguous, float or bf16;
// q is pre-scaled by 1/sqrt(D) in its own dtype by the caller. Writes o
// (BH, Tq, D) in the input dtype and lse (BH, Tq) in f32. `sep` is read from
// an int32 in device memory, so one launch configuration serves every sep and
// a captured CUDA graph stays valid when sep changes.
//
// Design. One block per (64-row query tile, b*h); four warps. A loop over
// 64-row KV tiles takes the place of the TPU's sequential third grid axis:
// tiles 0 .. ceil(min(sep, Tk)/64)-1 (the train prefix), then, for the
// diagonal variant only, the tiles past that bound that hold the keys
// [q0, q0+64) of the block's own queries. No other tile is ever loaded (the
// analog of `_kv_select`'s DMA elision, :219-230). Ragged edges of T are
// masked by bounds checks, so the caller pads nothing. The running max m, the
// running sum l and the output accumulator stay in f32; probabilities are
// rounded to the value dtype before the P.V product, as the TPU kernel does.
// bf16 products run on the tensor cores through WMMA (mma.sync 16x16x16 with
// an f32 accumulator); f32 inputs take an FMA path so that f32 stays f32.
//
// What bounds it at the main-path shape (B*H=32, T=2010, D=128, bf16): the
// work is about 4*T*sep*D FLOPs per (b, h), 33 GFLOP at sep=1000, which is
// 33 us at the bf16 tensor-core peak, while the unique bytes (q, k, v, o:
// about 66 MB, K/V of one head fit in L2) take about 20 us at HBM rate. So the
// kernel should be compute bound. This first design is not: every tile goes
// through shared memory twice (scores, then probabilities), the O accumulator
// lives in shared memory and is reloaded for every tile, and each tile waits
// for its own K/V load (no double buffering).
//
// Left on the table for later work: wgmma with operands in shared memory fed
// by TMA and an mbarrier ring (producer warp + consumer warpgroups), O kept in
// registers across tiles, softmax on register fragments, larger query tiles
// (128 rows per warpgroup), and a persistent schedule that balances the
// uneven per-tile work (the diagonal tile past sep is one tile, the prefix is
// ceil(sep/64)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per KV tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;  // 16

// Row padding (in elements) that keeps every row 16-byte aligned and spreads
// rows over the shared-memory banks.
template <typename T>
struct Pad;
template <>
struct Pad<float> {
  static constexpr int v = 4;
};
template <>
struct Pad<__nv_bfloat16> {
  static constexpr int v = 8;
};

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout of one block. Every region starts on a 128-byte
// boundary; WMMA needs 32-byte aligned fragment pointers.
template <typename T, int D>
struct Smem {
  static constexpr int LDX = D + Pad<T>::v;   // q, k, v tiles (elements of T)
  static constexpr int LDS = BK + 4;          // f32 scores
  static constexpr int LDP = BK + Pad<T>::v;  // probabilities, in T
  static constexpr int LDO = D + 4;           // f32 output accumulator
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + round128(BQ * LDX * (int)sizeof(T));
  static constexpr int v_off = k_off + round128(BK * LDX * (int)sizeof(T));
  static constexpr int s_off = v_off + round128(BK * LDX * (int)sizeof(T));
  static constexpr int p_off = s_off + round128(BQ * LDS * 4);
  static constexpr int o_off = p_off + round128(BQ * LDP * (int)sizeof(T));
  static constexpr int m_off = o_off + round128(BQ * LDO * 4);
  static constexpr int l_off = m_off + round128(BQ * 4);
  static constexpr int a_off = l_off + round128(BQ * 4);
  static constexpr int bytes = a_off + round128(BQ * 4);
};

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

// Copy rows [row0, row0 + ROWS) of a (nrows, D) matrix into shared memory
// with 16-byte loads; rows past nrows are zero-filled.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int row0, int nrows) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LDX = Smem<T, D>::LDX;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDX + c) = val;
  }
}

// S (BQ x BK, f32) = Q K^T for the current KV tile.
template <typename T, int D>
__device__ __forceinline__ void tile_scores(const T* qs, const T* ks, float* ss) {
  using L = Smem<T, D>;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * ROWS_PER_WARP;
#pragma unroll
    for (int ct = 0; ct < BK / 16; ++ct) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kd = 0; kd < D; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
        wmma::load_matrix_sync(a, qs + r0 * L::LDX + kd, L::LDX);
        wmma::load_matrix_sync(b, ks + ct * 16 * L::LDX + kd, L::LDX);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(ss + r0 * L::LDS + ct * 16, acc, L::LDS, wmma::mem_row_major);
    }
  } else {
    // Thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx + 16*j.
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][BK / 16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) acc[i][j] = 0.0f;
    for (int d = 0; d < D; ++d) {
      float kv[BK / 16];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) kv[j] = to_float(ks[(tx + 16 * j) * L::LDX + d]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float qv = to_float(qs[(ty * 8 + i) * L::LDX + d]);
#pragma unroll
        for (int j = 0; j < BK / 16; ++j) acc[i][j] = fmaf(qv, kv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) ss[(ty * 8 + i) * L::LDS + tx + 16 * j] = acc[i][j];
  }
}

// Online-softmax update for one KV tile. Warp w owns rows 16w .. 16w+15.
// Masked entries are -inf; a row that has seen no allowed key yet keeps
// m = -inf, so its probabilities are 0 and its rescale factor is irrelevant
// (l and O are still 0).
template <typename T, int D, bool DIAG>
__device__ __forceinline__ void tile_softmax(const float* ss, T* ps, float* m_s, float* l_s, float* a_s,
                                             int q0, int key0, int sep, int Tk) {
  using L = Smem<T, D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int query = q0 + r;
    float sv[BK / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      const int key = key0 + c;
      const bool allowed = key < Tk && (key < sep || (DIAG && key == query));
      sv[j] = allowed ? ss[r * L::LDS + c] : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = warp_max(mx);
    const float m_prev = m_s[r];
    const float m_new = fmaxf(m_prev, mx);
    const float m_ref = (m_new == -INFINITY) ? 0.0f : m_new;
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const float p = expf(sv[j] - m_ref);
      ps[r * L::LDP + lane + 32 * j] = from_float<T>(p);
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_ref);
      l_s[r] = l_s[r] * alpha + sum;
      m_s[r] = m_new;
      a_s[r] = alpha;
    }
  }
}

// O = O * alpha + P V for the current KV tile.
template <typename T, int D>
__device__ __forceinline__ void tile_accumulate(float* os, const T* ps, const T* vs, const float* a_s) {
  using L = Smem<T, D>;
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    os[r * L::LDO + c] *= a_s[r];
  }
  __syncthreads();
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    using namespace nvcuda;
    const int r0 = (threadIdx.x / 32) * ROWS_PER_WARP;
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, os + r0 * L::LDO + dt * 16, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(a, ps + r0 * L::LDP + kk, L::LDP);
        wmma::load_matrix_sync(b, vs + kk * L::LDX + dt * 16, L::LDX);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(os + r0 * L::LDO + dt * 16, acc, L::LDO, wmma::mem_row_major);
    }
  } else {
    // Thread (ty, tx) owns rows ty*8 .. ty*8+7 and columns tx + 16*j.
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[8][D / 16];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = os[(ty * 8 + i) * L::LDO + tx + 16 * j];
    for (int kk = 0; kk < BK; ++kk) {
      float vv[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vv[j] = to_float(vs[kk * L::LDX + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float p = to_float(ps[(ty * 8 + i) * L::LDP + kk]);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) os[(ty * 8 + i) * L::LDO + tx + 16 * j] = acc[i][j];
  }
}

template <typename T, int D, bool DIAG>
__global__ void __launch_bounds__(NTHREADS)
    pfn_flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                         T* __restrict__ o, float* __restrict__ lse, const int* __restrict__ sep_ptr, int Tq,
                         int Tk) {
  using L = Smem<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  float* a_s = reinterpret_cast<float*>(smem + L::a_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* qb = q + (size_t)bh * Tq * D;
  const T* kb = k + (size_t)bh * Tk * D;
  const T* vb = v + (size_t)bh * Tk * D;
  const int sep = min(max(*sep_ptr, 0), Tk);

  load_tile<T, D, BQ>(qs, qb, q0, Tq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) os[i] = 0.0f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  auto step = [&](int tile) {
    const int key0 = tile * BK;
    load_tile<T, D, BK>(ks, kb, key0, Tk);
    load_tile<T, D, BK>(vs, vb, key0, Tk);
    __syncthreads();
    tile_scores<T, D>(qs, ks, ss);
    __syncthreads();
    tile_softmax<T, D, DIAG>(ss, ps, m_s, l_s, a_s, q0, key0, sep, Tk);
    __syncthreads();
    tile_accumulate<T, D>(os, ps, vs, a_s);
    __syncthreads();  // the next tile overwrites ks, vs, ss and ps
  };

  // The train prefix: keys [0, sep).
  const int n_prefix = (sep + BK - 1) / BK;
  for (int tile = 0; tile < n_prefix; ++tile) step(tile);
  if (DIAG) {
    // The diagonal keys [q0, q0 + BQ) not yet covered (Tq == Tk here).
    const int last = (min(q0 + BQ, Tk) - 1) / BK;
    for (int tile = max(n_prefix, q0 / BK); tile <= last; ++tile) step(tile);
  }

  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < Tq) o[((size_t)bh * Tq + q0 + r) * D + c] = from_float<T>(os[r * L::LDO + c] / fmaxf(l_s[r], 1e-30f));
  }
  if (threadIdx.x < BQ && q0 + threadIdx.x < Tq) {
    // A row with no allowed key (prefix variant, sep = 0) reports
    // lse = -1e30 + log(1e-30), as the TPU kernel's initial state gives.
    const float m = m_s[threadIdx.x] == -INFINITY ? -1e30f : m_s[threadIdx.x];
    lse[(size_t)bh * Tq + q0 + threadIdx.x] = m + logf(fmaxf(l_s[threadIdx.x], 1e-30f));
  }
}

template <typename T, int D, bool DIAG>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH, int Tq,
                   int Tk, cudaStream_t stream) {
  using L = Smem<T, D>;
  auto kernel = pfn_flash_fwd_kernel<T, D, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  kernel<<<grid, NTHREADS, L::bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                                static_cast<const T*>(v), static_cast<T*>(o),
                                                static_cast<float*>(lse), static_cast<const int*>(sep), Tq, Tk);
  return cudaGetLastError();
}

template <typename T, bool DIAG>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH,
                       int Tq, int Tk, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
    case 64:
      return launch<T, 64, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
    case 128:
      return launch<T, 128, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// C entry point, bound with ctypes. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int pfn_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH,
                             int Tq, int Tk, int D, int is_bf16, int include_diag, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = include_diag ? dispatch_d<__nv_bfloat16, true>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s)
                       : dispatch_d<__nv_bfloat16, false>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s);
  } else {
    err = include_diag ? dispatch_d<float, true>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s)
                       : dispatch_d<float, false>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s);
  }
  return static_cast<int>(err);
}
