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
// a captured CUDA graph stays valid when sep changes. Both bodies walk the
// same tile list: the KV tiles below sep, then, in the diagonal variant, the
// tile(s) past them holding the block's own diagonal keys; no other tile is
// ever loaded (the analog of `_kv_select`'s DMA elision, :219-230). Rows past
// T are masked by bounds, so the caller pads nothing.
//
// What bounds it on the H100 (B*H = 32, T = 2010, D = 128, sep = 1000): two
// products over the allowed (query, key) pairs, 4 * D flops a pair, 33 GFLOP,
// which is 33 us at the bf16 tensor-core peak; the unique bytes (q, k, v, o
// and lse, ~66 MB) take ~20 us at the HBM rate, and one head's K and V stay in
// L2 while its query tiles read them. So it is bound by operations.
//
// bf16 (the main path), `fwd_sm90`: one block per (128-row query tile, b*h),
// three warpgroups (pfn_flash_sm90.cuh): a producer that brings Q in once
// and the K/V tiles of 128 keys through a ring of 3 (D = 128) or 4 slots by
// TMA, and two consumer warpgroups of 64 query rows each. Per KV tile a
// consumer runs S = Q K^T as wgmma from shared memory, the online softmax on
// the S fragments in registers (exp2 with log2(e) folded in; the mask only on
// the tile holding sep and on the diagonal tile), rounds P to bf16 in
// registers (the TPU kernel's rounding place, :112-114) and runs O += P V as
// wgmma with P as the register A operand. m, l and O stay in registers for
// the whole loop; no S or P tile goes through shared memory, and the next
// tiles' loads are in flight while a tile is computed.
//
// f32: the FMA body of the first port (one block per 64-row query tile, four
// warps, S, P and the O accumulator in shared memory), so f32 stays f32 (no
// TF32).
//
// Left for later: overlapping one tile's softmax with the next tile's Q K^T
// (two S buffers, or the two warpgroups taking turns), a persistent schedule
// over the uneven work per query tile (a tile of rows below sep visits
// ceil(sep/128) tiles, one past sep one more), and storing O through shared
// memory by TMA instead of 4-byte stores from the fragments.

#include "pfn_flash_sm90.cuh"

namespace {

namespace sm90 = pfn_flash_sm90;

// ------------------------------------------------------------ f32, FMA

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per KV tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS_PER_WARP = BQ / NWARPS;  // 16

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Shared-memory layout of one block. Every region starts on a 128-byte
// boundary; rows are padded by 4 floats to spread them over the banks.
template <int D>
struct Smem {
  static constexpr int LDX = D + 4;   // q, k, v tiles
  static constexpr int LDS = BK + 4;  // scores
  static constexpr int LDP = BK + 4;  // probabilities
  static constexpr int LDO = D + 4;   // output accumulator
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + round128(BQ * LDX * 4);
  static constexpr int v_off = k_off + round128(BK * LDX * 4);
  static constexpr int s_off = v_off + round128(BK * LDX * 4);
  static constexpr int p_off = s_off + round128(BQ * LDS * 4);
  static constexpr int o_off = p_off + round128(BQ * LDP * 4);
  static constexpr int m_off = o_off + round128(BQ * LDO * 4);
  static constexpr int l_off = m_off + round128(BQ * 4);
  static constexpr int a_off = l_off + round128(BQ * 4);
  static constexpr int bytes = a_off + round128(BQ * 4);
};

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
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0, int nrows) {
  constexpr int CHUNKS = D / 4;
  constexpr int LDX = Smem<D>::LDX;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * LDX + c) = val;
  }
}

// S (BQ x BK) = Q K^T for the current KV tile. Thread (ty, tx) owns rows
// ty*8 .. ty*8+7 and columns tx + 16*j.
template <int D>
__device__ __forceinline__ void tile_scores(const float* qs, const float* ks, float* ss) {
  using L = Smem<D>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][BK / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) acc[i][j] = 0.0f;
  for (int d = 0; d < D; ++d) {
    float kv[BK / 16];
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) kv[j] = ks[(tx + 16 * j) * L::LDX + d];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float qv = qs[(ty * 8 + i) * L::LDX + d];
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) acc[i][j] = fmaf(qv, kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) ss[(ty * 8 + i) * L::LDS + tx + 16 * j] = acc[i][j];
}

// Online-softmax update for one KV tile. Warp w owns rows 16w .. 16w+15.
// Masked entries are -inf; a row that has seen no allowed key yet keeps
// m = -inf, so its probabilities are 0 and its rescale factor is irrelevant
// (l and O are still 0).
template <int D, bool DIAG>
__device__ __forceinline__ void tile_softmax(const float* ss, float* ps, float* m_s, float* l_s, float* a_s, int q0,
                                             int key0, int sep, int Tk) {
  using L = Smem<D>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int r = warp * ROWS_PER_WARP + i;
    const int query = q0 + r;
    float sv[BK / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 32; ++j) {
      const int c = lane + 32 * j;
      sv[j] = sm90::allowed<DIAG>(query, key0 + c, sep, Tk) ? ss[r * L::LDS + c] : -INFINITY;
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
      ps[r * L::LDP + lane + 32 * j] = p;
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

// O = O * alpha + P V for the current KV tile. Thread (ty, tx) owns rows
// ty*8 .. ty*8+7 and columns tx + 16*j.
template <int D>
__device__ __forceinline__ void tile_accumulate(float* os, const float* ps, const float* vs, const float* a_s) {
  using L = Smem<D>;
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    os[r * L::LDO + c] *= a_s[r];
  }
  __syncthreads();
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][D / 16];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = os[(ty * 8 + i) * L::LDO + tx + 16 * j];
  for (int kk = 0; kk < BK; ++kk) {
    float vv[D / 16];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) vv[j] = vs[kk * L::LDX + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float p = ps[(ty * 8 + i) * L::LDP + kk];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) os[(ty * 8 + i) * L::LDO + tx + 16 * j] = acc[i][j];
}

template <int D, bool DIAG>
__global__ void __launch_bounds__(NTHREADS)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ sep_ptr, int Tq, int Tk) {
  using L = Smem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* ps = reinterpret_cast<float*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::m_off);
  float* l_s = reinterpret_cast<float*>(smem + L::l_off);
  float* a_s = reinterpret_cast<float*>(smem + L::a_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const int sep = min(max(*sep_ptr, 0), Tk);

  load_tile<D, BQ>(qs, q + (size_t)bh * Tq * D, q0, Tq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += NTHREADS) os[i] = 0.0f;
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = -INFINITY;
    l_s[threadIdx.x] = 0.0f;
  }
  __syncthreads();

  const sm90::Tiles<BQ, BK, DIAG> tiles(sep, q0, Tk);
  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.row0(i);
    load_tile<D, BK>(ks, kb, key0, Tk);
    load_tile<D, BK>(vs, vb, key0, Tk);
    __syncthreads();
    tile_scores<D>(qs, ks, ss);
    __syncthreads();
    tile_softmax<D, DIAG>(ss, ps, m_s, l_s, a_s, q0, key0, sep, Tk);
    __syncthreads();
    tile_accumulate<D>(os, ps, vs, a_s);
    __syncthreads();  // the next tile overwrites ks, vs, ss and ps
  }

  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < Tq) o[((size_t)bh * Tq + q0 + r) * D + c] = os[r * L::LDO + c] / fmaxf(l_s[r], 1e-30f);
  }
  if (threadIdx.x < BQ && q0 + threadIdx.x < Tq) {
    // A row with no allowed key (prefix variant, sep = 0) reports
    // lse = -1e30 + log(1e-30), as the TPU kernel's initial state gives.
    const float m = m_s[threadIdx.x] == -INFINITY ? -1e30f : m_s[threadIdx.x];
    lse[(size_t)bh * Tq + q0 + threadIdx.x] = m + logf(fmaxf(l_s[threadIdx.x], 1e-30f));
  }
}

// ------------------------------------------------------- bf16, sm_90a

constexpr int kBQ = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kBK = 128;  // keys per KV tile

template <int D, bool DIAG>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    fwd_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
             const int* __restrict__ sep_ptr, int Tq, int Tk) {
  using L = sm90::Smem<D, kBQ, kBK, 1>;
  constexpr int ON = D < 64 ? D : 64;  // N of one P V product: one panel of D
  constexpr int NPAN = D / ON;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_base(smem_raw);
  const int wg = threadIdx.x / 128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int sep = min(max(*sep_ptr, 0), Tk);
  const sm90::Tiles<kBQ, kBK, DIAG> tiles(sep, q0, Tk);

  if (threadIdx.x == 0) {
    sm90::mbar_init(L::res_bar(base), 1);
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(L::full(base, s), 1);
      sm90::mbar_init(L::empty(base, s), sm90::kConsumerThreads);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    sm90::producer_regs();
    if (threadIdx.x == 256) {
      const CUtensorMap* res[1] = {&mq};
      sm90::produce<L, D, kBQ, kBK, 1>(res, &mk, &mv, base, tiles, q0, bh);
    }
  } else {
    sm90::consumer_regs();
    const int row0 = wg * 64;  // this warpgroup's rows in the query tile
    float acc[NPAN][ON / 2];
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
#pragma unroll
      for (int e = 0; e < ON / 2; ++e) acc[p][e] = 0.0f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};  // l: this thread's partial row sums
    sm90::mbar_wait(L::res_bar(base), 0);

    for (int i = 0; i < tiles.n; ++i) {
      const int stage = i % L::STAGES;
      const int key0 = tiles.row0(i);
      sm90::mbar_wait(L::full(base, stage), (i / L::STAGES) & 1);
      const uint32_t ks = L::ring_tile(base, stage, 0), vs = L::ring_tile(base, stage, 1);

      float s[kBK / 2];  // S = Q K^T
      sm90::fence_regs(s);
      sm90::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        sm90::wgmma_ss<kBK>(s, sm90::desc_k_major<D, kBQ>(L::res_tile(base, 0), row0, kd),
                            sm90::desc_k_major<D, kBK>(ks, 0, kd), kd > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(s);

      if (key0 + kBK > sep) {  // the tile holding sep, or the diagonal tile
#pragma unroll
        for (int e = 0; e < kBK / 2; ++e)
          if (!sm90::allowed<DIAG>(q0 + row0 + sm90::frag_row(e), key0 + sm90::frag_col(e), sep, Tk)) s[e] = -INFINITY;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
        const float m_new = fmaxf(m[h], sm90::quad_max(mx));
        const float m_ref = m_new == -INFINITY ? 0.0f : m_new;
        const float mb = m_ref * sm90::kLog2e;
        const float alpha = exp2f(m[h] * sm90::kLog2e - mb);  // 0 while the row has seen no allowed key
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(fmaf(s[4 * j + 2 * h + c], sm90::kLog2e, -mb));
            s[4 * j + 2 * h + c] = p;
            sum += p;
          }
        l[h] = l[h] * alpha + sum;
        m[h] = m_new;
#pragma unroll
        for (int p = 0; p < NPAN; ++p)
#pragma unroll
          for (int j = 0; j < ON / 8; ++j) {
            acc[p][4 * j + 2 * h] *= alpha;
            acc[p][4 * j + 2 * h + 1] *= alpha;
          }
      }

      uint32_t pa[kBK / 16][4];  // P in bf16, the A operand of O += P V
      sm90::to_a_frags<kBK>(s, pa);
#pragma unroll
      for (int p = 0; p < NPAN; ++p) sm90::fence_regs(acc[p]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NPAN; ++p) sm90::wgmma_rs_tb<ON>(acc[p], pa[kk], sm90::desc_mn_major<D, kBK>(vs, kk, p));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NPAN; ++p) sm90::fence_regs(acc[p]);
      sm90::fence_regs(pa);
      sm90::mbar_arrive(L::empty(base, stage));
    }

    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float lt = fmaxf(sm90::quad_sum(l[h]), 1e-30f);
      inv[h] = 1.0f / lt;
      const int row = q0 + row0 + sm90::frag_row(2 * h);
      if ((threadIdx.x & 3) == 0 && row < Tq) {
        // A row with no allowed key (prefix variant, sep = 0) reports
        // lse = -1e30 + log(1e-30), as the TPU kernel's initial state gives.
        lse[(size_t)bh * Tq + row] = (m[h] == -INFINITY ? -1e30f : m[h]) + logf(lt);
      }
    }
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
      sm90::store_panel<ON, D>(o + (size_t)bh * Tq * D, acc[p], inv, q0 + row0, Tq, p * ON);
  }
}

template <int D, bool DIAG>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH,
                       int Tq, int Tk, cudaStream_t stream) {
  using L = Smem<D>;
  auto kernel = fwd_f32<D, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, BH);
  kernel<<<grid, NTHREADS, L::bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                static_cast<const float*>(v), static_cast<float*>(o),
                                                static_cast<float*>(lse), static_cast<const int*>(sep), Tq, Tk);
  return cudaGetLastError();
}

template <int D, bool DIAG>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH,
                        int Tq, int Tk, cudaStream_t stream) {
  using L = sm90::Smem<D, kBQ, kBK, 1>;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = sm90::make_map(&mq, q, BH, Tq, D, kBQ)) != cudaSuccess) return err;
  if ((err = sm90::make_map(&mk, k, BH, Tk, D, kBK)) != cudaSuccess) return err;
  if ((err = sm90::make_map(&mv, v, BH, Tk, D, kBK)) != cudaSuccess) return err;
  auto kernel = fwd_sm90<D, DIAG>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes)) != cudaSuccess)
    return err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, BH);
  kernel<<<grid, sm90::kThreads, L::bytes, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o),
                                                      static_cast<float*>(lse), static_cast<const int*>(sep), Tq, Tk);
  return cudaGetLastError();
}

template <bool BF16, bool DIAG>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH,
                       int Tq, int Tk, int D, cudaStream_t stream) {
  switch (D) {
    case 32:
      return BF16 ? launch_bf16<32, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream)
                  : launch_f32<32, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
    case 64:
      return BF16 ? launch_bf16<64, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream)
                  : launch_f32<64, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
    case 128:
      return BF16 ? launch_bf16<128, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream)
                  : launch_f32<128, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
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
    err = include_diag ? dispatch_d<true, true>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s)
                       : dispatch_d<true, false>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s);
  } else {
    err = include_diag ? dispatch_d<false, true>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s)
                       : dispatch_d<false, false>(q, k, v, o, lse, sep, BH, Tq, Tk, D, s);
  }
  return static_cast<int>(err);
}
