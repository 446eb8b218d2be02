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
// f32, `fwd_f32` (FMA on the CUDA cores, so f32 stays f32: no TF32, whose
// three decimal digits miss the 2e-5 tolerance; pfn_flash_f32.cuh): bound by
// operations at the 67 TFLOP/s f32 peak (0.49 ms at the shape above) and, in
// practice, by shared memory's 128 bytes a clock feeding 128 FMAs a clock.
// One block of 256 threads per (query tile, b*h): 128 rows from T = 256 on,
// 64 below. A thread owns 8 (or 4) query rows, 16 threads a row in one half
// of a warp: S (8 x 4 a thread), the running max m, its partial row sum l
// and O (8 x D / 16) stay in registers for the whole KV loop; only P passes
// through shared memory, once a tile, as the A operand of O += P V. K and V
// tiles of 64 keys are loaded by cp.async and take turns in flight: V(i)
// while S = Q K(i)^T is computed, K(i + 1) while O += P V(i) is. Two
// barriers a tile; 176 KB of shared memory at D = 128 (one block, 8 warps,
// an SM), 216-222 registers, no spill. On an H100 80GB HBM3 at 700 W: 0.98
// ms at B*H 32, T 2010, D 128, sep 1000 (50 % of the bound; SDPA f32 1.77
// ms, the first port's body 3.60 ms), 0.25 ms at B*H 1024, T 100, sep 30
// (SDPA f32 0.265 ms).
//
// Left for later: overlapping one tile's softmax with the next tile's Q K^T
// (two S buffers, or the two warpgroups taking turns), a persistent schedule
// over the uneven work per query tile (a tile of rows below sep visits
// ceil(sep/128) tiles, one past sep one more), and storing O through shared
// memory by TMA instead of 4-byte stores from the fragments.

#include "pfn_flash_f32.cuh"
#include "pfn_flash_sm90.cuh"

namespace {

namespace sm90 = pfn_flash_sm90;
namespace f32 = pfn_flash_f32;

// ------------------------------------------------------------ f32, FMA

constexpr int FK = 64;  // keys per f32 KV tile
// Query rows per f32 block: 128 from T = 256 on (a thread then owns 8 rows,
// and reads 0.375 floats from shared memory per FMA in S = Q K^T and 0.25 in
// O += P V, against 0.5 and 0.375 at 64 rows); 64 below, where a 128-row
// tile's masked diagonal work outweighs that and twice the blocks fill the
// card better.
constexpr int kLongSeq = 256;

// Shared memory of an f32 block, in floats: the query tile, one K and one V
// tile, and P, the one tile that passes through shared memory. K and V take
// turns in flight: V(i) loads while S = Q K(i)^T is computed, K(i + 1) while
// O += P V(i) is (176 KB at D = 128 and 128 rows; a ring of two (K, V) pairs
// would not fit beside a 128-row Q and P).
template <int D, int FQ>
struct FwdF32Smem {
  static constexpr int LDX = f32::ld_tile(D);
  static constexpr int LDP = f32::ld_scores(FK);
  static constexpr int q_off = 0;
  static constexpr int k_off = q_off + FQ * LDX;
  static constexpr int v_off = k_off + FK * LDX;
  static constexpr int p_off = v_off + FK * LDX;
  static constexpr int bytes = (p_off + FQ * LDP) * 4;
  static_assert(bytes <= 232448, "f32 forward block over the shared-memory limit");
};

template <int D, int FQ, bool DIAG>
__global__ void __launch_bounds__(f32::kThreads, 1)
    fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            float* __restrict__ o, float* __restrict__ lse, const int* __restrict__ sep_ptr, int Tq, int Tk) {
  using L = FwdF32Smem<D, FQ>;
  using C = f32::Cols<D>;
  constexpr int RM = FQ / 16;  // query rows per thread
  extern __shared__ __align__(16) float fsm[];
  const float* qs = fsm + L::q_off;
  float* ks = fsm + L::k_off;
  float* vs = fsm + L::v_off;
  float* ps = fsm + L::p_off;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * FQ;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const int sep = min(max(*sep_ptr, 0), Tk);
  const sm90::Tiles<FQ, FK, DIAG> tiles(sep, q0, Tk);

  f32::load_tile_async<D, FQ>(fsm + L::q_off, q + (size_t)bh * Tq * D, q0, Tq);
  if (tiles.n > 0) f32::load_tile_async<D, FK>(ks, kb, tiles.row0(0), Tk);
  f32::cp_async_commit();

  // Rows ty + 16 r of the tile: the running max m, this thread's partial
  // row sum l (its 4 of the tile's 64 columns), and O, all in registers.
  float acc[RM][C::PER_THREAD];
  float m[RM], l[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < C::PER_THREAD; ++c) acc[r][c] = 0.0f;
  }

  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.row0(i);
    f32::cp_async_wait<0>();
    __syncthreads();  // K(i) is in; every thread is done with V(i - 1) and P
    f32::load_tile_async<D, FK>(vs, vb, key0, Tk);
    f32::cp_async_commit();

    float s[RM][4];  // S = Q K^T: rows ty + 16 r, keys key0 + tx + 16 j
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.0f;
    f32::mma_nt<RM, 4, D>(s, qs + ty * L::LDX, 16 * L::LDX, ks + tx * L::LDX, 16 * L::LDX);
    if (key0 + FK > sep) {  // the tile holding sep, or a diagonal tile
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (!sm90::allowed<DIAG>(q0 + ty + 16 * r, key0 + tx + 16 * j, sep, Tk)) s[r][j] = -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const float mx = f32::group_max(fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3])));
      const float m_new = fmaxf(m[r], mx);
      const float mb = (m_new == -INFINITY ? 0.0f : m_new) * f32::kLog2e;
      const float alpha = exp2f(fmaf(m[r], f32::kLog2e, -mb));  // 0 while the row has seen no allowed key
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(fmaf(s[r][j], f32::kLog2e, -mb));
        ps[(ty + 16 * r) * L::LDP + tx + 16 * j] = p;
        sum += p;
      }
      l[r] = fmaf(l[r], alpha, sum);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C::PER_THREAD; ++c) acc[r][c] *= alpha;
    }
    f32::cp_async_wait<0>();
    __syncthreads();  // V(i) and P are in; every thread is done with K(i)
    if (i + 1 < tiles.n) f32::load_tile_async<D, FK>(ks, kb, tiles.row0(i + 1), Tk);
    f32::cp_async_commit();
    f32::mma_nn<RM, D, FK>(acc, ps + ty * L::LDP, 16 * L::LDP, vs, L::LDX, tx);  // O += P V
  }
  f32::cp_async_wait<0>();  // with no KV tile (prefix variant, sep = 0) the Q copy is still in flight

  float inv[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float lt = fmaxf(f32::group_sum(l[r]), 1e-30f);
    inv[r] = 1.0f / lt;
    const int row = q0 + ty + 16 * r;
    if (tx == 0 && row < Tq) {
      // A row with no allowed key (prefix variant, sep = 0) reports
      // lse = -1e30 + log(1e-30), as the TPU kernel's initial state gives.
      lse[(size_t)bh * Tq + row] = (m[r] == -INFINITY ? -1e30f : m[r]) + logf(lt);
    }
  }
  f32::store_rows<RM, D>(o + (size_t)bh * Tq * D, acc, inv, q0, Tq, tx, ty);
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

template <int D, int FQ, bool DIAG>
cudaError_t launch_f32_rows(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep,
                            int BH, int Tq, int Tk, cudaStream_t stream) {
  using L = FwdF32Smem<D, FQ>;
  auto kernel = fwd_f32<D, FQ, DIAG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + FQ - 1) / FQ, BH);
  kernel<<<grid, f32::kThreads, L::bytes, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                                     static_cast<const float*>(v), static_cast<float*>(o),
                                                     static_cast<float*>(lse), static_cast<const int*>(sep), Tq, Tk);
  return cudaGetLastError();
}

template <int D, bool DIAG>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, void* lse, const void* sep, int BH,
                       int Tq, int Tk, cudaStream_t stream) {
  return Tq >= kLongSeq ? launch_f32_rows<D, 128, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream)
                        : launch_f32_rows<D, 64, DIAG>(q, k, v, o, lse, sep, BH, Tq, Tk, stream);
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
