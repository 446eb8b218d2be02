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
// needs atomics and the backward is deterministic. Masked entries get p = 0
// explicitly, never exp(s - lse): a prefix row with no allowed key has lse =
// -1e30, which would give exp(-1e30 + 1e30) = 1. Rows past Tq and keys past
// Tk are masked by bounds, so the caller pads nothing. Rounding follows the
// TPU kernels: s, dp and ds in f32; p rounded to dO's dtype before P^T dO; ds
// rounded to the input dtype before dS K and dS^T Q; every accumulator f32.
//
// What bounds them on the H100 (B*H = 16, T = 2010, D = 128, sep = 1000):
// dq does three products over the allowed (query, key) pairs (S, dP, dS K),
// 25 GFLOP, 25 us at the bf16 tensor-core peak, and dk/dv four (S, dP,
// dS^T Q, P^T dO), 33 GFLOP, 33 us; the unique bytes (q, k, v, dO, the
// output, lse and delta: ~41 MB for dq) take ~12 us at the HBM rate. So both
// are bound by operations.
//
//   * dq, bf16 (the main path), `dq_sm90`: the forward's block and ring
//     (pfn_flash_sm90.cuh): one block per (128-row query tile, b*h), Q and dO
//     resident (TMA, once), K and V tiles of 64 keys streamed through a ring
//     of 4 slots by the producer warpgroup, two consumer warpgroups of 64
//     rows. Per tile a consumer runs S = Q K^T and dP = dO V^T as wgmma from
//     shared memory, forms p = exp(s - lse) (0 off the allowed entries) and
//     ds = p (dp - delta) on the fragments in registers with lse and delta
//     of its rows in registers, rounds ds to bf16 and runs dQ += dS K as
//     wgmma with dS as the register A operand. The dQ accumulator (64 f32
//     registers a thread at D = 128) stays in registers; 64-key tiles keep S
//     and dP at 32 registers each, so nothing spills. It visits the
//     forward's tiles: below sep, then the diagonal tiles.
//   * dq, f32: the FMA body of the first port (64-row query tiles, four
//     warps, every tile and the accumulator in shared memory), so f32 stays
//     f32 (no TF32); its Hopper redesign on pfn_flash_f32.cuh is still to come.
//   * dk/dv, bf16 (the main path), `dkv_sm90`: the same block with the
//     roles swapped. A unit is (128-key tile, b*h): its K and V are resident
//     (TMA, once a unit, 64 keys per consumer warpgroup), and the Q and dO
//     tiles of 64 queries it visits stream through a ring of 4 slots (32 KB
//     of tiles each at D = 128) with lse * log2(e) and delta of the slot's
//     queries, which the producer warp's lanes load and store into the slot
//     before arriving on its `full` barrier; the consumers hold no row terms
//     in registers. Per query tile a consumer runs S^T = K Q^T and dP^T =
//     V dO^T as wgmma (keys as rows, queries as columns, both operands
//     K-major), forms p and ds on the fragments in registers, and runs
//     dV += P^T dO and dK += dS^T Q as wgmma with P^T and dS^T as the register
//     A operands and dO and Q MN-major, so nothing is transposed through
//     shared memory. dK and dV stay in registers, f32 (64 + 64 a thread at
//     D = 128). The mask is applied only in tiles not wholly inside the
//     allowed region: the warpgroup's keys reach sep, or the tile reaches
//     past Tq. Its query tiles: all of them for a key tile below sep; past
//     sep, the ones holding its diagonal (diagonal variant) or none (prefix
//     variant, which writes zeros). That work is uneven, so the grid is
//     persistent: min(units, SMs) blocks, block b taking units b, b + grid,
//     ... in key-tile-major order, which puts every heavy unit (below sep)
//     first for any sep, with no host read of sep. The producer reloads K and
//     V for a unit once the consumers have released the last unit's final
//     ring slot. ptxas: 168 registers at launch (the bound of 384 threads;
//     the consumers take 232 by setmaxnreg), 0 bytes of spill at every head
//     dim and variant. On an H100 80GB HBM3 at 700 W: 0.102-0.104 ms at the
//     shape above (32 % of the bound), 0.901 ms for the first port's body.
//   * dk/dv, f32, `dkv_f32` (FMA, no TF32; pfn_flash_f32.cuh): bound by
//     operations at the 67 TFLOP/s f32 peak (0.49 ms at B*H 16, T 2010, sep
//     1000) and by shared memory feeding the FMA units. A unit is (64-key
//     tile, b*h): its K and V are resident (cp.async, once a unit), and the
//     64-row query steps it visits, Q and dO with their lse and delta, stream
//     through a 2-stage cp.async ring. Per step a thread forms S^T = K Q^T
//     and dP^T = V dO^T for 4 keys x 4 queries in registers, then p (0 off
//     the allowed entries) and ds; one shared score tile stages P^T for dV
//     += P^T dO, then dS^T for dK += dS^T Q, and dK and dV accumulate in
//     registers (64 floats a thread at D = 128; 216-218 registers, no
//     spill; 219 KB of shared memory, one block an SM). The grid is
//     persistent and heavy-first as dkv_sm90's: as many blocks as fit, units
//     in key-tile-major order; each key tile is written once, no atomics. On
//     an H100 80GB HBM3 at 700 W: 1.03 ms at the shape above (48 % of the
//     bound; the first port's body 2.15 ms).
//
// Left for later: for both bf16 kernels, overlapping one tile's softmax with
// the next tile's products (two S buffers, or the two consumer warpgroups
// taking turns) and storing the outputs through shared memory by TMA; for
// dk/dv, splitting a heavy unit's query walk between blocks when the units
// below sep are not a multiple of the SMs (at B*H 16 and sep 1595, 208 heavy
// units on 132 SMs take two rounds where 1.6 would do), with partial sums
// added in a fixed order, never atomics.

#include <type_traits>

#include "pfn_flash_f32.cuh"
#include "pfn_flash_sm90.cuh"

namespace {

namespace sm90 = pfn_flash_sm90;
namespace f32 = pfn_flash_f32;

constexpr int BQ = 64;  // query rows per f32 dq block
constexpr int BK = 64;  // keys per KV tile of the f32 kernels
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int SMEM_LIMIT = 232448;  // bytes of shared memory one block may use

template <typename T>
constexpr bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;

constexpr int round128(int bytes) { return (bytes + 127) / 128 * 128; }

// Copy rows [row0, row0 + ROWS) of a (nrows, D) f32 matrix into shared
// memory (row stride LD) with 16-byte loads; rows past nrows are zero-filled.
template <int D, int ROWS, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0, int nrows) {
  constexpr int CHUNKS = D / 4;
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * 4;
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

// C (M x N, f32, row stride ldc) = [C +] A op(B) on FMA, every operand in
// shared memory, computed by the whole block (the f32 dq body's products):
//   A(i, k) = A[i * lda + k]                             (M x K)
//   op(B)(k, j) = TB ? B[j * ldb + k] : B[k * ldb + j]    (K x N)
// Thread (ty, tx) owns rows ty*RM .. ty*RM+RM-1 and columns tx + 16*j.
template <int M, int N, int K, bool TB, bool ACC>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda, const float* B, int ldb) {
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
    for (int j = 0; j < CN; ++j) b[j] = TB ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float a = A[(ty * RM + i) * lda + k];
#pragma unroll
      for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) C[(ty * RM + i) * ldc + tx + 16 * j] = acc[i][j];
}

// From S and dP (ROWS x BK, f32, row stride lds) of query rows q0.. and keys
// key0..: p = exp(s - lse) on allowed entries and 0 elsewhere; writes ds =
// p (dp - delta) over S (each entry is read and written by one thread).
template <bool DIAG, int ROWS>
__device__ __forceinline__ void tile_ds(float* ss, const float* dps, int lds, const float* lse_s,
                                        const float* delta_s, int q0, int key0, int sep, int Tq, int Tk) {
  for (int i = threadIdx.x; i < ROWS * BK; i += NTHREADS) {
    const int r = i / BK, c = i % BK;
    const int query = q0 + r, key = key0 + c;
    const bool allowed = query < Tq && key < Tk && (key < sep || (DIAG && key == query));
    const float p = allowed ? expf(ss[r * lds + c] - lse_s[r]) : 0.0f;
    ss[r * lds + c] = p * (dps[r * lds + c] - delta_s[r]);
  }
}

// Shared-memory layout of an f32 dq block. Every region starts on a 128-byte
// boundary; ds is written over S.
template <int D>
struct DqSmem {
  static constexpr int LDX = D + 4;   // q, dO, k, v tiles
  static constexpr int LDS = BK + 4;          // S, dP, and dS over S
  static constexpr int LDA = D + 4;           // dq accumulator
  static constexpr int q_off = 0;
  static constexpr int do_off = q_off + round128(BQ * LDX * 4);
  static constexpr int k_off = do_off + round128(BQ * LDX * 4);
  static constexpr int v_off = k_off + round128(BK * LDX * 4);
  static constexpr int s_off = v_off + round128(BK * LDX * 4);
  static constexpr int dp_off = s_off + round128(BQ * LDS * 4);
  static constexpr int acc_off = dp_off + round128(BQ * LDS * 4);
  static constexpr int lse_off = acc_off + round128(BQ * LDA * 4);
  static constexpr int delta_off = lse_off + round128(BQ * 4);
  static constexpr int bytes = delta_off + round128(BQ * 4);
  static_assert(bytes <= SMEM_LIMIT, "dq block over the shared-memory limit");
};

template <int D, bool DIAG>
__global__ void __launch_bounds__(NTHREADS)
    dq_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, const int* __restrict__ sep_ptr, int Tq, int Tk) {
  using L = DqSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* dos = reinterpret_cast<float*>(smem + L::do_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  float* dps = reinterpret_cast<float*>(smem + L::dp_off);
  float* acc = reinterpret_cast<float*>(smem + L::acc_off);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse_off);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta_off);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* kb = k + (size_t)bh * Tk * D;
  const float* vb = v + (size_t)bh * Tk * D;
  const int sep = min(max(*sep_ptr, 0), Tk);

  load_tile<D, BQ, L::LDX>(qs, q + (size_t)bh * Tq * D, q0, Tq);
  load_tile<D, BQ, L::LDX>(dos, dO + (size_t)bh * Tq * D, q0, Tq);
  load_rows<BQ>(lse_s, lse + (size_t)bh * Tq, q0, Tq);
  load_rows<BQ>(delta_s, delta + (size_t)bh * Tq, q0, Tq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += NTHREADS) acc[i] = 0.0f;
  __syncthreads();

  // The forward's tile list: the train prefix [0, sep), then the diagonal
  // keys [q0, q0 + BQ) not yet covered (Tq == Tk in that variant).
  const sm90::Tiles<BQ, BK, DIAG> tiles(sep, q0, Tk);
  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.row0(i);
    load_tile<D, BK, L::LDX>(ks, kb, key0, Tk);
    load_tile<D, BK, L::LDX>(vs, vb, key0, Tk);
    __syncthreads();
    mm<BQ, BK, D, true, false>(ss, L::LDS, qs, L::LDX, ks, L::LDX);    // S = Q K^T
    mm<BQ, BK, D, true, false>(dps, L::LDS, dos, L::LDX, vs, L::LDX);  // dP = dO V^T
    __syncthreads();
    tile_ds<DIAG, BQ>(ss, dps, L::LDS, lse_s, delta_s, q0, key0, sep, Tq, Tk);
    __syncthreads();
    mm<BQ, D, BK, false, true>(acc, L::LDA, ss, L::LDS, ks, L::LDX);  // dQ += dS K
    __syncthreads();  // the next tile overwrites ks, vs, ss and dps
  }

  // A row that saw no allowed key keeps dq = 0.
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) {
    const int r = i / D, c = i % D;
    if (q0 + r < Tq) dq[((size_t)bh * Tq + q0 + r) * D + c] = acc[r * L::LDA + c];
  }
}

constexpr int kBQ = 128;  // query rows per bf16 dq block, 64 per consumer warpgroup
constexpr int kBK = 64;   // keys per KV tile of the bf16 dq kernel

template <int D, bool DIAG>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    dq_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
            const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
            const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq,
            const int* __restrict__ sep_ptr, int Tq, int Tk) {
  using L = sm90::Smem<D, kBQ, kBK, 2>;  // resident: q (0) and dO (1)
  constexpr int ON = D < 64 ? D : 64;     // N of one dS K product: one panel of D
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
      const CUtensorMap* res[2] = {&mq, &mdo};
      sm90::produce<L, D, kBQ, kBK, 2>(res, &mk, &mv, base, tiles, q0, bh);
    }
  } else {
    sm90::consumer_regs();
    const int row0 = wg * 64;  // this warpgroup's rows in the query tile
    float lse2[2], dl[2];      // lse * log2(e) and delta of this thread's two rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + row0 + sm90::frag_row(2 * h);
      lse2[h] = row < Tq ? lse[(size_t)bh * Tq + row] * sm90::kLog2e : 0.0f;
      dl[h] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.0f;
    }
    float acc[NPAN][ON / 2];
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
#pragma unroll
      for (int e = 0; e < ON / 2; ++e) acc[p][e] = 0.0f;
    sm90::mbar_wait(L::res_bar(base), 0);

    for (int i = 0; i < tiles.n; ++i) {
      const int stage = i % L::STAGES;
      const int key0 = tiles.row0(i);
      sm90::mbar_wait(L::full(base, stage), (i / L::STAGES) & 1);
      const uint32_t ks = L::ring_tile(base, stage, 0), vs = L::ring_tile(base, stage, 1);

      float s[kBK / 2], dp[kBK / 2];  // S = Q K^T, dP = dO V^T
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        sm90::wgmma_ss<kBK>(s, sm90::desc_k_major<D, kBQ>(L::res_tile(base, 0), row0, kd),
                            sm90::desc_k_major<D, kBK>(ks, 0, kd), kd > 0);
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd)
        sm90::wgmma_ss<kBK>(dp, sm90::desc_k_major<D, kBQ>(L::res_tile(base, 1), row0, kd),
                            sm90::desc_k_major<D, kBK>(vs, 0, kd), kd > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      const bool masked = key0 + kBK > sep;  // the tile holding sep, or a diagonal tile
#pragma unroll
      for (int e = 0; e < kBK / 2; ++e) {
        const int h = (e >> 1) & 1;
        float p = exp2f(fmaf(s[e], sm90::kLog2e, -lse2[h]));
        if (masked && !sm90::allowed<DIAG>(q0 + row0 + sm90::frag_row(e), key0 + sm90::frag_col(e), sep, Tk)) p = 0.0f;
        s[e] = p * (dp[e] - dl[h]);  // ds
      }

      uint32_t dsa[kBK / 16][4];  // dS in bf16, the A operand of dQ += dS K
      sm90::to_a_frags<kBK>(s, dsa);
#pragma unroll
      for (int p = 0; p < NPAN; ++p) sm90::fence_regs(acc[p]);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NPAN; ++p) sm90::wgmma_rs_tb<ON>(acc[p], dsa[kk], sm90::desc_mn_major<D, kBK>(ks, kk, p));
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
#pragma unroll
      for (int p = 0; p < NPAN; ++p) sm90::fence_regs(acc[p]);
      sm90::fence_regs(dsa);
      sm90::mbar_arrive(L::empty(base, stage));
    }

    // A row that saw no allowed key keeps dq = 0.
    const float one[2] = {1.0f, 1.0f};
#pragma unroll
    for (int p = 0; p < NPAN; ++p)
      sm90::store_panel<ON, D>(dq + (size_t)bh * Tq * D, acc[p], one, q0 + row0, Tq, p * ON);
  }
}

constexpr int FKT = 64;  // keys per f32 dk/dv unit

// Shared memory of an f32 dk/dv block, in floats: the unit's K and V
// (resident), a ring of two query steps of 64 rows (Q, dO, lse, delta), and
// one score tile that stages P^T, then dS^T, for the product that reads it
// (two staging tiles would put the block at 245 KB at D = 128; 219 KB here).
template <int D>
struct DkvF32Smem {
  static constexpr int QS = 64;  // query rows per step
  static constexpr int LDX = f32::ld_tile(D);
  static constexpr int LDP = f32::ld_scores(QS);
  static constexpr int STAGE = 2 * QS * LDX + 2 * QS;  // Q, dO, lse, delta
  static constexpr int k_off = 0;
  static constexpr int v_off = k_off + FKT * LDX;
  static constexpr int ring_off = v_off + FKT * LDX;
  static constexpr int sc_off = ring_off + 2 * STAGE;
  static constexpr int bytes = (sc_off + FKT * LDP) * 4;
  static_assert(bytes <= SMEM_LIMIT, "f32 dk/dv block over the shared-memory limit");
  static_assert(STAGE % 4 == 0 && (2 * QS * LDX) % 4 == 0, "ring slots must stay 16-byte aligned");
};

// Q, dO, lse and delta of the query step at q0 into a ring stage.
template <int D>
__device__ __forceinline__ void load_step(float* stage, const float* qb, const float* dob, const float* lseb,
                                          const float* deltab, int q0, int Tq) {
  constexpr int QS = DkvF32Smem<D>::QS, LDX = DkvF32Smem<D>::LDX;
  f32::load_tile_async<D, QS>(stage, qb, q0, Tq);
  f32::load_tile_async<D, QS>(stage + QS * LDX, dob, q0, Tq);
  f32::load_vec_async<QS>(stage + 2 * QS * LDX, lseb, q0, Tq);
  f32::load_vec_async<QS>(stage + 2 * QS * LDX + QS, deltab, q0, Tq);
}

// Units u = key tile * BH + b*h, key-tile major as in dkv_sm90: every heavy
// unit (below sep) first, for any sep; block b takes units b, b + gridDim.x.
// At D = 32 two blocks fit an SM's shared memory, so ptxas keeps to 128
// registers there.
template <int D, bool DIAG>
__global__ void __launch_bounds__(f32::kThreads, D == 32 ? 2 : 1)
    dkv_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
            const float* __restrict__ dO, const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, const int* __restrict__ sep_ptr, int BH, int Tq,
            int Tk) {
  using L = DkvF32Smem<D>;
  using C = f32::Cols<D>;
  constexpr int QS = L::QS;
  extern __shared__ __align__(16) float fsm[];
  float* ks = fsm + L::k_off;
  float* vs = fsm + L::v_off;
  float* sc = fsm + L::sc_off;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int sep = min(max(*sep_ptr, 0), Tk);
  const int units = (Tk + FKT - 1) / FKT * BH;

  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int k0 = u / BH * FKT, bh = u % BH;
    const sm90::QueryTiles<QS, FKT, DIAG> tiles(sep, k0, Tq);
    const float* qb = q + (size_t)bh * Tq * D;
    const float* dob = dO + (size_t)bh * Tq * D;
    const float* lseb = lse + (size_t)bh * Tq;
    const float* deltab = delta + (size_t)bh * Tq;
    __syncthreads();  // every thread is done with the last unit's K, V and ring
    if (tiles.n > 0) {
      f32::load_tile_async<D, FKT>(ks, k + (size_t)bh * Tk * D, k0, Tk);
      f32::load_tile_async<D, FKT>(vs, v + (size_t)bh * Tk * D, k0, Tk);
      load_step<D>(fsm + L::ring_off, qb, dob, lseb, deltab, tiles.row0(0), Tq);
    }
    f32::cp_async_commit();

    // dK and dV of keys k0 + ty + 16 r, in registers.
    float dka[4][C::PER_THREAD], dva[4][C::PER_THREAD];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < C::PER_THREAD; ++c) dka[r][c] = dva[r][c] = 0.0f;
    const bool key_edge = k0 + FKT > sep;  // keys at or past sep in this unit

    for (int i = 0; i < tiles.n; ++i) {
      f32::cp_async_wait<0>();
      __syncthreads();  // step i is in; every thread is done with step i - 1 and the score tile
      if (i + 1 < tiles.n)
        load_step<D>(fsm + L::ring_off + ((i + 1) & 1) * L::STAGE, qb, dob, lseb, deltab, tiles.row0(i + 1), Tq);
      f32::cp_async_commit();
      const float* qs = fsm + L::ring_off + (i & 1) * L::STAGE;
      const float* dos = qs + QS * L::LDX;
      const float* lse_s = qs + 2 * QS * L::LDX;
      const float* delta_s = lse_s + QS;
      const int q0 = tiles.row0(i);

      // S^T = K Q^T and dP^T = V dO^T: keys k0 + ty + 16 r as rows, queries
      // q0 + tx + 16 j as columns; then p (in st) and ds (in dpt).
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[r][j] = dpt[r][j] = 0.0f;
      f32::mma_nt<4, 4, D>(st, ks + ty * L::LDX, 16 * L::LDX, qs + tx * L::LDX, 16 * L::LDX);
      f32::mma_nt<4, 4, D>(dpt, vs + ty * L::LDX, 16 * L::LDX, dos + tx * L::LDX, 16 * L::LDX);
      const bool masked = key_edge || q0 + QS > Tq;  // a step not wholly inside the allowed region
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float lse2 = lse_s[c] * f32::kLog2e, dl = delta_s[c];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float p = exp2f(fmaf(st[r][j], f32::kLog2e, -lse2));
          if (masked && !(q0 + c < Tq && sm90::allowed<DIAG>(q0 + c, k0 + ty + 16 * r, sep, Tk))) p = 0.0f;
          dpt[r][j] = p * (dpt[r][j] - dl);
          sc[(ty + 16 * r) * L::LDP + c] = p;
        }
      }
      __syncthreads();  // P^T is in
      f32::mma_nn<4, D, QS>(dva, sc + ty * L::LDP, 16 * L::LDP, dos, L::LDX, tx);  // dV += P^T dO
      __syncthreads();  // every thread is done with P^T
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) sc[(ty + 16 * r) * L::LDP + tx + 16 * j] = dpt[r][j];
      __syncthreads();  // dS^T is in
      f32::mma_nn<4, D, QS>(dka, sc + ty * L::LDP, 16 * L::LDP, qs, L::LDX, tx);  // dK += dS^T Q
    }

    // A key no query attends to keeps dk = dv = 0.
    const float one[4] = {1.0f, 1.0f, 1.0f, 1.0f};
    f32::store_rows<4, D>(dk + (size_t)bh * Tk * D, dka, one, k0, Tk, tx, ty);
    f32::store_rows<4, D>(dv + (size_t)bh * Tk * D, dva, one, k0, Tk, tx, ty);
  }
}

constexpr int kKT = 128;  // keys per bf16 dk/dv unit, 64 per consumer warpgroup
constexpr int kQT = 64;   // query rows per ring tile of the bf16 dk/dv kernel

// Resident: k (0) and v (1) of the unit's key tile; ring slots: q (tile 0)
// and dO (tile 1) of a query tile with the vectors lse * log2(e) (0) and
// delta (1) of its rows.
template <int D>
using DkvLayout = sm90::Smem<D, kKT, kQT, 2, 2>;

// Units u = key tile * BH + b*h, key-tile major: every key tile below sep
// (the ones that walk all query tiles) comes before every tile past it, for
// any sep, so a block's first units are the heavy ones. Block b takes units
// b, b + gridDim.x, ...
template <int D, bool DIAG>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    dkv_sm90(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
             const __grid_constant__ CUtensorMap mv, const __grid_constant__ CUtensorMap mdo,
             const float* __restrict__ lse, const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
             __nv_bfloat16* __restrict__ dv, const int* __restrict__ sep_ptr, int BH, int Tq, int Tk) {
  using L = DkvLayout<D>;
  using List = sm90::QueryTiles<kQT, kKT, DIAG>;
  constexpr int ON = D < 64 ? D : 64;  // N of one P^T dO or dS^T Q product: one panel of D
  constexpr int NPAN = D / ON;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_base(smem_raw);
  const int wg = threadIdx.x / 128;
  const int sep = min(max(*sep_ptr, 0), Tk);
  const int units = (Tk + kKT - 1) / kKT * BH;

  if (threadIdx.x == 0) {
    sm90::mbar_init(L::res_bar(base), 1);
    for (int s = 0; s < L::STAGES; ++s) {
      sm90::mbar_init(L::full(base, s), 1 + 32);  // lane 0's expect_tx, then every lane after its vector stores
      sm90::mbar_init(L::empty(base, s), sm90::kConsumerThreads);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    sm90::producer_regs();
    if (threadIdx.x < 256 + 32) {  // the producer warp
      const CUtensorMap* res[2] = {&mk, &mv};
      const int lane = threadIdx.x & 31;
      int it = 0;  // ring tiles so far
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int k0 = u / BH * kKT, bh = u % BH;
        const List tiles(sep, k0, Tq);
        if (tiles.n == 0) continue;
        // The last unit's K and V stay in use until its last tile is released.
        if (it > 0) sm90::mbar_wait(L::empty(base, (it - 1) % L::STAGES), ((it - 1) / L::STAGES) & 1);
        const float* lse_b = lse + (size_t)bh * Tq;
        const float* delta_b = delta + (size_t)bh * Tq;
        auto vectors = [&](int q0, int s) {
          float* vec = sm90::smem_ptr<float>(smem_raw, L::vec(base, s, 0));
          for (int j = lane; j < kQT; j += 32) {
            const bool in = q0 + j < Tq;
            vec[j] = in ? lse_b[q0 + j] * sm90::kLog2e : 0.0f;
            vec[kQT + j] = in ? delta_b[q0 + j] : 0.0f;
          }
          sm90::mbar_arrive(L::full(base, s));
        };
        sm90::produce<L, D, kKT, kQT, 2>(res, &mq, &mdo, base, tiles, k0, bh, it, vectors);
        it += tiles.n;
      }
    }
  } else {
    sm90::consumer_regs();
    const int kw = wg * 64;  // this warpgroup's keys in the key tile
    int it = 0, loaded = 0;  // ring tiles and resident loads so far
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int k0 = u / BH * kKT, bh = u % BH;
      const List tiles(sep, k0, Tq);
      float dka[NPAN][ON / 2], dva[NPAN][ON / 2];
#pragma unroll
      for (int p = 0; p < NPAN; ++p)
#pragma unroll
        for (int e = 0; e < ON / 2; ++e) dka[p][e] = dva[p][e] = 0.0f;
      if (tiles.n > 0) sm90::mbar_wait(L::res_bar(base), loaded++ & 1);
      const bool key_edge = k0 + kw + 64 > sep;  // keys at or past sep among this warpgroup's

      for (int i = 0; i < tiles.n; ++i, ++it) {
        const int stage = it % L::STAGES;
        const int q0 = tiles.row0(i);
        sm90::mbar_wait(L::full(base, stage), (it / L::STAGES) & 1);
        const uint32_t qs = L::ring_tile(base, stage, 0), dos = L::ring_tile(base, stage, 1);

        // S^T = K Q^T and dP^T = dO V^T transposed (V dO^T): keys as rows,
        // queries as columns, so P^T and dS^T come out in the A layout.
        float st[kQT / 2], dpt[kQT / 2];
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);
        sm90::wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd)
          sm90::wgmma_ss<kQT>(st, sm90::desc_k_major<D, kKT>(L::res_tile(base, 0), kw, kd),
                              sm90::desc_k_major<D, kQT>(qs, 0, kd), kd > 0);
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd)
          sm90::wgmma_ss<kQT>(dpt, sm90::desc_k_major<D, kKT>(L::res_tile(base, 1), kw, kd),
                              sm90::desc_k_major<D, kQT>(dos, 0, kd), kd > 0);
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
        sm90::fence_regs(st);
        sm90::fence_regs(dpt);

        // lse * log2(e) and delta of the queries (columns), from the slot.
        const float* lse2 = sm90::smem_ptr<float>(smem_raw, L::vec(base, stage, 0));
        const float* dl = lse2 + kQT;
        const bool masked = key_edge || q0 + kQT > Tq;  // a tile not wholly inside the allowed region
#pragma unroll
        for (int e = 0; e < kQT / 2; ++e) {
          const int c = sm90::frag_col(e);
          float p = exp2f(fmaf(st[e], sm90::kLog2e, -lse2[c]));
          if (masked && !(q0 + c < Tq && sm90::allowed<DIAG>(q0 + c, k0 + kw + sm90::frag_row(e), sep, Tk))) p = 0.0f;
          dpt[e] = p * (dpt[e] - dl[c]);  // ds
          st[e] = p;
        }

        uint32_t pa[kQT / 16][4], dsa[kQT / 16][4];  // P^T and dS^T in bf16, the A operands
        sm90::to_a_frags<kQT>(st, pa);
        sm90::to_a_frags<kQT>(dpt, dsa);
#pragma unroll
        for (int p = 0; p < NPAN; ++p) {
          sm90::fence_regs(dva[p]);
          sm90::fence_regs(dka[p]);
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQT / 16; ++kk)
#pragma unroll
          for (int p = 0; p < NPAN; ++p) {
            sm90::wgmma_rs_tb<ON>(dva[p], pa[kk], sm90::desc_mn_major<D, kQT>(dos, kk, p));  // dV += P^T dO
            sm90::wgmma_rs_tb<ON>(dka[p], dsa[kk], sm90::desc_mn_major<D, kQT>(qs, kk, p));  // dK += dS^T Q
          }
        sm90::wgmma_commit();
        sm90::wgmma_wait_all();
#pragma unroll
        for (int p = 0; p < NPAN; ++p) {
          sm90::fence_regs(dva[p]);
          sm90::fence_regs(dka[p]);
        }
        sm90::fence_regs(pa);
        sm90::fence_regs(dsa);
        sm90::mbar_arrive(L::empty(base, stage));
      }

      // A key no query attends to keeps dk = dv = 0.
      const float one[2] = {1.0f, 1.0f};
#pragma unroll
      for (int p = 0; p < NPAN; ++p) {
        sm90::store_panel<ON, D>(dk + (size_t)bh * Tk * D, dka[p], one, k0 + kw, Tk, p * ON);
        sm90::store_panel<ON, D>(dv + (size_t)bh * Tk * D, dva[p], one, k0 + kw, Tk, p * ON);
      }
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
  if constexpr (is_bf16<T>) {
    using L = sm90::Smem<D, kBQ, kBK, 2>;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err;
    if ((err = sm90::make_map(&mq, a.q, a.BH, a.Tq, D, kBQ)) != cudaSuccess) return err;
    if ((err = sm90::make_map(&mdo, a.dO, a.BH, a.Tq, D, kBQ)) != cudaSuccess) return err;
    if ((err = sm90::make_map(&mk, a.k, a.BH, a.Tk, D, kBK)) != cudaSuccess) return err;
    if ((err = sm90::make_map(&mv, a.v, a.BH, a.Tk, D, kBK)) != cudaSuccess) return err;
    auto kernel = dq_sm90<D, DIAG>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes)) != cudaSuccess)
      return err;
    const dim3 grid((a.Tq + kBQ - 1) / kBQ, a.BH);
    kernel<<<grid, sm90::kThreads, L::bytes, a.stream>>>(mq, mk, mv, mdo, static_cast<const float*>(a.lse),
                                                          static_cast<const float*>(a.delta),
                                                          static_cast<__nv_bfloat16*>(a.out0),
                                                          static_cast<const int*>(a.sep), a.Tq, a.Tk);
  } else {
    using L = DqSmem<D>;
    auto kernel = dq_f32<D, DIAG>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid((a.Tq + BQ - 1) / BQ, a.BH);
    kernel<<<grid, NTHREADS, L::bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const float*>(a.dO), static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.out0), static_cast<const int*>(a.sep), a.Tq, a.Tk);
  }
  return cudaGetLastError();
}

template <typename T, int D, bool DIAG>
cudaError_t launch_dkv(const Args& a) {
  if constexpr (is_bf16<T>) {
    using L = DkvLayout<D>;
    CUtensorMap mq, mk, mv, mdo;
    cudaError_t err;
    if ((err = sm90::make_map(&mq, a.q, a.BH, a.Tq, D, kQT)) != cudaSuccess) return err;
    if ((err = sm90::make_map(&mdo, a.dO, a.BH, a.Tq, D, kQT)) != cudaSuccess) return err;
    if ((err = sm90::make_map(&mk, a.k, a.BH, a.Tk, D, kKT)) != cudaSuccess) return err;
    if ((err = sm90::make_map(&mv, a.v, a.BH, a.Tk, D, kKT)) != cudaSuccess) return err;
    auto kernel = dkv_sm90<D, DIAG>;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes)) != cudaSuccess)
      return err;
    // Persistent: at most one block per SM (one fits by shared memory), set
    // from the shapes and the card only.
    int device = 0, sms = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    const int units = (a.Tk + kKT - 1) / kKT * a.BH;
    kernel<<<units < sms ? units : sms, sm90::kThreads, L::bytes, a.stream>>>(
        mq, mk, mv, mdo, static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<__nv_bfloat16*>(a.out0), static_cast<__nv_bfloat16*>(a.out1), static_cast<const int*>(a.sep),
        a.BH, a.Tq, a.Tk);
  } else {
    using L = DkvF32Smem<D>;
    auto kernel = dkv_f32<D, DIAG>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return err;
    // Persistent: as many blocks as fit on the card at once, at most one a
    // unit, set from the shapes and the card only.
    int device = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, f32::kThreads, L::bytes)) !=
        cudaSuccess)
      return err;
    const int units = (a.Tk + FKT - 1) / FKT * a.BH;
    const int blocks = sms * (per_sm > 0 ? per_sm : 1);
    kernel<<<units < blocks ? units : blocks, f32::kThreads, L::bytes, a.stream>>>(
        static_cast<const float*>(a.q), static_cast<const float*>(a.k), static_cast<const float*>(a.v),
        static_cast<const float*>(a.dO), static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<float*>(a.out0), static_cast<float*>(a.out1), static_cast<const int*>(a.sep), a.BH, a.Tq, a.Tk);
  }
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
