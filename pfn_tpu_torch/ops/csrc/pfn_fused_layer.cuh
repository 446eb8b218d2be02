// What the fused PFN encoder layer's forward (pfn_fused_layer_fwd.cu) and
// backward (pfn_fused_layer_bwd.cu) chains share, dispatched on the compute
// dtype: bf16 to the Hopper kernels, f32 to the FMA bodies of
// pfn_fused_common.cuh (f32 stays f32, no TF32): its register-tiled GEMM
// and its attention.
//   * product: out = epilogue(A W) for a row-major activation A and a weight
//     W read where it lies (or as W^T);
//   * attention: the PFN attention over qkv, all heads, with the softmax
//     from the row (the forward, which writes lse) or from a saved lse (the
//     backward's recompute). In bf16 that is attn_fwd_sm90 below.
//
// attn_fwd_sm90<DH, SAVED_LSE> replaces the attention body `_attn_item` of
// pfn_tpu/ops/fused_layer.py (:85-119), which `_fwd_kernel` and
// `_bwd_attn_kernel` call. One warpgroup (128 threads) per (64 query rows,
// head h, item b). Thread 0 starts the TMA loads: the rows' q once, then per
// allowed key tile of 64 keys (the prefix tiles below sep, then the block's
// own diagonal tiles: pfn_flash_sm90.cuh's Tiles) its K, and V where the
// pass needs it, into a ring of two slots, so the next tile's loads overlap
// this tile's products. Q, K and V are read from qkv in place through one
// 4-D tensor map (item, head, row, column) of pfn_gemm_sm90.cuh: a tile past
// T reads zeros, never the next item's rows, and head dims 16 and 32 are
// zero-filled up to one 64-column panel. S = Q K^T runs on wgmma from shared
// memory into register fragments; the softmax runs on the fragments.
//
// Rounding follows the TPU kernel, which normalises p before rounding it to
// the compute dtype for P.V: p = cdt(e / l), not a flash-style running
// output rescaled at the end. So the body makes two passes over the key
// tiles: pass 1 (the forward only) keeps each row's running max and sum of
// exp(s - max) and writes lse = max + log(sum); pass 2 recomputes S, forms
// p = cdt(exp(s - lse)) on the fragments as the register A operand, and runs
// O += P V on wgmma with V read MN-major. The backward's recompute, which
// takes the saved lse, is pass 2 alone. O is rounded to bf16 and stored; rows
// past T are neither stored nor allowed any key. sep is read from device
// memory. What bounds it: at T <= 512 its products are a few percent of the
// layer's, so its latency (two passes, a 64-row block) matters more than its
// rate; at the flagship shape it is 512 blocks of 128 threads.

#pragma once

#include "pfn_fused_common.cuh"
#include "pfn_gemm_sm90.cuh"

namespace {

namespace g90 = pfn_gemm_sm90;

// ---- the products ------------------------------------------------------------

// out (M, N) = epilogue(A W) with A (M, K) row-major and W (K, N) row-major,
// or, with WT, W stored (N, K) and read as its transpose where it lies. bf16:
// the wgmma GEMM, A K-major and W MN-major (K-major for W^T); f32: the FMA
// GEMM of pfn_fused_common.cuh. With `colsum`, both also write the f32
// output's column sums over each 128-row tile (ceil(M / 128) rows of N).
template <typename T, int EPI, bool WT = false>
cudaError_t product(const void* A, const void* W, const void* bias, const void* aux, void* out, void* out2, int M,
                    int N, int K, cudaStream_t s, void* colsum = nullptr) {
  if constexpr (is_bf16_v<T>) {
    const g90::Epi ep{static_cast<const float*>(bias), static_cast<const float*>(aux), out, out2,
                      static_cast<float*>(colsum), N, 0, 0, 1.0f};
    return g90::gemm<EPI, 128, false, !WT>(g90::matrix(A, M, K, K),
                                           WT ? g90::matrix(W, N, K, K) : g90::matrix(W, K, N, N),
                                           g90::Shape{M, N, K, 1, 1, 0, 0}, ep, s);
  } else {
    GemmArgs a = dense_args(A, W, bias, aux, out, M, N, K);
    a.out2 = out2;
    a.colsum = static_cast<float*>(colsum);
    if (WT) a.ldw = K;
    return gemm<EPI, false, WT>(a, 1, s);
  }
}

// ---- the bf16 PFN attention on wgmma -------------------------------------------

constexpr int FBQ = 64;  // query rows per block: one wgmma M
constexpr int FBK = 64;  // keys per K/V tile

// Shared memory: the q tile, then two ring slots of a K and a V tile, each
// tile 64 rows of DP columns in 64-column panels of 128-byte rows (8 KB a
// panel, 128-byte swizzle), then the barriers (q, and each slot's `full`).
template <int DH>
struct AttnFwdSmem {
  static constexpr int DP = DH < 64 ? 64 : DH;  // the head dim in whole 64-column panels
  static constexpr int tile_bytes = FBQ * DP * 2;
  static constexpr int kSlots = 2;
  static constexpr int bar_off = (1 + 2 * kSlots) * tile_bytes;
  static constexpr int bytes = bar_off + 8 * (1 + kSlots) + 1024;  // + alignment slack

  __device__ static uint32_t k(uint32_t base, int s) { return base + (1 + 2 * s) * tile_bytes; }
  __device__ static uint32_t v(uint32_t base, int s) { return k(base, s) + tile_bytes; }
  __device__ static uint32_t q_bar(uint32_t base) { return base + bar_off; }
  __device__ static uint32_t full(uint32_t base, int s) { return base + bar_off + 8 * (1 + s); }
};

// sc = Q K^T (unscaled) for the 64 rows of the q tile at shared address q
// and the K tile at k, once the barrier `full` has passed phase `parity`.
template <int DH>
__device__ __forceinline__ void scores_sm90(uint32_t q, uint32_t k, uint32_t full, uint32_t parity,
                                            float (&sc)[FBK / 2]) {
  namespace sm90 = pfn_flash_sm90;
  constexpr int DP = AttnFwdSmem<DH>::DP;
  sm90::mbar_wait(full, parity);
  sm90::fence_regs(sc);
  sm90::wgmma_fence();
#pragma unroll
  for (int kd = 0; kd < DH / 16; ++kd)
    sm90::wgmma_ss<FBK>(sc, sm90::desc_k_major<DP, FBQ>(q, 0, kd), sm90::desc_k_major<DP, FBK>(k, 0, kd), kd > 0);
  sm90::wgmma_commit();
  sm90::wgmma_wait_all();
  sm90::fence_regs(sc);
}

// qkv (B*seq, 3D) bf16 through the map mqkv (see make_qkv_map); writes attn
// (B*seq, D) bf16, head h at columns h*DH; lse (B, seq, H) f32 is written
// (SAVED_LSE false) or read (true). Grid (ceil(seq / 64), H, B).
template <int DH, bool SAVED_LSE>
__global__ void __launch_bounds__(128)
    attn_fwd_sm90(const __grid_constant__ CUtensorMap mqkv, __nv_bfloat16* __restrict__ attn,
                  float* __restrict__ lse, const int* __restrict__ sep_ptr, int seq, int D, int H) {
  namespace sm90 = pfn_flash_sm90;
  using L = AttnFwdSmem<DH>;
  constexpr int NP = L::DP / 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_base(smem_raw);
  const int q0 = blockIdx.x * FBQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);  // 1 / sqrt(dh), correctly rounded
  const sm90::Tiles<FBQ, FBK, true> tiles(sep, q0, seq);
  // The ring walks the tile list once per pass: step j is tile j % n of pass
  // 1 while j < n0 (K only), then of pass 2 (K and V).
  const int n0 = SAVED_LSE ? 0 : tiles.n, steps = n0 + tiles.n;

  // Rows row0 .. row0 + 63 of column block `head` of qkv (item b), every
  // panel, onto barrier `bar`.
  auto load = [&](uint32_t dst, uint32_t bar, int head, int row0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) sm90::tma_load_4d(dst + p * FBQ * 128, &mqkv, bar, p * 64, head, row0, b);
  };
  auto issue = [&](int j) {  // thread 0: the loads of step j into slot j % 2
    const int s = j % L::kSlots, key0 = tiles.row0(j % tiles.n);
    const bool with_v = j >= n0;
    sm90::mbar_expect_tx(L::full(base, s), (with_v ? 2 : 1) * L::tile_bytes);
    load(L::k(base, s), L::full(base, s), H + h, key0);
    if (with_v) load(L::v(base, s), L::full(base, s), 2 * H + h, key0);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(L::q_bar(base), 1);
    for (int s = 0; s < L::kSlots; ++s) sm90::mbar_init(L::full(base, s), 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(L::q_bar(base), L::tile_bytes);
    load(base, L::q_bar(base), h, q0);
    for (int j = 0; j < L::kSlots && j < steps; ++j) issue(j);
  }

  int rows[2];
  float ls[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rows[hh] = q0 + sm90::frag_row(2 * hh);
    ls[hh] = SAVED_LSE && rows[hh] < seq ? lse[((size_t)b * seq + rows[hh]) * H + h] : 0.0f;
  }
  // Key `key` allowed for query `row` (rows past T have none).
  auto allowed = [sep, seq](int row, int key) { return row < seq && key < seq && (key < sep || key == row); };
  // Every thread is done with step j's slot: thread 0 refills it with step j + 2.
  auto release = [&](int j) {
    __syncthreads();
    if (threadIdx.x == 0 && j + L::kSlots < steps) issue(j + L::kSlots);
  };
  sm90::mbar_wait(L::q_bar(base), 0);

  if constexpr (!SAVED_LSE) {
    // Pass 1: each row's running max m and this thread's share of the sum
    // of exp(s - m) over its allowed keys.
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
    for (int j = 0; j < n0; ++j) {
      const int key0 = tiles.row0(j);
      float sc[FBK / 2];
      scores_sm90<DH>(base, L::k(base, j % L::kSlots), L::full(base, j % L::kSlots), (j / L::kSlots) & 1, sc);
      release(j);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -INFINITY;
#pragma unroll
        for (int e = 2 * hh; e < FBK / 2; e += 4)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (allowed(rows[hh], key0 + sm90::frag_col(e + u))) mx = fmaxf(mx, sc[e + u] * scale);
        const float m_new = fmaxf(m[hh], sm90::quad_max(mx));
        if (m_new == -INFINITY) continue;  // no allowed key yet in this row
        float sum = 0.0f;
#pragma unroll
        for (int e = 2 * hh; e < FBK / 2; e += 4)
#pragma unroll
          for (int u = 0; u < 2; ++u)
            if (allowed(rows[hh], key0 + sm90::frag_col(e + u))) sum += expf(sc[e + u] * scale - m_new);
        l[hh] = l[hh] * expf(m[hh] - m_new) + sum;
        m[hh] = m_new;
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      ls[hh] = m[hh] + logf(sm90::quad_sum(l[hh]));  // every row below seq holds its diagonal key
      if ((threadIdx.x & 3) == 0 && rows[hh] < seq) lse[((size_t)b * seq + rows[hh]) * H + h] = ls[hh];
    }
  }

  // Pass 2: O = cdt(exp(s - lse)) V over the same tiles.
  float o[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[p][e] = 0.0f;
  for (int j = n0; j < steps; ++j) {
    const int s = j % L::kSlots, key0 = tiles.row0(j - n0);
    float sc[FBK / 2];
    scores_sm90<DH>(base, L::k(base, s), L::full(base, s), (j / L::kSlots) & 1, sc);
#pragma unroll
    for (int e = 0; e < FBK / 2; ++e) {
      const int hh = (e >> 1) & 1;
      sc[e] = allowed(rows[hh], key0 + sm90::frag_col(e)) ? expf(sc[e] * scale - ls[hh]) : 0.0f;
    }
    uint32_t pa[FBK / 16][4];  // cdt(p), the A operand of O += P V
    sm90::to_a_frags<FBK>(sc, pa);
#pragma unroll
    for (int p = 0; p < NP; ++p) sm90::fence_regs(o[p]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < FBK / 16; ++kk)
#pragma unroll
      for (int p = 0; p < NP; ++p)
        sm90::wgmma_rs_tb<64>(o[p], pa[kk], sm90::desc_mn_major<L::DP, FBK>(L::v(base, s), kk, p));
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) sm90::fence_regs(o[p]);
    sm90::fence_regs(pa);
    release(j);
  }

  // attn = cdt(O), columns below DH only (the panel's rest is the zero fill).
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    if (rows[hh] >= seq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(attn + ((size_t)b * seq + rows[hh]) * D + h * DH);
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int col = p * 64 + 8 * jj + 2 * (threadIdx.x & 3);
        if (col < DH) dst[col / 2] = sm90::pack_bf16(o[p][4 * jj + 2 * hh], o[p][4 * jj + 2 * hh + 1]);
      }
  }
}

// The 4-D map (item, column block, row, column) over qkv (B*seq, 3D) whose
// column blocks are the 3H heads of q, k and v; its box is one 64-column
// panel of 64 rows.
inline cudaError_t make_qkv_map(CUtensorMap* map, const void* qkv, int B, int seq, int D, int H) {
  const long long n = seq, dh = D / H;
  return g90::make_map(map, g90::Tensor4{qkv, dh, 3LL * H, n, B, dh, 3LL * D, n * 3 * D}, FBQ);
}

template <int DH, bool SAVED_LSE>
cudaError_t attention_sm90(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D, int H,
                           cudaStream_t stream) {
  using L = AttnFwdSmem<DH>;
  CUtensorMap mqkv;
  RETURN_IF_ERROR(make_qkv_map(&mqkv, qkv, B, seq, D, H));
  auto kernel = attn_fwd_sm90<DH, SAVED_LSE>;
  static bool allowed[g90::kMaxDevices] = {};  // the shared-memory limit, once per device
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (device >= g90::kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
    allowed[device] = true;
  }
  const dim3 grid((seq + FBQ - 1) / FBQ, H, B);
  kernel<<<grid, 128, L::bytes, stream>>>(mqkv, static_cast<__nv_bfloat16*>(attn), static_cast<float*>(lse),
                                          static_cast<const int*>(sep), seq, D, H);
  return cudaGetLastError();
}

// attn (B*seq, D) from qkv (B*seq, 3D), both in T; lse (B, seq, H) f32
// written (SAVED_LSE false) or read (true). `sep` is an int32 in device memory.
template <typename T, bool SAVED_LSE>
cudaError_t attention(const void* qkv, void* attn, void* lse, const void* sep, int B, int seq, int D, int H,
                      cudaStream_t s) {
  if constexpr (!is_bf16_v<T>) {
    if constexpr (SAVED_LSE) return attention_recompute_f32(qkv, attn, lse, sep, B, seq, D, H, s);
    else return attention_f32(qkv, attn, lse, sep, B, seq, D, H, s);
  } else {
    switch (D / H) {
      case 16:
        return attention_sm90<16, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
      case 32:
        return attention_sm90<32, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
      case 64:
        return attention_sm90<64, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
      case 128:
        return attention_sm90<128, SAVED_LSE>(qkv, attn, lse, sep, B, seq, D, H, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

}  // namespace
