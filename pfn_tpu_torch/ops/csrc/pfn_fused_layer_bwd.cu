// Fused PFN encoder layer, backward, for Hopper (sm_90a): two entry points.
//
// Replaces: pfn_tpu/ops/fused_layer.py, `_bwd_call`'s two Pallas calls:
//   * pfn_fused_layer_bwd_ffn: `_bwd_ffn_kernel` (:165-201, pl.pallas_call at
//     :358). From the forward's saved r (post-LN1) and dy: recompute
//     h1 = cdt(r) W1 + b1, g = cdt(gelu(h1)), r2 = r + g W2 + b2; then
//     dr2 = LN2'(dy), dgc = cdt(dr2) W2^T, dh1 = dgc gelu'(h1),
//     dr = dr2 + cdt(dh1) W1^T; dW2 = g^T cdt(dr2), dW1 = cdt(r)^T cdt(dh1),
//     db2, db1, dgamma2, dbeta2 as column sums.
//   * pfn_fused_layer_bwd_attn: `_bwd_attn_kernel` (:204-270, pl.pallas_call
//     at :387). From x, the saved lse and dr: recompute qkv, the attention
//     with p = exp(s - lse) and r1 = x + ao; then dr1 = LN1'(dr),
//     dWout = attn^T cdt(dr1), dO = cdt(cdt(dr1) Wout^T) per head,
//     delta = rowsum(dO * cdt(p) V) (as sum_j cdt(p)_ij dp_ij),
//     ds = cdt(p (dO V^T - delta)), dq = ds K scale, dk = ds^T Q scale
//     (q unscaled), dv = cdt(p)^T dO; dx = dr1 + cdt(dqkv) Wqkv^T,
//     dWqkv = cdt(x)^T cdt(dqkv), and the bias and LayerNorm gradients.
// Every product runs in this repository's kernels: no cuBLAS, no library
// call.
//
// Layout: x, r, dy, dr (B, T, D) f32; the matrices in the JAX layout in the
// compute dtype (f32 or bf16), biases and LayerNorm parameters f32; lse
// (B, T, H) f32 from the forward. The weight and bias gradients are f32 sums
// over the batch; dx and dr are f32. `sep` is read from an int32 in device
// memory. The caller passes every scratch buffer (pfn_tpu_torch/ops/_ext.py
// names their shapes) and the split count of each weight gradient; the
// compute-dtype copies of f32 tensors (cdt(r), cdt(x), cdt(dr2), cdt(dh1),
// cdt(dr1), cdt(dqkv)) exist only in bf16 and are null in f32, where the f32
// tensor serves. The products by a weight's transpose read the weight where
// it lies: nothing is transposed or copied.
//
// Numerics follow the TPU kernels: the same roundings to the compute dtype
// as the forward (pfn_fused_layer_fwd.cu), whose attention the recompute
// shares (attention<T, true> of pfn_fused_layer.cuh), then dr2, dh1, dr1,
// the head output gradient dO, ds and dqkv rounded before they enter a
// product; every product accumulates in f32; LayerNorm statistics and
// gradients in f32.
//
// Design. The TPU kernels walk the batch on a sequential grid and add each
// item's weight gradients into one VMEM block. Here the whole batch is one
// set of GEMMs, so a weight gradient is one product over K = B*T rows, cut
// into `splits` chunks of K (the caller's count for each gradient: as many
// as keep its output tiles times the chunks within one wave of the card's
// SMs) whose partial products are summed in order, and nothing is
// accumulated across blocks: no atomics, and every bias and LayerNorm
// gradient is partial sums (of 32 rows, or of a GEMM tile's 128 rows) added
// in a fixed order by a second pass. Two calls give bitwise-equal gradients.
//
// In bf16 every product runs on the wgmma GEMM of pfn_gemm_sm90.cuh (128 x
// 128 tiles, or 128 x 64 for the attention products at head dims up to 64;
// a persistent grid, a producer thread feeding a TMA ring, two consumer
// warpgroups, the epilogue on the accumulator fragments), with each operand
// in the layout it is stored in: activations K-major; a weight W (K, N)
// MN-major, or, for the products by W^T, W itself as the K-major B; the
// weight gradients' X^T as an MN-major A beside dY MN-major. The attention's
// dq = ds K scale, dk = ds^T Q scale and dv = cdt(p)^T dO are three batched
// launches over the B*H (item, head) pairs through 4-D tensor maps (item,
// head, row, column) of qkv, dO, p and ds, so a K tile past T reads zeros,
// never the next item's rows; at head dims 16 and 32 the tile's columns
// past the head dim are the maps' zero fill, so every head dim runs on this
// GEMM. The products whose f32 output feeds a bias gradient (dh1 for db1,
// dqkv for dbqkv) sum its columns over each 128-row tile in their epilogue
// (in bf16 they store only the rounded copy that later products read). The
// LayerNorm backward writes the partial sums of its gain, bias and
// preceding-bias gradients itself. The softmax backward runs S and dP on
// wgmma too (attn_bwd_sm90).
//
// In f32 every product runs on gemm_f32 of pfn_fused_common.cuh: FMA on the
// CUDA cores (no TF32), 128 x 128 tiles, 8 x 8 register tiles fed as float4
// from a cp.async ring, A (TA) and W (TB) read transposed in place, the same
// epilogue modes and column sums, and the weight gradients' split-K chunks
// sized for its tile and its two blocks an SM. The attention's recompute
// (attn_recompute_f32) and its softmax backward (attn_bwd_f32) run on the
// register tiles of pfn_flash_f32.cuh, 64 query rows a block, and the weight
// gradients (5, 8, 6 and 13 below) on a second stream beside the products
// that do not need them (SideStream). Each entry point enqueues a chain of
// kernels on the caller's stream and counts one launch (each weight
// gradient adds its ordered sum when its split count is above 1):
//   FFN (ten in bf16, nine in f32):
//     0. cast rc = cdt(r) (bf16 only)
//     1. gemm h1 = rc W1 + b1 (f32) and g = cdt(gelu(h1))
//     2. gemm r2 = r + g W2 + b2
//     3. ln'  dr2 = LN2'(r2, dy), cdt(dr2), partial sums of dy * xhat2, dy
//             and dr2
//     4. sums dgamma2, dbeta2, db2
//     5. gemm dW2 = g^T cdt(dr2)
//     6. gemm dh1 = (cdt(dr2) W2^T) gelu'(h1): bf16 cdt(dh1), f32 dh1, and
//             the partial sums of dh1
//     7. sums db1
//     8. gemm dW1 = rc^T cdt(dh1)
//     9. gemm dr = dr2 + cdt(dh1) W1^T
//   attention (fifteen in bf16, fourteen in f32):
//     0. cast xc = cdt(x) (bf16 only)
//     1. gemm qkv = cdt(xc Wqkv + bqkv)
//     2. attn attn = cdt(cdt(p) V), p = exp(s - lse), per (64 rows, head,
//             item): bf16 attn_fwd_sm90's recompute mode on wgmma, f32
//             attn_recompute_f32
//     3. gemm r1 = x + cdt(attn Wout + bout)
//     4. ln'  dr1 = LN1'(r1, dr), cdt(dr1), partial sums as in the FFN
//     5. sums dgamma1, dbeta1, dbout
//     6. gemm dWout = attn^T cdt(dr1)
//     7. gemm dO = cdt(cdt(dr1) Wout^T)
//     8. attn' S and dP = dO V^T over the allowed key tiles, then per row
//        delta, and cdt(p) and ds written out as (B, H, T, T16) rows (T16 =
//        T rounded up to 16, zeros where the PFN rule forbids the key): bf16
//        per (64 rows, head, item) on wgmma in two passes (delta, then ds);
//        f32 per (64 rows, head, item) in one pass over the products, then
//        one over the rows it wrote
//     9. gemm dq = ds K scale, over the B*H (item, head) pairs in one launch
//    10. gemm dk = ds^T Q scale, the same
//    11. gemm dv = cdt(p)^T dO, the same; each of 9-11 writes the partial
//        sums of dqkv, and cdt(dqkv) in bf16, dqkv in f32
//    12. sums dbqkv
//    13. gemm dWqkv = xc^T cdt(dqkv)
//    14. gemm dx = dr1 + cdt(dqkv) Wqkv^T
// The (T, T) probabilities and score gradients are written to device memory
// (2 x 5.3 MB at the flagship shape, in L2), so the three attention products
// are plain batched GEMMs; their masked entries are zeros, which add
// nothing to a sum.
//
// What bounds it at the flagship shape (B 64, T 100, D 512, H 4, F 1024,
// bf16, sep 50): the FFN part is six (6400 x 512 x 1024) products, 40.3
// GFLOP; the attention part eight products in units of 2 * 6400 * 512^2
// (qkv and its two gradients at three units each, out and its two at one),
// 40.3 GFLOP, and its dense (T, T) products 2.0 GFLOP: ~83 GFLOP, 84 us at
// the bf16 tensor-core peak, against ~65 MB of unique bytes (x, r, dy, dx in
// f32, lse, the weights and their f32 gradients), ~19 us at HBM rate. So it
// is compute bound, and most of it is GEMMs; the LayerNorm backward, the
// column sums, the casts and the split-K sums pass ~60 MB through L2 on top.
// The bound counts the recompute of the forward's products, as the TPU
// kernels do it. On an H100 80GB HBM3 at 700 W (chip_smoke.py,
// fused_bwd_timing's profile of one call) the FFN chain takes 0.24 ms of
// device time and the attention chain 0.32 ms; the dense products run at
// 120-330 TFLOP/s (K of 512-1536 is 8-24 K tiles, so a tile's ring fill and
// its epilogue's stores weigh on each, and 400 tiles at N = 1024 take 3.03
// waves), and the softmax backward takes 31 us. Later work: saving qkv and
// h1 in the forward instead of recomputing them (memory for time), and the
// epilogue overlapped with the next tile's products.
//
// In f32 the same ~83 GFLOP take 1.23 ms at the 67 TFLOP/s FMA peak (0.60
// and 0.63 ms for the two chains), so both are bound by operations. On an
// H100 80GB HBM3 at 700 W (chip_smoke.py, fused_f32_timing) the FFN chain
// takes 1.17 ms and the attention chain 1.40 ms (first port: 1.79 and 2.21).
// Alone, the weight gradients, split so as to fill a wave, run at ~45
// TFLOP/s and the other products at 27-37 TFLOP/s, because their 200, 400
// and 600 tiles leave a quarter of the 264 block slots idle in their last
// wave; the weight gradients on the second stream fill part of that (1.29
// and 1.48 ms on one stream). The attention's recompute and softmax
// backward take 0.08 and 0.09 ms. What bounds the GEMM inside a wave:
// pfn_fused_common.cuh's note.

#include "pfn_fused_layer.cuh"

namespace {

// ---- the weight gradients ------------------------------------------------------

// dW (Kin, N) f32 = X^T dY over the M rows of X (M, Kin) and dY (M, N), in
// `splits` chunks of rows summed in order (see the note at the top).
template <typename T>
cudaError_t weight_grad(const void* X, const void* dY, void* dW, int M, int Kin, int N, int splits, void* partial,
                        cudaStream_t s) {
  if constexpr (is_bf16_v<T>) {
    const int ksplit = splits > 1 ? ((M + splits - 1) / splits + g90::kBK - 1) / g90::kBK * g90::kBK : 0;
    const g90::Epi ep{nullptr, nullptr, splits > 1 ? partial : dW, nullptr, nullptr, N, (long long)Kin * N, 0, 1.0f};
    RETURN_IF_ERROR((g90::gemm<EPI_SCALE, 128, true, true>(g90::matrix(X, M, Kin, Kin),
                                                                  g90::matrix(dY, M, N, N),
                                                                  g90::Shape{Kin, N, M, splits, 1, 0, ksplit}, ep, s)));
    return splits > 1 ? split_sum(partial, dW, (size_t)Kin * N, splits, s) : cudaSuccess;
  } else {
    return gemm_weight_grad(X, dY, dW, M, Kin, N, splits, partial, s);
  }
}

// ---- column sums in a fixed order --------------------------------------------

constexpr int CS_ROWS = 32;  // rows per partial sum of the LayerNorm backward (COLSUM_ROWS in _ext.py)
// Rows per partial sum of a GEMM's column sums: its output tile, the same in both dtypes.
constexpr int GEMM_ROWS = GBM;
static_assert(g90::kBM == GEMM_ROWS, "the bf16 and f32 GEMMs sum columns over tiles of the same rows");

struct ColSumArgs {
  float* out[3];
};

// out[a][n] = sum of the partial sums in chunk order. Grid (ceil(N/128), arrays).
__global__ void __launch_bounds__(NTHREADS)
    colsum_final_kernel(const ColSumArgs args, const float* __restrict__ partial, int chunks, int N) {
  const int n = blockIdx.x * NTHREADS + threadIdx.x, a = blockIdx.y;
  if (n >= N) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += partial[((size_t)a * chunks + c) * N + n];
  args.out[a][n] = s;
}

// out[a] = the sum of `chunks` rows of partial sums, in order.
inline cudaError_t colsum_final(const ColSumArgs& args, int count, const void* partial, int chunks, int N,
                                cudaStream_t s) {
  colsum_final_kernel<<<dim3((N + NTHREADS - 1) / NTHREADS, count), NTHREADS, 0, s>>>(
      args, static_cast<const float*>(partial), chunks, N);
  return cudaGetLastError();
}

inline ColSumArgs sums(void* o0, void* o1 = nullptr, void* o2 = nullptr) {
  return ColSumArgs{{static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2)}};
}

// ---- LayerNorm backward with its column sums, f32 ------------------------------

constexpr int LNB_THREADS = 256;

// For the CS_ROWS rows of the block, of the LayerNorm input `pre` and its
// output's gradient `dout`: xhat = LN(pre) without the affine part, dres =
// the gradient of `pre` (`_ln_bwd(dout * gamma, xhat, rstd)`), dres_c =
// cdt(dres) when not null, and the sums over the rows, in row order, of
// dout * xhat, dout and dres into partial[0..2][chunk] (the LayerNorm gain,
// LayerNorm bias and preceding bias gradients' partial sums). First each
// warp the row statistics of its rows, then each thread two columns over
// all the rows.
template <typename T>
__global__ void __launch_bounds__(LNB_THREADS)
    layernorm_bwd_kernel(const float* __restrict__ pre, const float* __restrict__ dout,
                         const float* __restrict__ gamma, float* __restrict__ dres, T* __restrict__ dres_c,
                         float* __restrict__ partial, int M, int D) {
  __shared__ float stats[CS_ROWS][4];  // mu, rstd, m1, m2
  const int row0 = blockIdx.x * CS_ROWS, rows = min(CS_ROWS, M - row0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += LNB_THREADS / 32) {
    const float* x = pre + (size_t)(row0 + r) * D;
    const float* d = dout + (size_t)(row0 + r) * D;
    float mu, rstd;
    row_stats(x, D, lane, mu, rstd);
    float m1 = 0.0f, m2 = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float dxh = d[c] * gamma[c];
      m1 += dxh;
      m2 += dxh * ((x[c] - mu) * rstd);
    }
    m1 = warp_sum(m1) / D;
    m2 = warp_sum(m2) / D;
    if (lane == 0) {
      stats[r][0] = mu;
      stats[r][1] = rstd;
      stats[r][2] = m1;
      stats[r][3] = m2;
    }
  }
  __syncthreads();
  const size_t chunks = gridDim.x;
  constexpr int U = 4;  // rows whose loads are in flight together
  for (int c = 2 * threadIdx.x; c < D; c += 2 * LNB_THREADS) {
    const float2 g = *reinterpret_cast<const float2*>(gamma + c);
    float2 s_dgp = make_float2(0.0f, 0.0f), s_d = s_dgp, s_dres = s_dgp;
    for (int r0 = 0; r0 < rows; r0 += U) {
      float2 x[U], d[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t o = (size_t)(row0 + r0 + u) * D + c;
        x[u] = r0 + u < rows ? *reinterpret_cast<const float2*>(pre + o) : make_float2(0.0f, 0.0f);
        d[u] = r0 + u < rows ? *reinterpret_cast<const float2*>(dout + o) : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int r = r0 + u;
        if (r >= rows) break;
        const size_t o = (size_t)(row0 + r) * D + c;
        const float mu = stats[r][0], rstd = stats[r][1], m1 = stats[r][2], m2 = stats[r][3];
        const float2 xhat = make_float2((x[u].x - mu) * rstd, (x[u].y - mu) * rstd);
        const float2 v = make_float2(rstd * (d[u].x * g.x - m1 - xhat.x * m2),
                                     rstd * (d[u].y * g.y - m1 - xhat.y * m2));
        *reinterpret_cast<float2*>(dres + o) = v;
        if constexpr (is_bf16_v<T>) {
          if (dres_c) *reinterpret_cast<__nv_bfloat162*>(dres_c + o) = __floats2bfloat162_rn(v.x, v.y);
        }
        s_dgp.x += __fmul_rn(d[u].x, xhat.x);  // the product rounded before the sum, as dout * xhat stored
        s_dgp.y += __fmul_rn(d[u].y, xhat.y);
        s_d.x += d[u].x;
        s_d.y += d[u].y;
        s_dres.x += v.x;
        s_dres.y += v.y;
      }
    }
    *reinterpret_cast<float2*>(partial + (0 * chunks + blockIdx.x) * D + c) = s_dgp;
    *reinterpret_cast<float2*>(partial + (1 * chunks + blockIdx.x) * D + c) = s_d;
    *reinterpret_cast<float2*>(partial + (2 * chunks + blockIdx.x) * D + c) = s_dres;
  }
}

// The LayerNorm backward, then the gain, LayerNorm-bias and preceding-bias
// gradients dg, dbe, db as f32 column sums of dout * xhat, dout and dres;
// partial holds 3 * ceil(M / CS_ROWS) * D floats.
template <typename T>
cudaError_t layernorm_bwd(const void* pre, const void* dout, const void* gamma, void* dres, void* dres_c,
                          void* partial, void* dg, void* dbe, void* db, int M, int D, cudaStream_t stream) {
  const int chunks = (M + CS_ROWS - 1) / CS_ROWS;
  layernorm_bwd_kernel<T><<<chunks, LNB_THREADS, 0, stream>>>(
      static_cast<const float*>(pre), static_cast<const float*>(dout), static_cast<const float*>(gamma),
      static_cast<float*>(dres), static_cast<T*>(dres_c), static_cast<float*>(partial), M, D);
  RETURN_IF_ERROR(cudaGetLastError());
  return colsum_final(sums(dg, dbe, db), 3, partial, chunks, D, stream);
}

// ---- softmax backward of the PFN attention ----------------------------------

// The f32 body (bf16: attn_bwd_sm90 below), on pfn_flash_f32.cuh's register
// tiles. One block of 256 threads per (64 query rows, head h, item b):
// thread (tx, ty) owns rows ty + 16 r (r < 4) and keys tx + 16 j of each
// key tile. Per key tile that holds an allowed key (the recompute's tiles),
// S = scale Q K^T and dP = dO V^T run from shared memory into registers (4 x
// 4 each a thread); on the allowed keys the thread writes p = exp(s - lse)
// and dp into the p and ds rows and adds p dp to its share of delta. The
// row's 16 threads then sum delta, and each thread walks its columns of its
// rows below ldp once more: ds = p (dp - delta) from what it wrote itself,
// zeros wherever the PFN rule forbids the key and in the padding. So ds and
// p are written as (B*H*seq, ldp) rows, the products' operands, with no
// second pass over the products.
template <int DH>
struct SoftmaxBwdF32Smem {  // in floats: q, dO, K, V
  static constexpr int LDX = f32t::ld_tile(DH);
  static constexpr int do_off = RBQ * LDX, k_off = 2 * RBQ * LDX, v_off = k_off + ABK * LDX;
  static constexpr int bytes = (v_off + ABK * LDX) * 4;
};

template <int DH>
__global__ void __launch_bounds__(f32t::kThreads, 1)
    attn_bwd_f32(const float* __restrict__ qkv, const float* __restrict__ dout, const float* __restrict__ lse,
                 const int* __restrict__ sep_ptr, float* pc, float* ds, int seq, int ldp, int D, int H) {
  using L = SoftmaxBwdF32Smem<DH>;
  constexpr int RM = RM_ROWS;
  extern __shared__ __align__(16) float bsm[];
  float* qs = bsm;
  float* dos = bsm + L::do_off;
  float* ks = bsm + L::k_off;
  float* vs = bsm + L::v_off;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * RBQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);
  const int ld = 3 * D;
  const float* item = qkv + (size_t)b * seq * ld;
  const KeyTiles tiles(sep, q0, seq, RBQ);
  f32t::load_tile_async<DH, RBQ>(qs, item + h * DH, q0, seq, ld);
  f32t::load_tile_async<DH, RBQ>(dos, dout + (size_t)b * seq * D + h * DH, q0, seq, D);
  float ls[RM], delta[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + ty + 16 * r;
    ls[r] = row < seq ? lse[((size_t)b * seq + row) * H + h] : 0.0f;
    delta[r] = 0.0f;
  }
  const size_t row_base = ((size_t)b * H + h) * seq;  // row of (b, h, query 0) in pc and ds
  for (int i = 0; i < tiles.n; ++i) {
    const int key0 = tiles.key0(i);
    f32t::load_tile_async<DH, ABK>(ks, item + D + h * DH, key0, seq, ld);
    f32t::load_tile_async<DH, ABK>(vs, item + 2 * D + h * DH, key0, seq, ld);
    f32t::cp_async_commit();
    f32t::cp_async_wait<0>();
    __syncthreads();  // q, dO, K and V are in
    float sc[RM][4], dp[RM][4];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[r][j] = dp[r][j] = 0.0f;
    f32t::mma_nt<RM, 4, DH>(sc, qs + ty * L::LDX, 16 * L::LDX, ks + tx * L::LDX, 16 * L::LDX);
    f32t::mma_nt<RM, 4, DH>(dp, dos + ty * L::LDX, 16 * L::LDX, vs + tx * L::LDX, 16 * L::LDX);
    __syncthreads();  // every thread is done with K and V
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * r, key = key0 + tx + 16 * j;
        if (!pfn_allowed(row, key, sep, seq)) continue;
        const float p = expf(sc[r][j] * scale - ls[r]);
        delta[r] += p * dp[r][j];
        const size_t o = (row_base + row) * ldp + key;
        pc[o] = p;
        ds[o] = dp[r][j];
      }
  }
  f32t::cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const float dl = f32t::group_sum(delta[r]);
    const int row = q0 + ty + 16 * r;
    if (row >= seq) continue;
    for (int c = tx; c < ldp; c += 16) {
      const size_t o = (row_base + row) * ldp + c;
      if (pfn_allowed(row, c, sep, seq)) {
        ds[o] = pc[o] * (ds[o] - dl);
      } else {
        pc[o] = 0.0f;
        ds[o] = 0.0f;
      }
    }
  }
}

template <int DH>
cudaError_t attention_bwd_f32(const void* qkv, const void* dout, const void* lse, const void* sep, void* pc, void* ds,
                              int B, int seq, int ldp, int D, int H, cudaStream_t stream) {
  using L = SoftmaxBwdF32Smem<DH>;
  auto kernel = attn_bwd_f32<DH>;
  RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
  const dim3 grid((seq + RBQ - 1) / RBQ, H, B);
  kernel<<<grid, f32t::kThreads, L::bytes, stream>>>(static_cast<const float*>(qkv), static_cast<const float*>(dout),
                                                      static_cast<const float*>(lse), static_cast<const int*>(sep),
                                                      static_cast<float*>(pc), static_cast<float*>(ds), seq, ldp, D,
                                                      H);
  return cudaGetLastError();
}

// The same function in bf16 on wgmma, per (64 query rows, head h, item b),
// one warpgroup: TMA brings the rows' q and dO and then, per allowed key tile
// (the forward's tiles) of 64 keys, its K and V, through the 4-D maps of
// pfn_gemm_sm90.cuh (head dims below 64 padded to one 64-column panel by the
// maps' zero fill); S = scale Q K^T and dP = dO V^T run as wgmma from shared
// memory into register fragments. Pass 1 forms p = exp(s - lse) on the
// fragments, writes cdt(p) and sums delta = sum_j cdt(p_j) dp_j per row;
// pass 2 recomputes S and dP and writes ds = cdt(p (dp - delta)). Key tiles
// the rows never visit get zeros.
constexpr int SBQ = 64;  // query rows per block
constexpr int SBK = 64;  // keys per K/V tile

template <int DH>
struct SoftmaxBwdSmem {
  static constexpr int DP = DH < 64 ? 64 : DH;  // the head dim in whole 64-column panels
  static constexpr int tile_bytes = SBQ * DP * 2;
  static constexpr int bar_off = 4 * tile_bytes;  // q, dO, K, V tiles
  static constexpr int bytes = bar_off + 16 + 1024;  // + alignment slack
};

template <int DH>
__global__ void __launch_bounds__(128)
    attn_bwd_sm90(const __grid_constant__ CUtensorMap mqkv, const __grid_constant__ CUtensorMap mdo,
                  const float* __restrict__ lse, const int* __restrict__ sep_ptr, __nv_bfloat16* __restrict__ pc,
                  __nv_bfloat16* __restrict__ ds, int seq, int ldp, int H) {
  namespace sm90 = pfn_flash_sm90;
  using L = SoftmaxBwdSmem<DH>;
  constexpr int DP = L::DP;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_base(smem_raw);
  const uint32_t qs = base, dos = base + L::tile_bytes, ks = base + 2 * L::tile_bytes, vs = base + 3 * L::tile_bytes;
  const uint32_t bar_rows = base + L::bar_off, bar_kv = bar_rows + 8;
  const int q0 = blockIdx.x * SBQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);
  const sm90::Tiles<SBQ, SBK, true> tiles(sep, q0, seq);
  // Rows q0 .. q0 + 63 of head `head` of item b, every panel, onto `bar`.
  auto load = [&](uint32_t dst, const CUtensorMap* map, uint32_t bar, int head, int row0) {
#pragma unroll
    for (int p = 0; p < DP / 64; ++p) sm90::tma_load_4d(dst + p * SBQ * 128, map, bar, p * 64, head, row0, b);
  };
  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_rows, 1);
    sm90::mbar_init(bar_kv, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(bar_rows, 2 * L::tile_bytes);
    load(qs, &mqkv, bar_rows, h, q0);
    load(dos, &mdo, bar_rows, h, q0);
  }
  int rows[2];
  float ls[2], delta[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    rows[hh] = q0 + sm90::frag_row(2 * hh);
    ls[hh] = rows[hh] < seq ? lse[((size_t)b * seq + rows[hh]) * H + h] : 0.0f;
  }
  const size_t row_base = ((size_t)b * H + h) * seq;  // row of (b, h, query 0) in pc and ds
  sm90::mbar_wait(bar_rows, 0);
  int phase = 0;
  for (int pass = 0; pass < 2; ++pass) {
    __nv_bfloat16* out = pass == 0 ? pc : ds;
    for (int i = 0; i < tiles.n; ++i, phase ^= 1) {
      const int key0 = tiles.row0(i);
      if (threadIdx.x == 0) {
        sm90::mbar_expect_tx(bar_kv, 2 * L::tile_bytes);
        load(ks, &mqkv, bar_kv, H + h, key0);
        load(vs, &mqkv, bar_kv, 2 * H + h, key0);
      }
      sm90::mbar_wait(bar_kv, phase);
      float sc[SBK / 2], dp[SBK / 2];
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      sm90::wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        sm90::wgmma_ss<SBK>(sc, sm90::desc_k_major<DP, SBQ>(qs, 0, kd), sm90::desc_k_major<DP, SBK>(ks, 0, kd), kd > 0);
#pragma unroll
      for (int kd = 0; kd < DH / 16; ++kd)
        sm90::wgmma_ss<SBK>(dp, sm90::desc_k_major<DP, SBQ>(dos, 0, kd), sm90::desc_k_major<DP, SBK>(vs, 0, kd),
                            kd > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);
      __syncthreads();  // K and V are read: the next tile's loads may land
#pragma unroll
      for (int e = 0; e < SBK / 2; e += 2) {
        const int hh = (e >> 1) & 1, row = rows[hh], col = key0 + sm90::frag_col(e);
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int key = col + u;
          const float p = row < seq && key < seq && (key < sep || key == row) ? expf(sc[e + u] * scale - ls[hh]) : 0.0f;
          if (pass == 0) {
            delta[hh] += to_float(from_float<__nv_bfloat16>(p)) * dp[e + u];
            v[u] = p;
          } else {
            v[u] = p * (dp[e + u] - delta[hh]);
          }
        }
        if (row < seq && col < ldp)
          *reinterpret_cast<__nv_bfloat162*>(out + (row_base + row) * ldp + col) = __floats2bfloat162_rn(v[0], v[1]);
      }
    }
    if (pass == 0) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) delta[hh] = sm90::quad_sum(delta[hh]);
    }
  }
  // Zeros in the key tiles these rows never visit: the products read every key.
  const int n_keys = (seq + SBK - 1) / SBK, diag_last = tiles.diag_first + tiles.n - tiles.n_prefix;
  for (int kt = tiles.n_prefix; kt < n_keys; ++kt) {
    if (kt >= tiles.diag_first && kt < diag_last) continue;
    for (int idx = threadIdx.x; idx < SBQ * SBK / 2; idx += 128) {
      const int row = q0 + idx / (SBK / 2), col = kt * SBK + 2 * (idx % (SBK / 2));
      if (row >= seq || col >= ldp) continue;
      const size_t o = (row_base + row) * ldp + col;
      *reinterpret_cast<__nv_bfloat162*>(pc + o) = __floats2bfloat162_rn(0.0f, 0.0f);
      *reinterpret_cast<__nv_bfloat162*>(ds + o) = __floats2bfloat162_rn(0.0f, 0.0f);
    }
  }
}

template <int DH>
cudaError_t attention_bwd_sm90(const void* qkv, const void* dout, const void* lse, const void* sep, void* pc,
                               void* ds, int B, int seq, int ldp, int D, int H, cudaStream_t stream) {
  using L = SoftmaxBwdSmem<DH>;
  const long long n = seq;
  CUtensorMap mqkv, mdo;
  RETURN_IF_ERROR(g90::make_map(&mqkv, g90::Tensor4{qkv, DH, 3 * H, n, B, DH, 3 * D, n * 3 * D}, SBQ));
  RETURN_IF_ERROR(g90::make_map(&mdo, g90::Tensor4{dout, DH, H, n, B, DH, D, n * D}, SBQ));
  auto kernel = attn_bwd_sm90<DH>;
  static bool allowed[g90::kMaxDevices] = {};  // the limit, once per device
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (device >= g90::kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
    allowed[device] = true;
  }
  const dim3 grid((seq + SBQ - 1) / SBQ, H, B);
  kernel<<<grid, 128, L::bytes, stream>>>(mqkv, mdo, static_cast<const float*>(lse), static_cast<const int*>(sep),
                                          static_cast<__nv_bfloat16*>(pc), static_cast<__nv_bfloat16*>(ds), seq, ldp,
                                          H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_bwd(const void* qkv, const void* dout, const void* lse, const void* sep, void* pc, void* ds,
                          int B, int seq, int ldp, int D, int H, cudaStream_t s) {
  if constexpr (is_bf16_v<T>) {
    switch (D / H) {
      case 16:
        return attention_bwd_sm90<16>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      case 32:
        return attention_bwd_sm90<32>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      case 64:
        return attention_bwd_sm90<64>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      case 128:
        return attention_bwd_sm90<128>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    switch (D / H) {
      case 16:
        return attention_bwd_f32<16>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      case 32:
        return attention_bwd_f32<32>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      case 64:
        return attention_bwd_f32<64>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      case 128:
        return attention_bwd_f32<128>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

// The three products in bf16 on the wgmma GEMM, BN = 64 for head dims up to
// 64 and 128 above: ds and p as (B*H, 1, seq, seq) arrays with row stride
// ldp, read K-major (dq) or MN-major (as ds^T and p^T); the columns of one
// head of qkv (B, 3H, seq, DH) and of dO (B, H, seq, DH) as the MN-major B.
// They write cdt(dqkv) and, for the bias gradient, the column sums of the
// f32 dqkv over each (item, 128-row tile) into colsum (B * ceil(seq / 128)
// rows of 3D); the f32 dqkv itself is not stored.
template <int BN>
cudaError_t attention_grads_sm90(const void* qkv, const void* dout, const void* pc, const void* ds, void* dqkvc,
                                 void* colsum, int B, int seq, int ldp, int D, int H, cudaStream_t s) {
  const int DH = D / H;
  const long long n = seq, BH = (long long)B * H;
  const g90::Tensor4 dst{ds, n, 1, n, BH, ldp, ldp, n * ldp};
  const g90::Tensor4 pct{pc, n, 1, n, BH, ldp, ldp, n * ldp};
  const g90::Tensor4 qkvh{qkv, DH, 3 * H, n, B, DH, 3 * D, n * 3 * D};
  const g90::Tensor4 douth{dout, DH, H, n, B, DH, D, n * D};
  __nv_bfloat16* dqc = static_cast<__nv_bfloat16*>(dqkvc);
  float* sums = static_cast<float*>(colsum);
  auto at = [&](int col, float scale) {  // column block col of cdt(dqkv) and of its sums
    return g90::Epi{nullptr, nullptr, nullptr, dqc + col, sums + col, 3 * D, n * 3 * D, DH, scale};
  };
  const float scale = 1.0f / sqrtf((float)DH);
  // B of dq: K of head h, which is head H + h of qkv's columns.
  RETURN_IF_ERROR((g90::gemm<EPI_SCALE, BN, false, true>(dst, qkvh, g90::Shape{seq, DH, seq, B * H, H, H, 0},
                                                               at(0, scale), s)));
  RETURN_IF_ERROR((g90::gemm<EPI_SCALE, BN, true, true>(dst, qkvh, g90::Shape{seq, DH, seq, B * H, H, 0, 0},
                                                              at(D, scale), s)));
  return g90::gemm<EPI_SCALE, BN, true, true>(pct, douth, g90::Shape{seq, DH, seq, B * H, H, 0, 0},
                                                    at(2 * D, 1.0f), s);
}

// dq = ds K scale, dk = ds^T Q scale, dv = cdt(p)^T dO for every (item,
// head): three batched GEMMs over z = b * H + h into the columns of (B*seq,
// 3D): in f32 the dqkv itself and the column sums of each (item, 128-row
// tile), in bf16 as attention_grads_sm90 writes them.
template <typename T>
cudaError_t attention_grads(const void* qkv, const void* dout, const void* pc, const void* ds, void* dqkv,
                            void* dqkvc, void* colsum, int B, int seq, int ldp, int D, int H, cudaStream_t s) {
  if constexpr (is_bf16_v<T>) {
    return D / H <= 64 ? attention_grads_sm90<64>(qkv, dout, pc, ds, dqkvc, colsum, B, seq, ldp, D, H, s)
                       : attention_grads_sm90<128>(qkv, dout, pc, ds, dqkvc, colsum, B, seq, ldp, D, H, s);
  } else {
    const int DH = D / H;
    const long long n = seq;
    GemmArgs a{};
    a.M = seq;
    a.N = DH;
    a.K = seq;
    a.lda = ldp;
    a.ldw = 3 * D;
    a.ldo = 3 * D;
    a.zdiv = H;
    a.a_hi = H * n * ldp;
    a.a_lo = n * ldp;
    a.w_hi = n * 3 * D;
    a.w_lo = DH;
    a.o_hi = n * 3 * D;
    a.o_lo = DH;
    a.scale = 1.0f / sqrtf((float)DH);
    const float* q = static_cast<const float*>(qkv);
    float* dq = static_cast<float*>(dqkv);
    auto at = [&](int col) {  // column block col of dqkv and of its sums
      a.out = dq + col;
      a.colsum = static_cast<float*>(colsum) + col;
    };
    a.A = ds;
    a.W = q + D;
    at(0);
    RETURN_IF_ERROR((gemm<EPI_SCALE, false>(a, B * H, s)));
    a.W = q;
    at(D);
    RETURN_IF_ERROR((gemm<EPI_SCALE, true>(a, B * H, s)));
    a.A = pc;
    a.W = dout;
    a.ldw = D;
    a.w_hi = n * D;
    a.scale = 1.0f;
    at(2 * D);
    return gemm<EPI_SCALE, true>(a, B * H, s);
  }
}

// ---- a second stream for the f32 weight gradients ----------------------------

// In f32 each chain runs its weight gradients on a stream of its own, beside
// the products that do not need them (dW2 beside dh1, dW1 beside dr, dWout
// beside dO and the attention's gradients, dWqkv beside dx), so that their
// blocks fill the SMs that the other product's last wave of tiles leaves
// idle. One stream and two events per host thread and device, made at first
// use; the side stream waits for the caller's stream at each fork, and the
// caller's stream waits for it before the chain returns, so that everything
// after the chain on the caller's stream sees its outputs (and the caching
// allocator may reuse its scratch).
struct SideStream {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};

inline cudaError_t side_stream(SideStream** out) {
  static thread_local SideStream per_device[g90::kMaxDevices];
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (device >= g90::kMaxDevices) return cudaErrorInvalidDevice;
  SideStream& side = per_device[device];
  if (side.stream == nullptr) {
    RETURN_IF_ERROR(cudaStreamCreateWithFlags(&side.stream, cudaStreamNonBlocking));
    RETURN_IF_ERROR(cudaEventCreateWithFlags(&side.fork, cudaEventDisableTiming));
    RETURN_IF_ERROR(cudaEventCreateWithFlags(&side.join, cudaEventDisableTiming));
  }
  *out = &side;
  return cudaSuccess;
}

// `to` waits for the work enqueued on `from` so far.
inline cudaError_t wait_for(cudaStream_t to, cudaStream_t from, cudaEvent_t ev) {
  RETURN_IF_ERROR(cudaEventRecord(ev, from));
  return cudaStreamWaitEvent(to, ev, 0);
}

// The stream of a chain's weight gradients: the caller's in bf16, the side
// stream (after the caller's work so far) in f32.
template <typename T>
cudaError_t fork(cudaStream_t s, SideStream** side, cudaStream_t* ws) {
  *ws = s;
  if constexpr (!is_bf16_v<T>) {
    RETURN_IF_ERROR(side_stream(side));
    *ws = (*side)->stream;
    return wait_for(*ws, s, (*side)->fork);
  }
  return cudaSuccess;
}

// The caller's stream waits for the weight gradients (f32).
template <typename T>
cudaError_t join(cudaStream_t s, const SideStream* side) {
  if constexpr (!is_bf16_v<T>) return wait_for(s, side->stream, side->join);
  return cudaSuccess;
}

// ---- the two chains ----------------------------------------------------------

template <typename T>
cudaError_t ffn_bwd(const void* r, const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                    const void* dy, void* dr, void* dw1, void* db1, void* dw2, void* db2, void* dg2, void* dbe2,
                    void* rc, void* h1, void* g, void* r2, void* dr2, void* dr2c, void* dh1, void* dh1c,
                    void* partial, void* wpartial, int M, int D, int F, int splits_w2, int splits_w1,
                    cudaStream_t s) {
  if constexpr (is_bf16_v<T>) {
    RETURN_IF_ERROR(cast_bf16(r, rc, (size_t)M * D, s));
  } else {
    rc = const_cast<void*>(r);
    dr2c = dr2;
  }
  RETURN_IF_ERROR((product<T, EPI_F32_GELU>(rc, w1, b1, nullptr, h1, g, M, F, D, s)));
  RETURN_IF_ERROR((product<T, EPI_RESID>(g, w2, b2, r, r2, nullptr, M, D, F, s)));
  RETURN_IF_ERROR((layernorm_bwd<T>(r2, dy, g2, dr2, is_bf16_v<T> ? dr2c : nullptr, partial, dg2, dbe2, db2, M, D,
                                    s)));
  SideStream* side = nullptr;
  cudaStream_t ws;  // the weight gradients' stream
  RETURN_IF_ERROR(fork<T>(s, &side, &ws));
  RETURN_IF_ERROR((weight_grad<T>(g, dr2c, dw2, M, F, D, splits_w2, wpartial, ws)));
  // bf16 stores cdt(dh1) only, f32 dh1 itself; db1 from the product's column sums.
  constexpr bool bf16 = is_bf16_v<T>;
  RETURN_IF_ERROR((product<T, EPI_GELU_GRAD, true>(dr2c, w2, nullptr, h1, bf16 ? nullptr : dh1, bf16 ? dh1c : nullptr,
                                                   M, F, D, s, partial)));
  RETURN_IF_ERROR(colsum_final(sums(db1), 1, partial, (M + GEMM_ROWS - 1) / GEMM_ROWS, F, s));
  if constexpr (!bf16) {
    dh1c = dh1;
    RETURN_IF_ERROR(wait_for(ws, s, side->fork));  // dW1 needs dh1
  }
  RETURN_IF_ERROR((weight_grad<T>(rc, dh1c, dw1, M, D, F, splits_w1, wpartial, ws)));
  RETURN_IF_ERROR((product<T, EPI_RESID, true>(dh1c, w1, nullptr, dr2, dr, nullptr, M, D, F, s)));
  return join<T>(s, side);
}

template <typename T>
cudaError_t attn_bwd(const void* x, const void* wqkv, const void* bqkv, const void* wout, const void* bout,
                     const void* g1, const void* lse, const void* dr, const void* sep, void* dx, void* dwqkv,
                     void* dbqkv, void* dwout, void* dbout, void* dg1, void* dbe1, void* xc, void* qkv, void* attn,
                     void* r1, void* dr1, void* dr1c, void* dout, void* pc, void* ds, void* dqkv, void* dqkvc,
                     void* partial, void* wpartial, int B, int seq, int D, int H, int splits_wout, int splits_wqkv,
                     cudaStream_t s) {
  const int M = B * seq, ldp = (seq + 15) / 16 * 16;
  if constexpr (is_bf16_v<T>) {
    RETURN_IF_ERROR(cast_bf16(x, xc, (size_t)M * D, s));
  } else {
    xc = const_cast<void*>(x);
    dr1c = dr1;
  }
  RETURN_IF_ERROR((product<T, EPI_ROUND>(xc, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * D, D, s)));
  RETURN_IF_ERROR((attention<T, true>(qkv, attn, const_cast<void*>(lse), sep, B, seq, D, H, s)));
  RETURN_IF_ERROR((product<T, EPI_ROUND_RESID>(attn, wout, bout, x, r1, nullptr, M, D, D, s)));
  RETURN_IF_ERROR((layernorm_bwd<T>(r1, dr, g1, dr1, is_bf16_v<T> ? dr1c : nullptr, partial, dg1, dbe1, dbout, M, D,
                                    s)));
  SideStream* side = nullptr;
  cudaStream_t ws;  // the weight gradients' stream
  RETURN_IF_ERROR(fork<T>(s, &side, &ws));
  RETURN_IF_ERROR((weight_grad<T>(attn, dr1c, dwout, M, D, D, splits_wout, wpartial, ws)));
  RETURN_IF_ERROR((product<T, EPI_ROUND, true>(dr1c, wout, nullptr, nullptr, dout, nullptr, M, D, D, s)));
  RETURN_IF_ERROR((attention_bwd<T>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s)));
  RETURN_IF_ERROR((attention_grads<T>(qkv, dout, pc, ds, dqkv, dqkvc, partial, B, seq, ldp, D, H, s)));
  // dbqkv from the products' column sums, one row per (item, 128-row tile).
  RETURN_IF_ERROR(colsum_final(sums(dbqkv), 1, partial, B * ((seq + GEMM_ROWS - 1) / GEMM_ROWS), 3 * D, s));
  if constexpr (!is_bf16_v<T>) {
    dqkvc = dqkv;
    RETURN_IF_ERROR(wait_for(ws, s, side->fork));  // dWqkv needs dqkv
  }
  RETURN_IF_ERROR((weight_grad<T>(xc, dqkvc, dwqkv, M, D, 3 * D, splits_wqkv, wpartial, ws)));
  RETURN_IF_ERROR((product<T, EPI_RESID, true>(dqkvc, wqkv, nullptr, dr1, dx, nullptr, M, D, 3 * D, s)));
  return join<T>(s, side);
}

}  // namespace

// C entry points, bound with ctypes. Each enqueues its chain on `stream` and
// returns the first cudaError_t (0 on success); neither synchronises. The
// caller checks shapes (D, F multiples of 16, D / H in {16, 32, 64, 128},
// T <= 512), allocates every output and scratch buffer, and picks each
// weight gradient's split count (wpartial holds splits x its size).
extern "C" int pfn_fused_layer_bwd_ffn(const void* r, const void* w1, const void* b1, const void* w2,
                                       const void* b2, const void* g2, const void* dy, void* dr, void* dw1,
                                       void* db1, void* dw2, void* db2, void* dg2, void* dbe2, void* rc, void* h1,
                                       void* g, void* r2, void* dr2, void* dr2c, void* dh1, void* dh1c, void* partial,
                                       void* wpartial, int B, int T, int D, int F, int splits_w2, int splits_w1,
                                       int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const cudaError_t err =
      is_bf16 ? ffn_bwd<__nv_bfloat16>(r, w1, b1, w2, b2, g2, dy, dr, dw1, db1, dw2, db2, dg2, dbe2, rc, h1, g, r2,
                                       dr2, dr2c, dh1, dh1c, partial, wpartial, M, D, F, splits_w2, splits_w1, s)
              : ffn_bwd<float>(r, w1, b1, w2, b2, g2, dy, dr, dw1, db1, dw2, db2, dg2, dbe2, rc, h1, g, r2, dr2, dr2c,
                               dh1, dh1c, partial, wpartial, M, D, F, splits_w2, splits_w1, s);
  return static_cast<int>(err);
}

extern "C" int pfn_fused_layer_bwd_attn(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                        const void* bout, const void* g1, const void* lse, const void* dr,
                                        const void* sep, void* dx, void* dwqkv, void* dbqkv, void* dwout,
                                        void* dbout, void* dg1, void* dbe1, void* xc, void* qkv, void* attn, void* r1,
                                        void* dr1, void* dr1c, void* dout, void* pc, void* ds, void* dqkv,
                                        void* dqkvc, void* partial, void* wpartial, int B, int T, int D, int H,
                                        int splits_wout, int splits_wqkv, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? attn_bwd<__nv_bfloat16>(x, wqkv, bqkv, wout, bout, g1, lse, dr, sep, dx, dwqkv, dbqkv, dwout, dbout,
                                        dg1, dbe1, xc, qkv, attn, r1, dr1, dr1c, dout, pc, ds, dqkv, dqkvc, partial,
                                        wpartial, B, T, D, H, splits_wout, splits_wqkv, s)
              : attn_bwd<float>(x, wqkv, bqkv, wout, bout, g1, lse, dr, sep, dx, dwqkv, dbqkv, dwout, dbout, dg1,
                                dbe1, xc, qkv, attn, r1, dr1, dr1c, dout, pc, ds, dqkv, dqkvc, partial, wpartial, B,
                                T, D, H, splits_wout, splits_wqkv, s);
  return static_cast<int>(err);
}
