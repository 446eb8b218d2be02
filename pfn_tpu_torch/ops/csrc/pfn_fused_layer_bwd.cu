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
// call. The weights' transposes (W1^T, W2^T, Wqkv^T, Wout^T) are copies the
// caller makes once per call.
//
// Layout: x, r, dy, dr (B, T, D) f32; the matrices in the JAX layout in the
// compute dtype (f32 or bf16), biases and LayerNorm parameters f32; lse
// (B, T, H) f32 from the forward. The weight and bias gradients are f32 sums
// over the batch; dx and dr are f32. `sep` is read from an int32 in device
// memory. The caller passes every scratch buffer (pfn_tpu_torch/ops/_ext.py
// names their shapes); the compute-dtype copies of f32 tensors (cdt(r),
// cdt(x), cdt(dr2), cdt(dh1), cdt(dr1), cdt(dqkv)) exist only in bf16 and
// are null in f32, where the f32 tensor serves.
//
// Numerics follow the TPU kernels: the same roundings to the compute dtype
// as the forward (pfn_fused_layer_fwd.cu), then dr2, dh1, dr1, the head
// output gradient dO, ds and dqkv rounded before they enter a product; every
// product accumulates in f32; LayerNorm statistics and gradients in f32.
//
// Design. The TPU kernels walk the batch on a sequential grid and add each
// item's weight gradients into one VMEM block. Here the whole batch is one
// set of GEMMs, so a weight gradient is one product over K = B*T rows
// (A read transposed from its row-major activations), cut into `splits`
// chunks of K (one per 512 rows, at most 8; the caller picks the count)
// whose partial products are summed in order, and nothing is accumulated
// across blocks: no atomics, and the column sums are two passes in a fixed
// order (partial sums of 64 rows, then their sum). Two calls give
// bitwise-equal gradients. Each entry point enqueues a chain of kernels on
// the caller's stream and counts one launch (the counts below are for
// splits = 1; each weight gradient adds its ordered sum when splits > 1):
//   FFN (twelve in bf16, eleven in f32):
//     0. cast rc = cdt(r) (bf16 only)
//     1. gemm h1 = rc W1 + b1 (f32) and g = cdt(gelu(h1))
//     2. gemm r2 = r + g W2 + b2
//     3. ln'  dr2 = LN2'(r2, dy), cdt(dr2), dy * xhat2
//     4. sums dgamma2, dbeta2, db2 (two kernels)
//     5. gemm dW2 = g^T cdt(dr2)
//     6. gemm dh1 = (cdt(dr2) W2^T) gelu'(h1), cdt(dh1)
//     7. sums db1 (two kernels)
//     8. gemm dW1 = rc^T cdt(dh1)
//     9. gemm dr = dr2 + cdt(dh1) W1^T
//   attention (seventeen in bf16, sixteen in f32):
//     0. cast xc = cdt(x) (bf16 only)
//     1. gemm qkv = cdt(xc Wqkv + bqkv)
//     2. attn attn = cdt(cdt(p) V), p = exp(s - lse), per (32 rows, head, item)
//     3. gemm r1 = x + cdt(attn Wout + bout)
//     4. ln'  dr1 = LN1'(r1, dr), cdt(dr1), dr * xhat1
//     5. sums dgamma1, dbeta1, dbout (two kernels)
//     6. gemm dWout = attn^T cdt(dr1)
//     7. gemm dO = cdt(cdt(dr1) Wout^T)
//     8. attn' per (32 rows, head, item): S and dP = dO V^T over the allowed
//        key tiles into two (32, T) f32 row buffers, then per row delta, and
//        cdt(p) and ds written out as (B, H, T, T16) rows (T16 = T rounded
//        up to 16, zeros where the PFN rule forbids the key)
//     9. gemm dq = ds K scale, over the B*H (item, head) pairs in one launch
//    10. gemm dk = ds^T Q scale, the same
//    11. gemm dv = cdt(p)^T dO, the same
//    12. sums dbqkv (two kernels)
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
// is compute bound, and nearly all of it is GEMMs. This first design is far
// from that bound: the forward's WMMA GEMM (mma.sync from padded shared
// memory, no wgmma or TMA), the weight gradients' split-K partials written
// and summed in a second pass, intermediates through L2, and separate
// LayerNorm, sum and softmax passes. The bound counts the recompute of the
// forward's products, as the TPU kernels do it. Later work: wgmma with
// TMA-fed rings, saving qkv and h1 in the forward instead of recomputing
// them (memory for time), and the softmax backward fused into the dq
// product.

#include "pfn_fused_common.cuh"

namespace {

// ---- LayerNorm backward, f32 -----------------------------------------------

// For each row of the LayerNorm input `pre` and its output's gradient
// `dout`: xhat = LN(pre) without the affine part, dres = the gradient of
// `pre` (`_ln_bwd(dout * gamma, xhat, rstd)`), dgp = dout * xhat (the
// gamma gradient's summand), and dres_c = cdt(dres) when not null. One warp
// per row.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
    layernorm_bwd_kernel(const float* __restrict__ pre, const float* __restrict__ dout,
                         const float* __restrict__ gamma, float* __restrict__ dgp, float* __restrict__ dres,
                         T* __restrict__ dres_c, int M, int D) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= M) return;
  const float* x = pre + (size_t)row * D;
  const float* d = dout + (size_t)row * D;
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
  for (int c = lane; c < D; c += 32) {
    const float xhat = (x[c] - mu) * rstd;
    const float v = rstd * (d[c] * gamma[c] - m1 - xhat * m2);
    const size_t o = (size_t)row * D + c;
    dres[o] = v;
    if (dres_c) dres_c[o] = from_float<T>(v);
    dgp[o] = d[c] * xhat;
  }
}

template <typename T>
cudaError_t layernorm_bwd(const void* pre, const void* dout, const void* gamma, void* dgp, void* dres, void* dres_c,
                          int M, int D, cudaStream_t stream) {
  layernorm_bwd_kernel<T><<<(M + LN_ROWS - 1) / LN_ROWS, NTHREADS, 0, stream>>>(
      static_cast<const float*>(pre), static_cast<const float*>(dout), static_cast<const float*>(gamma),
      static_cast<float*>(dgp), static_cast<float*>(dres), static_cast<T*>(dres_c), M, D);
  return cudaGetLastError();
}

// ---- column sums in a fixed order --------------------------------------------

constexpr int CS_ROWS = 64;  // rows per partial sum (COLSUM_ROWS in _ext.py)

struct ColSumArgs {
  const float* in[3];
  float* out[3];
};

// partial[a][chunk][n] = sum of in[a][m][n] over the chunk's CS_ROWS rows, in
// row order. Grid (ceil(N/128), chunks, arrays).
__global__ void __launch_bounds__(NTHREADS)
    colsum_partial_kernel(const ColSumArgs args, float* __restrict__ partial, int M, int N) {
  const int n = blockIdx.x * NTHREADS + threadIdx.x, chunk = blockIdx.y, a = blockIdx.z;
  if (n >= N) return;
  const float* in = args.in[a];
  const int r1 = min(M, (chunk + 1) * CS_ROWS);
  float s = 0.0f;
  for (int m = chunk * CS_ROWS; m < r1; ++m) s += in[(size_t)m * N + n];
  partial[((size_t)a * gridDim.y + chunk) * N + n] = s;
}

// out[a][n] = sum of the partial sums in chunk order. Grid (ceil(N/128), arrays).
__global__ void __launch_bounds__(NTHREADS)
    colsum_final_kernel(const ColSumArgs args, const float* __restrict__ partial, int chunks, int N) {
  const int n = blockIdx.x * NTHREADS + threadIdx.x, a = blockIdx.y;
  if (n >= N) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s += partial[((size_t)a * chunks + c) * N + n];
  args.out[a][n] = s;
}

// The column sums of `count` (M, N) f32 arrays; partial holds count *
// ceil(M / CS_ROWS) * N floats.
inline cudaError_t colsum(const ColSumArgs& args, int count, void* partial, int M, int N, cudaStream_t s) {
  const int chunks = (M + CS_ROWS - 1) / CS_ROWS;
  const int col_blocks = (N + NTHREADS - 1) / NTHREADS;
  colsum_partial_kernel<<<dim3(col_blocks, chunks, count), NTHREADS, 0, s>>>(args, static_cast<float*>(partial), M,
                                                                              N);
  RETURN_IF_ERROR(cudaGetLastError());
  colsum_final_kernel<<<dim3(col_blocks, count), NTHREADS, 0, s>>>(args, static_cast<const float*>(partial), chunks,
                                                                    N);
  return cudaGetLastError();
}

inline ColSumArgs sums(const void* a0, void* o0, const void* a1 = nullptr, void* o1 = nullptr,
                       const void* a2 = nullptr, void* o2 = nullptr) {
  return ColSumArgs{{static_cast<const float*>(a0), static_cast<const float*>(a1), static_cast<const float*>(a2)},
                    {static_cast<float*>(o0), static_cast<float*>(o1), static_cast<float*>(o2)}};
}

// ---- softmax backward of the PFN attention ----------------------------------

template <typename T, int DH>
struct AttnBwdLayout {
  int LDS, q_off, kv_off, s_off, dp_off, bytes;
  __host__ __device__ explicit AttnBwdLayout(int seq) {
    constexpr int LDH = AttnLayout<T, DH>::LDH;
    LDS = (seq + ABK - 1) / ABK * ABK + 4;  // f32 rows of S (then p) and dP
    q_off = 0;
    kv_off = q_off + round128(ABQ * LDH * (int)sizeof(T));
    s_off = kv_off + round128(ABK * LDH * (int)sizeof(T));
    dp_off = s_off + round128(ABQ * LDS * 4);
    bytes = dp_off + round128(ABQ * LDS * 4);
  }
};

// One block per (32 query rows, head h, item b): S = scale Q K^T and
// dP = dO V^T over the key tiles that hold an allowed key (the forward's
// tiles), then for each row p = exp(s - lse) on the allowed keys,
// delta = sum_j cdt(p_j) dp_j, and writes pc = cdt(p) and
// ds = cdt(p (dp - delta)) as row (b, h, query) of (B*H*seq, ldp), zeros
// at the keys the rule forbids and in the padding.
template <typename T, int DH>
__global__ void __launch_bounds__(NTHREADS)
    attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, const float* __restrict__ lse,
                    const int* __restrict__ sep_ptr, T* __restrict__ pc, T* __restrict__ ds, int seq, int ldp, int D,
                    int H) {
  constexpr int LDH = AttnLayout<T, DH>::LDH;
  const AttnBwdLayout<T, DH> L(seq);
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L.q_off);
  T* kvs = reinterpret_cast<T*>(smem + L.kv_off);
  float* ss = reinterpret_cast<float*>(smem + L.s_off);
  float* dps = reinterpret_cast<float*>(smem + L.dp_off);

  const int q0 = blockIdx.x * ABQ, h = blockIdx.y, b = blockIdx.z;
  const int sep = min(max(*sep_ptr, 0), seq);
  const float scale = 1.0f / sqrtf((float)DH);
  const size_t ld = 3 * (size_t)D;
  const T* item = qkv + (size_t)b * seq * ld;
  const KeyTiles tiles(sep, q0, seq);

  load_tile<T, ABQ, DH, LDH>(qs, item + h * DH, ld, q0, seq, 0, DH);
  block_scores<T, DH>(qs, kvs, ss, L.LDS, item, ld, D + h * DH, seq, tiles, scale);
  // The rows of dO take the q rows' place (block_scores ends on a barrier).
  load_tile<T, ABQ, DH, LDH>(qs, dout + (size_t)b * seq * D + h * DH, D, q0, seq, 0, DH);
  block_scores<T, DH>(qs, kvs, dps, L.LDS, item, ld, 2 * D + h * DH, seq, tiles, 1.0f);

  // Warp w owns rows w*8 .. w*8+7. Only allowed entries of S and dP are read.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < ABQ / (NTHREADS / 32); ++rr) {
    const int r = warp * (ABQ / (NTHREADS / 32)) + rr;
    const int query = q0 + r;
    if (query >= seq) continue;
    float* srow = ss + r * L.LDS;
    const float* dprow = dps + r * L.LDS;
    const float ls = lse[((size_t)b * seq + query) * H + h];
    float delta = 0.0f;
    for (int c = lane; c < seq; c += 32) {
      const bool allowed = c < sep || c == query;
      const float p = allowed ? expf(srow[c] - ls) : 0.0f;
      srow[c] = p;
      if (allowed) delta += to_float(from_float<T>(p)) * dprow[c];
    }
    delta = warp_sum(delta);
    const size_t base = (((size_t)b * H + h) * seq + query) * ldp;
    for (int c = lane; c < ldp; c += 32) {
      const bool allowed = c < seq && (c < sep || c == query);
      pc[base + c] = from_float<T>(allowed ? srow[c] : 0.0f);
      ds[base + c] = from_float<T>(allowed ? srow[c] * (dprow[c] - delta) : 0.0f);
    }
  }
}

template <typename T, int DH>
cudaError_t attention_bwd_dh(const void* qkv, const void* dout, const void* lse, const void* sep, void* pc, void* ds,
                             int B, int seq, int ldp, int D, int H, cudaStream_t stream) {
  const AttnBwdLayout<T, DH> L(seq);
  auto kernel = attn_bwd_kernel<T, DH>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((seq + ABQ - 1) / ABQ, H, B);
  kernel<<<grid, NTHREADS, L.bytes, stream>>>(static_cast<const T*>(qkv), static_cast<const T*>(dout),
                                               static_cast<const float*>(lse), static_cast<const int*>(sep),
                                               static_cast<T*>(pc), static_cast<T*>(ds), seq, ldp, D, H);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention_bwd(const void* qkv, const void* dout, const void* lse, const void* sep, void* pc, void* ds,
                          int B, int seq, int ldp, int D, int H, cudaStream_t s) {
  switch (D / H) {
    case 16:
      return attention_bwd_dh<T, 16>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
    case 32:
      return attention_bwd_dh<T, 32>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
    case 64:
      return attention_bwd_dh<T, 64>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
    case 128:
      return attention_bwd_dh<T, 128>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dq = ds K scale, dk = ds^T Q scale, dv = cdt(p)^T dO for every (item,
// head): three batched GEMMs over z = b * H + h, writing the f32 dqkv
// (B*seq, 3D) and, in bf16, its rounded copy at the same places.
template <typename T>
cudaError_t attention_grads(const void* qkv, const void* dout, const void* pc, const void* ds, void* dqkv,
                            void* dqkvc, int B, int seq, int ldp, int D, int H, cudaStream_t s) {
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
  const T* q = static_cast<const T*>(qkv);
  float* dq = static_cast<float*>(dqkv);
  T* dqc = static_cast<T*>(dqkvc);
  auto at = [&](int col) {  // column block col of dqkv and its rounded copy
    a.out = dq + col;
    a.out2 = dqc ? dqc + col : nullptr;
  };
  a.A = ds;
  a.W = q + D;
  at(0);
  RETURN_IF_ERROR((gemm<T, EPI_SCALE, false>(a, B * H, s)));
  a.W = q;
  at(D);
  RETURN_IF_ERROR((gemm<T, EPI_SCALE, true>(a, B * H, s)));
  a.A = pc;
  a.W = dout;
  a.ldw = D;
  a.w_hi = n * D;
  a.scale = 1.0f;
  at(2 * D);
  return gemm<T, EPI_SCALE, true>(a, B * H, s);
}

// ---- the two chains ----------------------------------------------------------

template <typename T>
cudaError_t ffn_bwd(const void* r, const void* w1, const void* b1, const void* w2, const void* b2, const void* g2,
                    const void* dy, const void* w1t, const void* w2t, void* dr, void* dw1, void* db1, void* dw2,
                    void* db2, void* dg2, void* dbe2, void* rc, void* h1, void* g, void* r2, void* dgp, void* dr2,
                    void* dr2c, void* dh1, void* dh1c, void* partial, void* wpartial, int M, int D, int F,
                    int splits, cudaStream_t s) {
  if constexpr (is_bf16_v<T>) {
    RETURN_IF_ERROR(cast_bf16(r, rc, (size_t)M * D, s));
  } else {
    rc = const_cast<void*>(r);
    dr2c = dr2;
  }
  GemmArgs a = dense_args(rc, w1, b1, nullptr, h1, M, F, D);
  a.out2 = g;
  RETURN_IF_ERROR((gemm<T, EPI_F32_GELU, false>(a, 1, s)));
  RETURN_IF_ERROR((gemm<T, EPI_RESID>(g, w2, b2, r, r2, M, D, F, s)));
  RETURN_IF_ERROR((layernorm_bwd<T>(r2, dy, g2, dgp, dr2, is_bf16_v<T> ? dr2c : nullptr, M, D, s)));
  RETURN_IF_ERROR(colsum(sums(dgp, dg2, dy, dbe2, dr2, db2), 3, partial, M, D, s));
  RETURN_IF_ERROR((gemm_weight_grad<T>(g, dr2c, dw2, M, F, D, splits, wpartial, s)));
  a = dense_args(dr2c, w2t, nullptr, h1, dh1, M, F, D);
  a.out2 = is_bf16_v<T> ? dh1c : nullptr;
  RETURN_IF_ERROR((gemm<T, EPI_GELU_GRAD, false>(a, 1, s)));
  if constexpr (!is_bf16_v<T>) dh1c = dh1;
  RETURN_IF_ERROR(colsum(sums(dh1, db1), 1, partial, M, F, s));
  RETURN_IF_ERROR((gemm_weight_grad<T>(rc, dh1c, dw1, M, D, F, splits, wpartial, s)));
  return gemm<T, EPI_RESID>(dh1c, w1t, nullptr, dr2, dr, M, D, F, s);
}

template <typename T>
cudaError_t attn_bwd(const void* x, const void* wqkv, const void* bqkv, const void* wout, const void* bout,
                     const void* g1, const void* lse, const void* dr, const void* wqkvt, const void* woutt,
                     const void* sep, void* dx, void* dwqkv, void* dbqkv, void* dwout, void* dbout, void* dg1,
                     void* dbe1, void* xc, void* qkv, void* attn, void* r1, void* dgp, void* dr1, void* dr1c,
                     void* dout, void* pc, void* ds, void* dqkv, void* dqkvc, void* partial, void* wpartial, int B,
                     int seq, int D, int H, int splits, cudaStream_t s) {
  const int M = B * seq, ldp = (seq + 15) / 16 * 16;
  if constexpr (is_bf16_v<T>) {
    RETURN_IF_ERROR(cast_bf16(x, xc, (size_t)M * D, s));
  } else {
    xc = const_cast<void*>(x);
    dr1c = dr1;
    dqkvc = nullptr;  // dqkv serves
  }
  RETURN_IF_ERROR((gemm<T, EPI_ROUND>(xc, wqkv, bqkv, nullptr, qkv, M, 3 * D, D, s)));
  RETURN_IF_ERROR((attention<T, true>(qkv, attn, const_cast<void*>(lse), sep, B, seq, D, H, s)));
  RETURN_IF_ERROR((gemm<T, EPI_ROUND_RESID>(attn, wout, bout, x, r1, M, D, D, s)));
  RETURN_IF_ERROR((layernorm_bwd<T>(r1, dr, g1, dgp, dr1, is_bf16_v<T> ? dr1c : nullptr, M, D, s)));
  RETURN_IF_ERROR(colsum(sums(dgp, dg1, dr, dbe1, dr1, dbout), 3, partial, M, D, s));
  RETURN_IF_ERROR((gemm_weight_grad<T>(attn, dr1c, dwout, M, D, D, splits, wpartial, s)));
  RETURN_IF_ERROR((gemm<T, EPI_ROUND>(dr1c, woutt, nullptr, nullptr, dout, M, D, D, s)));
  RETURN_IF_ERROR((attention_bwd<T>(qkv, dout, lse, sep, pc, ds, B, seq, ldp, D, H, s)));
  RETURN_IF_ERROR((attention_grads<T>(qkv, dout, pc, ds, dqkv, dqkvc, B, seq, ldp, D, H, s)));
  if constexpr (!is_bf16_v<T>) dqkvc = dqkv;
  RETURN_IF_ERROR(colsum(sums(dqkv, dbqkv), 1, partial, M, 3 * D, s));
  RETURN_IF_ERROR((gemm_weight_grad<T>(xc, dqkvc, dwqkv, M, D, 3 * D, splits, wpartial, s)));
  return gemm<T, EPI_RESID>(dqkvc, wqkvt, nullptr, dr1, dx, M, D, 3 * D, s);
}

}  // namespace

// C entry points, bound with ctypes. Each enqueues its chain on `stream` and
// returns the first cudaError_t (0 on success); neither synchronises. The
// caller checks shapes (D, F multiples of 16, D / H in {16, 32, 64, 128},
// T <= 512) and allocates every output and scratch buffer.
extern "C" int pfn_fused_layer_bwd_ffn(const void* r, const void* w1, const void* b1, const void* w2,
                                       const void* b2, const void* g2, const void* dy, const void* w1t,
                                       const void* w2t, void* dr, void* dw1, void* db1, void* dw2, void* db2,
                                       void* dg2, void* dbe2, void* rc, void* h1, void* g, void* r2, void* dgp,
                                       void* dr2, void* dr2c, void* dh1, void* dh1c, void* partial,
                                       void* wpartial, int B, int T, int D, int F, int splits, int is_bf16,
                                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int M = B * T;
  const cudaError_t err =
      is_bf16 ? ffn_bwd<__nv_bfloat16>(r, w1, b1, w2, b2, g2, dy, w1t, w2t, dr, dw1, db1, dw2, db2, dg2, dbe2, rc,
                                       h1, g, r2, dgp, dr2, dr2c, dh1, dh1c, partial, wpartial, M, D, F, splits, s)
              : ffn_bwd<float>(r, w1, b1, w2, b2, g2, dy, w1t, w2t, dr, dw1, db1, dw2, db2, dg2, dbe2, rc, h1, g,
                               r2, dgp, dr2, dr2c, dh1, dh1c, partial, wpartial, M, D, F, splits, s);
  return static_cast<int>(err);
}

extern "C" int pfn_fused_layer_bwd_attn(const void* x, const void* wqkv, const void* bqkv, const void* wout,
                                        const void* bout, const void* g1, const void* lse, const void* dr,
                                        const void* wqkvt, const void* woutt, const void* sep, void* dx, void* dwqkv,
                                        void* dbqkv, void* dwout, void* dbout, void* dg1, void* dbe1, void* xc,
                                        void* qkv, void* attn, void* r1, void* dgp, void* dr1, void* dr1c,
                                        void* dout, void* pc, void* ds, void* dqkv, void* dqkvc, void* partial,
                                        void* wpartial, int B, int T, int D, int H, int splits, int is_bf16,
                                        void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? attn_bwd<__nv_bfloat16>(x, wqkv, bqkv, wout, bout, g1, lse, dr, wqkvt, woutt, sep, dx, dwqkv, dbqkv,
                                        dwout, dbout, dg1, dbe1, xc, qkv, attn, r1, dgp, dr1, dr1c, dout, pc, ds,
                                        dqkv, dqkvc, partial, wpartial, B, T, D, H, splits, s)
              : attn_bwd<float>(x, wqkv, bqkv, wout, bout, g1, lse, dr, wqkvt, woutt, sep, dx, dwqkv, dbqkv, dwout,
                                dbout, dg1, dbe1, xc, qkv, attn, r1, dgp, dr1, dr1c, dout, pc, ds, dqkv, dqkvc,
                                partial, wpartial, B, T, D, H, splits, s);
  return static_cast<int>(err);
}
