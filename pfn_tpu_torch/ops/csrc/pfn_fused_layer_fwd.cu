// Fused PFN encoder layer, forward, for Hopper (sm_90a).
//
// Replaces: pfn_tpu/ops/fused_layer.py, `_fwd_kernel` (:125-159) with its
// attention body `_attn_item` (:85-119), as called by `_fwd_call`
// (pl.pallas_call at :324). One post-LN encoder layer:
//   qkv = cdt(x Wqkv + bqkv); PFN attention over all heads (key j allowed for
//   query i when j < sep or j == i); ao = cdt(attn Wout + bout);
//   r = LN1(x + ao); g = cdt(gelu_tanh(cdt(r) W1 + b1)); y = LN2(r + g W2 + b2).
// Every product runs in this repository's kernels: no cuBLAS, no library
// call. The GEMMs, the attention and the LayerNorm are shared with the
// backward (pfn_fused_layer_bwd.cu): pfn_fused_layer.cuh dispatches bf16 to
// the Hopper kernels (pfn_gemm_sm90.cuh's GEMM, attn_fwd_sm90) and f32 to the
// FMA bodies of pfn_fused_common.cuh.
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
// rounded q and k; softmax in f32, p normalised and then rounded to the
// compute dtype before P.V (in bf16 p = cdt(exp(s - lse)) from a first pass
// that finds lse, see pfn_fused_layer.cuh); the head outputs and ao are
// rounded; the residuals, both LayerNorms (eps 1e-5), the FFN hidden h1
// (into the GELU) and f stay f32. bf16 products accumulate in f32 on the
// tensor cores; f32 takes an FMA path, so f32 stays f32 (no TF32).
//
// Design. The TPU kernel holds the four weight matrices and a whole item's
// qkv and (T, T) scores in VMEM. A Hopper block has 227 KB of shared memory,
// less than one item's qkv at D = 512, so the layer is one call that enqueues
// a chain of kernels on the caller's stream (eight in bf16, seven in f32),
// and the intermediates pass through device memory (they and the weights,
// ~20 MB at the flagship shape, stay in the 50 MB L2):
//   0. cast  xc   = cdt(x), into the rc scratch (bf16 only)
//   1. gemm  qkv  = cdt(xc Wqkv + bqkv)
//   2. attn  per (64 query rows, head, item) in bf16 on wgmma over the key
//            tiles that hold an allowed key, lse written (f32: attn_f32 on
//            register tiles, an online softmax; pfn_fused_common.cuh)
//   3. gemm  r1   = x + cdt(attn Wout + bout)          (into y)
//   4. ln    r    = LN1(r1), rc = cdt(r)
//   5. gemm  g    = cdt(gelu(rc W1 + b1))
//   6. gemm  r2   = r + (g W2 + b2)                    (into y)
//   7. ln    y    = LN2(r2), in place
// In bf16 the GEMMs are pfn_gemm_sm90.cuh's: 128 x 128 output tiles, a
// producer thread feeding a TMA ring of 64-deep K tiles, two consumer
// warpgroups on wgmma with the epilogue (bias, rounding, GELU, residual) on
// the accumulator fragments; the activation is read K-major and W (K, N)
// MN-major where it lies. The LayerNorms are a separate f32 pass each.
//
// What bounds it at the flagship shape (B 64, T 100, D 512, H 4, F 1024,
// bf16): ~28 GFLOP of products (qkv 10.1, attention <= 1.3, out 3.4, FFN
// 13.4), 28.5 us at the bf16 tensor-core peak, against ~43.5 MB of unique
// bytes (x, y, r in f32, the weights in bf16), 13 us at HBM rate. So it is
// compute bound, and nearly all of it is the four GEMMs, which at K of 512
// to 1024 (8-16 K tiles) and 200-600 output tiles run well below the peak
// (pfn_fused_layer_bwd.cu's note). Later work: LayerNorm in the epilogue of
// a whole-row GEMM (N = D), one persistent kernel per layer.

#include "pfn_fused_layer.cuh"

namespace {

template <typename T>
cudaError_t layer(const void* x, const void* wqkv, const void* bqkv, const void* wout, const void* bout,
                  const void* g1, const void* be1, const void* w1, const void* b1, const void* w2, const void* b2,
                  const void* g2, const void* be2, void* y, void* r, void* lse, void* qkv, void* attn, void* rc,
                  void* g, const void* sep, int B, int seq, int D, int H, int F, cudaStream_t s) {
  const int M = B * seq;
  // x.astype(cdt) into rc, which LN1 overwrites later; in f32 x is used as it is.
  const void* xc = x;
  if constexpr (is_bf16_v<T>) {
    RETURN_IF_ERROR(cast_bf16(x, rc, (size_t)M * D, s));
    xc = rc;
  }
  RETURN_IF_ERROR((product<T, EPI_ROUND>(xc, wqkv, bqkv, nullptr, qkv, nullptr, M, 3 * D, D, s)));
  RETURN_IF_ERROR((attention<T, false>(qkv, attn, lse, sep, B, seq, D, H, s)));
  RETURN_IF_ERROR((product<T, EPI_ROUND_RESID>(attn, wout, bout, x, y, nullptr, M, D, D, s)));
  RETURN_IF_ERROR((layernorm<T>(y, g1, be1, r, rc, M, D, s)));
  RETURN_IF_ERROR((product<T, EPI_GELU>(rc, w1, b1, nullptr, g, nullptr, M, F, D, s)));
  RETURN_IF_ERROR((product<T, EPI_RESID>(g, w2, b2, r, y, nullptr, M, D, F, s)));
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
