// The bf16 GEMM of the fused layer's forward and backward
// (pfn_fused_layer_fwd.cu, pfn_fused_layer_bwd.cu, through
// pfn_fused_layer.cuh's `product` and the backward's attention products) for
// Hopper: out = epilogue(A B), A and B bf16 in device memory, f32
// accumulation. sm_90a only.
//
// Operands. A (M x K) and B (K x N) are each read in either layout, so no
// operand is ever transposed or copied:
//   A K-major:  stored (M, K), K contiguous: activations;
//   A MN-major: stored (K, M), M contiguous: X of a weight gradient X^T dY,
//               or the attention's ds and p read as ds^T and p^T;
//   B MN-major: stored (K, N), N contiguous: a weight W, dY, or the
//               columns of one head of qkv or dO;
//   B K-major:  stored (N, K), K contiguous: a weight W read as W^T.
// TMA sees every operand as a 4-D array (items, heads, rows, cols) (Tensor4;
// a plain matrix is (1, 1, rows, cols)), so one batched launch walks the
// (item, head) pairs of the attention's products, and a K tile past the rows
// of an item reads zeros, never the next item's rows. Elements past any
// extent load as zeros, which is how ragged M, N and K are handled; the
// epilogue masks its stores.
//
// Block: the three warpgroups of the flash kernels (pfn_flash_sm90.cuh),
// one block per 128 x BN output tile (BN 128, or 64 for the attention's
// products at head dims up to 64), N fastest. Warpgroups 0 and 1 each
// own 64 rows of a tile and run wgmma.m64nBNk16 from shared memory with the
// accumulator in registers (BN / 2 f32 a thread); one thread of warpgroup 2
// issues the TMA loads of 64-deep K tiles of A and B (one 128-byte swizzled
// panel of bf16 per row) into a ring of as many slots as fit (6 at BN 128),
// each released by the consumers' 256 arrivals once the products reading it
// have retired. A consumer keeps one commit group in flight: K tile k's
// products are issued before tile k - 1's slot is released. (A persistent
// grid, 128 x 256 tiles, and a ping-pong schedule, each warpgroup a whole
// tile of its own from a ring of its own, the two taking turns, all measured
// no faster at the fused layer's shapes; see PERF.md.)
// The epilogue runs on the accumulator fragments (frag_row / frag_col):
// bias, rounding, GELU, GELU', residual and scale, f32 stores of 8 bytes a
// thread, and bf16 stores of 8 bytes a thread after one exchange within each
// pair of lanes; the residual or GELU' input of eight fragment columns is
// loaded before any of it is used, so those loads are in flight together. It
// may also sum the f32 output's columns over the tile's rows (a bias
// gradient's partial sums, in a fixed order) and then need not store that
// output at all.
//
// Split-K (weight gradients): batch z sums the K rows [z * ksplit, (z + 1) *
// ksplit) into its own slice of the output, and the caller adds the slices in
// a fixed order: no atomics, so repeat calls are bitwise equal.

#pragma once

#include "pfn_flash_sm90.cuh"
#include "pfn_fused_common.cuh"

// Internal linkage (an unnamed namespace around the named one): the
// forward's and the backward's libraries each instantiate gemm<> with its
// once-per-device flag of the shared-memory limit, and a function-local
// static of a template with external linkage is one object across every
// library loaded into the process, so one library's flag would skip the
// other's cudaFuncSetAttribute.
namespace {
namespace pfn_gemm_sm90 {

namespace sm90 = pfn_flash_sm90;

constexpr int kBM = 128;     // output rows per tile
constexpr int kBK = 64;      // K per ring slot: one 128-byte panel row of bf16
constexpr int kPanel = 64;   // elements of a panel row
constexpr int kPanelBytes = kBK * kPanel * 2;  // one 64 x 64 MN-major panel: 8 KB
constexpr int kMaxDevices = 64;

// A bf16 array as its tensor map sees it: (items, heads, rows, cols), with
// element strides between heads, rows and items. Each stride times 2 bytes
// is a multiple of 16.
struct Tensor4 {
  const void* ptr;
  long long cols, heads, rows, items;
  long long ld_head, ld_row, ld_item;
};

// A row-major (rows, cols) matrix with row stride ld.
inline Tensor4 matrix(const void* ptr, int rows, int cols, int ld) {
  return Tensor4{ptr, cols, 1, rows, 1, ld, ld, (long long)ld * rows};
}

// The product's extents, over `batches` batches. Batch z is, without
// split-K, the (item, head) pair z = item * heads + head: A reads item z, B
// reads head b_head0 + z % heads of item z / heads. With ksplit > 0 it is a
// chunk of K.
struct Shape {
  int M, N, K;
  int batches, heads, b_head0;
  int ksplit;
};

// What the epilogue writes: out (and out2, aux) at element (z / heads) *
// o_hi + (z % heads) * o_lo + row * ldo + col. With `colsum`, the modes with
// an f32 output (GELU' and scale) also write the sum of each of its columns
// over the tile's 128 rows, at element ((z / heads) * ceil(M / 128) + row
// tile) * ldo + (z % heads) * o_lo + col of colsum: one row of partial sums
// per (item, row tile), which the caller adds in order. A null f32 out of
// those modes is not stored.
struct Epi {
  const float* bias;  // (N,) f32 or null
  const float* aux;   // f32, as out
  void* out;
  void* out2;         // bf16 or null
  float* colsum;      // f32 or null
  int ldo;
  long long o_hi, o_lo;
  float scale;
};

// Shared memory: the ring (as many slots of an A and a B tile as fit, up
// to 8), the consumer warps' column sums, then the barriers.
template <int BN>
struct Layout {
  static constexpr int a_bytes = kBM * kBK * 2;
  static constexpr int b_bytes = BN * kBK * 2;
  static constexpr int stage_bytes = a_bytes + b_bytes;
  static constexpr int sum_bytes = 8 * BN * 4;
  static constexpr int fit = (sm90::kSmemLimit - 2048 - sum_bytes) / stage_bytes;
  static constexpr int stages = fit < 8 ? fit : 8;
  static constexpr int sum_off = stages * stage_bytes;
  static constexpr int bar_off = sum_off + sum_bytes;
  static constexpr int bytes = bar_off + 16 * stages + 1024;  // + alignment slack
  static_assert(stages >= 2, "the ring needs two slots");
  static_assert(bytes <= sm90::kSmemLimit, "GEMM block over the shared-memory limit");

  __device__ static uint32_t a(uint32_t base, int s) { return base + s * stage_bytes; }
  __device__ static uint32_t b(uint32_t base, int s) { return a(base, s) + a_bytes; }
  __device__ static uint32_t full(uint32_t base, int s) { return base + bar_off + 8 * s; }
  __device__ static uint32_t empty(uint32_t base, int s) { return base + bar_off + 8 * (stages + s); }
};

// Descriptor of an MN-major operand in 64 x 64 panels (64 K rows of 128
// bytes each): k-step kk of the panel at `panel`; the next panel along M or N
// is kPanelBytes on (the leading offset), the next 8 K rows one swizzle atom
// (the stride).
__device__ __forceinline__ uint64_t desc_mn(uint32_t panel, int kk) {
  return sm90::smem_desc<kPanel>(panel + kk * 16 * kPanel * 2, kPanelBytes >> 4);
}

// bf16 (hi << 16 | lo) of two rows' column pairs, exchanged within a lane
// pair so that each lane stores four columns of one row: the even lane row
// h = 0, columns c .. c + 3; the odd lane row h = 1, columns c - 2 .. c + 1.
// Every lane of the warp calls it.
__device__ __forceinline__ uint2 exchange_rows(uint32_t row0, uint32_t row1, bool odd) {
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? row0 : row1, 1);
  return odd ? make_uint2(got, row1) : make_uint2(row0, got);
}

// Where tile t of the product lies: batch z, first row m0, first column n0,
// and its K rows [k_begin, k_begin + k_tiles * kBK) (fewer at K's end).
struct TileAt {
  int z, m_tile, m0, n0, k_begin, k_tiles;
  __device__ TileAt(const Shape& sh, int BN, int t) {
    const int tiles_m = (sh.M + kBM - 1) / kBM, tiles_n = (sh.N + BN - 1) / BN;
    n0 = t % tiles_n * BN;
    m_tile = t / tiles_n % tiles_m;
    m0 = m_tile * kBM;
    z = t / tiles_n / tiles_m;
    k_begin = sh.ksplit ? z * sh.ksplit : 0;
    const int k_end = sh.ksplit ? min(sh.K, k_begin + sh.ksplit) : sh.K;
    k_tiles = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  }
};

// The epilogue of NJ = 8 fragment column groups j0 .. j0 + 7 of one 64-row
// accumulator `acc` whose thread rows are r0 and r0 + 8 (see the note at the
// top); adds the f32 outputs of its in-bounds rows to sums.
template <int EPI, int BN, int J0>
__device__ __forceinline__ void epilogue_part(const float (&acc)[BN / 2], int r0, int n0, const Shape& sh,
                                              const Epi& ep, size_t obase, bool round2, float2 (&sums)[BN / 8]) {
  constexpr int NJ = 8;
  const int lane = threadIdx.x & 31;
  const bool odd = lane & 1;
  constexpr bool kRoundOut = EPI == EPI_ROUND || EPI == EPI_GELU;  // out is bf16
  constexpr bool kAux = EPI == EPI_ROUND_RESID || EPI == EPI_RESID || EPI == EPI_GELU_GRAD;
  constexpr bool kSums = EPI == EPI_GELU_GRAD || EPI == EPI_SCALE;
  [[maybe_unused]] float2 aux[kAux ? NJ : 1][2];
  if constexpr (kAux) {
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h, c = n0 + 8 * (J0 + jj) + 2 * (lane & 3);
        aux[jj][h] = c < sh.N && row < sh.M
                         ? *reinterpret_cast<const float2*>(ep.aux + obase + (size_t)row * ep.ldo + c)
                         : make_float2(0.0f, 0.0f);
      }
  }
#pragma unroll
  for (int jj = 0; jj < NJ; ++jj) {
    const int j = J0 + jj;
    const int c = n0 + 8 * j + 2 * (lane & 3);
    const bool col_in = c < sh.N;  // N is even, so c + 1 < N too
    float2 bias = make_float2(0.0f, 0.0f);
    if (ep.bias != nullptr && col_in) bias = *reinterpret_cast<const float2*>(ep.bias + c);
    uint32_t rounded[2] = {0u, 0u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      const bool in = col_in && row < sh.M;
      const size_t o = obase + (size_t)row * ep.ldo + c;
      const float v0 = acc[4 * j + 2 * h] + bias.x, v1 = acc[4 * j + 2 * h + 1] + bias.y;
      if constexpr (EPI == EPI_ROUND) {
        rounded[h] = sm90::pack_bf16(v0, v1);
      } else if constexpr (EPI == EPI_GELU) {
        rounded[h] = sm90::pack_bf16(gelu(v0), gelu(v1));
      } else {
        float2 f;  // the f32 output
        if constexpr (EPI == EPI_ROUND_RESID) {
          f = make_float2(aux[jj][h].x + to_float(from_float<__nv_bfloat16>(v0)),
                          aux[jj][h].y + to_float(from_float<__nv_bfloat16>(v1)));
        } else if constexpr (EPI == EPI_RESID) {
          f = make_float2(aux[jj][h].x + v0, aux[jj][h].y + v1);
        } else if constexpr (EPI == EPI_F32_GELU) {
          f = make_float2(v0, v1);
          rounded[h] = sm90::pack_bf16(gelu(v0), gelu(v1));
        } else {
          if constexpr (EPI == EPI_GELU_GRAD) {
            f = make_float2(v0 * gelu_grad(aux[jj][h].x), v1 * gelu_grad(aux[jj][h].y));
          } else {
            f = make_float2(v0 * ep.scale, v1 * ep.scale);
          }
          rounded[h] = sm90::pack_bf16(f.x, f.y);
          if (in) sums[j] = make_float2(sums[j].x + f.x, sums[j].y + f.y);
        }
        if (in && (!kSums || ep.out != nullptr)) *reinterpret_cast<float2*>(static_cast<float*>(ep.out) + o) = f;
      }
    }
    if (kRoundOut || round2) {  // uniform over the launch, so every lane exchanges
      const uint2 w = exchange_rows(rounded[0], rounded[1], odd);
      const int row = r0 + (odd ? 8 : 0), col = odd ? c - 2 : c;
      if (col < sh.N && row < sh.M) {
        void* dst = kRoundOut ? ep.out : ep.out2;
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(dst) + obase + (size_t)row * ep.ldo + col) = w;
      }
    }
  }
}

template <int EPI, int BN, bool A_MN, bool B_MN>
__global__ void __launch_bounds__(sm90::kThreads, 1)
    gemm_sm90(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb, const Shape sh,
              const Epi ep) {
  using L = Layout<BN>;
  constexpr int S = L::stages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = sm90::smem_base(smem_raw);
  const int wg = threadIdx.x / 128;
  const TileAt at(sh, BN, blockIdx.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(L::full(base, s), 1);
      sm90::mbar_init(L::empty(base, s), sm90::kConsumerThreads);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    sm90::producer_regs();
    if (threadIdx.x == 256) {
      const int zb = sh.ksplit ? 0 : at.z;  // the operands' batch
      const int a_item = zb, b_head = sh.b_head0 + zb % sh.heads, b_item = zb / sh.heads;
      for (int kt = 0; kt < at.k_tiles; ++kt) {
        const int s = kt % S;
        const int k0 = at.k_begin + kt * kBK;
        sm90::mbar_wait(L::empty(base, s), ((kt / S) & 1) ^ 1);  // the first round passes at once
        const uint32_t bar = L::full(base, s);
        sm90::mbar_expect_tx(bar, L::stage_bytes);
        if constexpr (A_MN) {
#pragma unroll
          for (int p = 0; p < kBM / kPanel; ++p)
            sm90::tma_load_4d(L::a(base, s) + p * kPanelBytes, &ma, bar, at.m0 + p * kPanel, 0, k0, a_item);
        } else {
          sm90::tma_load_4d(L::a(base, s), &ma, bar, k0, 0, at.m0, a_item);
        }
        if constexpr (B_MN) {
#pragma unroll
          for (int p = 0; p < BN / kPanel; ++p)
            sm90::tma_load_4d(L::b(base, s) + p * kPanelBytes, &mb, bar, at.n0 + p * kPanel, b_head, k0, b_item);
        } else {
          sm90::tma_load_4d(L::b(base, s), &mb, bar, k0, b_head, at.n0, b_item);
        }
      }
    }
  } else {
    sm90::consumer_regs();
    float acc[BN / 2];
#pragma unroll
    for (int e = 0; e < BN / 2; ++e) acc[e] = 0.0f;
    for (int kt = 0; kt < at.k_tiles; ++kt) {
      const int s = kt % S;
      sm90::mbar_wait(L::full(base, s), (kt / S) & 1);
      const uint32_t a_t = L::a(base, s), b_t = L::b(base, s);
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: this warpgroup's 64 rows; MN-major, they are its own panel.
        const uint64_t da = A_MN ? desc_mn(a_t + wg * kPanelBytes, kk)
                                 : sm90::desc_k_major<kPanel, kBM>(a_t, wg * 64, kk);
        const uint64_t db = B_MN ? desc_mn(b_t, kk) : sm90::desc_k_major<kPanel, BN>(b_t, 0, kk);
        sm90::wgmma_ss<BN, A_MN, B_MN>(acc, da, db, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();  // K tile kt - 1's products have retired: release its slot
      sm90::fence_regs(acc);
      if (kt > 0) sm90::mbar_arrive(L::empty(base, (kt - 1) % S));
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);

    const size_t obase = (size_t)((at.z / sh.heads) * ep.o_hi + (at.z % sh.heads) * ep.o_lo);
    // A bf16 copy beside the f32 out: always for F32_GELU, if out2 for GELU' and scale.
    constexpr bool kSums = EPI == EPI_GELU_GRAD || EPI == EPI_SCALE;
    const bool round2 = EPI == EPI_F32_GELU || (kSums && ep.out2 != nullptr);
    const int r0 = at.m0 + wg * 64 + sm90::frag_row(0);
    float2 sums[BN / 8];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) sums[j] = make_float2(0.0f, 0.0f);
    epilogue_part<EPI, BN, 0>(acc, r0, at.n0, sh, ep, obase, round2, sums);
    if constexpr (BN == 128) epilogue_part<EPI, BN, 8>(acc, r0, at.n0, sh, ep, obase, round2, sums);
    if (kSums && ep.colsum != nullptr) {  // uniform over the launch
      // Lanes l, l ^ 4, ..., l ^ 28 hold the same columns: their sum is the
      // warp's 16 rows; then the 8 warps' sums in order.
      const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
      float* warp_sums = sm90::smem_ptr<float>(smem_raw, base + L::sum_off);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          sums[j].x += __shfl_xor_sync(0xffffffffu, sums[j].x, off);
          sums[j].y += __shfl_xor_sync(0xffffffffu, sums[j].y, off);
        }
        if (lane < 4) *reinterpret_cast<float2*>(warp_sums + warp * BN + 8 * j + 2 * lane) = sums[j];
      }
      asm volatile("bar.sync 1, %0;" ::"n"(sm90::kConsumerThreads) : "memory");  // the consumers only
      const int col = threadIdx.x;
      if (col < BN && at.n0 + col < sh.N) {
        float sum = 0.0f;
#pragma unroll
        for (int w = 0; w < 8; ++w) sum += warp_sums[w * BN + col];
        const int tiles_m = (sh.M + kBM - 1) / kBM;
        ep.colsum[((size_t)(at.z / sh.heads) * tiles_m + at.m_tile) * ep.ldo + (at.z % sh.heads) * ep.o_lo + at.n0 +
                  col] = sum;
      }
    }
  }
}

// A tensor map over t whose box is one 64-column panel of `rows` rows of
// one (item, head), 128-byte swizzled.
inline cudaError_t make_map(CUtensorMap* map, const Tensor4& t, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)t.cols, (cuuint64_t)t.heads, (cuuint64_t)t.rows, (cuuint64_t)t.items};
  const cuuint64_t strides[3] = {(cuuint64_t)t.ld_head * 2, (cuuint64_t)t.ld_row * 2, (cuuint64_t)t.ld_item * 2};
  const cuuint32_t box[4] = {kPanel, 1, (cuuint32_t)rows, 1};
  return sm90::encode_map(map, t.ptr, 4, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Enqueue out = epilogue(A B) (see Shape) on stream s.
template <int EPI, int BN, bool A_MN, bool B_MN>
cudaError_t gemm(const Tensor4& a, const Tensor4& b, const Shape& sh, const Epi& ep, cudaStream_t s) {
  using L = Layout<BN>;
  CUtensorMap ma, mb;
  RETURN_IF_ERROR(make_map(&ma, a, A_MN ? kBK : kBM));
  RETURN_IF_ERROR(make_map(&mb, b, B_MN ? kBK : BN));
  auto kernel = gemm_sm90<EPI, BN, A_MN, B_MN>;
  // The shared-memory limit is set once per device for each instantiation.
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  RETURN_IF_ERROR(cudaGetDevice(&device));
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    RETURN_IF_ERROR(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes));
    allowed[device] = true;
  }
  const long long tiles = (long long)((sh.M + kBM - 1) / kBM) * ((sh.N + BN - 1) / BN) * sh.batches;
  if (tiles == 0) return cudaSuccess;
  kernel<<<(unsigned)tiles, sm90::kThreads, L::bytes, s>>>(ma, mb, sh, ep);
  return cudaGetLastError();
}

}  // namespace pfn_gemm_sm90
}  // namespace
