// Hopper building blocks of the bf16 flash kernels (pfn_flash_fwd.cu,
// pfn_flash_bwd.cu's dq and dk/dv kernels): TMA tensor maps, an mbarrier ring
// of tile pairs, the producer loop over a tile list, wgmma wrappers with
// their shared-memory descriptors, and accumulator-fragment helpers. The
// fused layer's GEMM (pfn_gemm_sm90.cuh) builds on the same maps, barriers,
// descriptors and wgmma wrappers. sm_90a only.
//
// Block shape shared by the kernels: three warpgroups. Warpgroups 0 and 1
// are consumers, 64 rows each, running wgmma with their accumulators in
// registers; warpgroup 2 is the producer, reduced to kProducerRegs registers
// by setmaxnreg, one of whose threads starts every TMA load. The block's
// resident tiles (q; q and dO; or k and v for dk/dv) arrive on their own
// barrier; the streamed tiles come in pairs (K and V; Q and dO for dk/dv)
// through a ring of STAGES slots, each with a `full` barrier (the producer's
// expect_tx, completed by the TMA bytes, and any per-row vectors the
// producer warp stores into the slot) and an `empty` barrier (one arrival per
// consumer thread once its wgmma reading the slot has retired). Both sides
// walk the same tile list, so the stage is i % STAGES and the phase parity
// (i / STAGES) & 1 for the i-th tile through the ring.
//
// Shared-memory layout of a tile of ROWS rows of a (BH, T, D) bf16 tensor:
// D / Panel<D>::cols panels, each ROWS rows of Panel<D>::row_bytes bytes (64
// columns, 128 bytes, 128-byte swizzle; at D = 32, 32 columns, 64 bytes,
// 64-byte swizzle), as one TMA box of a 3-D tensor map over (D, T, BH)
// writes it. Rows past T are zero-filled by the TMA unit, never read from the
// next head. Every panel starts on a 1024-byte boundary, so the swizzle phase
// of TMA's writes and of wgmma's reads agree (descriptor base offset 0).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pfn_flash_sm90 {

constexpr int kThreads = 384;          // two consumer warpgroups and one producer warpgroup
constexpr int kConsumerThreads = 256;  // arrivals that release a ring slot
constexpr int kProducerRegs = 40;      // 128 * 40 + 256 * 232 <= 65536
constexpr int kConsumerRegs = 232;
constexpr int kSmemLimit = 232448;  // bytes of shared memory one block may use
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Panel {
  static constexpr int cols = D < 64 ? D : 64;             // elements of one panel row
  static constexpr int row_bytes = cols * 2;               // 128 or 64
  static constexpr int count = D / cols;                   // panels per tile
  static constexpr int atom = 8 * row_bytes;               // swizzle atom: 8 rows
  static constexpr uint64_t layout = cols == 64 ? 1 : 2;  // descriptor layout: 128B or 64B swizzle
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
};

// Shared-memory plan of a block: NRES resident tiles of RES rows, then the
// ring (each slot two tiles of RING rows, then NVEC f32 vectors of RING
// values, one value per row of the slot's tiles), then the barriers. The
// ring takes as many slots (2 to 4) as the block's shared memory holds.
template <int D, int RES, int RING, int NRES, int NVEC = 0>
struct Smem {
  static constexpr int res_bytes = RES * D * 2;
  static constexpr int tile_bytes = RING * D * 2;
  static constexpr int vec_bytes = (NVEC * RING * 4 + 1023) / 1024 * 1024;  // keeps the next slot aligned
  static constexpr int slot_bytes = 2 * tile_bytes + vec_bytes;
  static constexpr int ring_off = NRES * res_bytes;
  static constexpr int fit = (kSmemLimit - 2048 - ring_off) / slot_bytes;
  static constexpr int STAGES = fit < 4 ? fit : 4;
  static constexpr int bar_off = ring_off + STAGES * slot_bytes;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
  static_assert(STAGES >= 2, "the ring needs two slots");
  static_assert(bytes <= kSmemLimit, "block over the shared-memory limit");
  static_assert(res_bytes % 1024 == 0 && slot_bytes % 1024 == 0, "tiles keep 1024-byte alignment");

  __device__ static uint32_t res_tile(uint32_t base, int r) { return base + r * res_bytes; }
  // Tile j (0 or 1) of ring slot s, and its vector v.
  __device__ static uint32_t ring_tile(uint32_t base, int s, int j) {
    return base + ring_off + s * slot_bytes + j * tile_bytes;
  }
  __device__ static uint32_t vec(uint32_t base, int s, int v) { return ring_tile(base, s, 2) + v * RING * 4; }
  __device__ static uint32_t res_bar(uint32_t base) { return base + bar_off; }
  __device__ static uint32_t full(uint32_t base, int s) { return base + bar_off + 8 * (1 + s); }
  __device__ static uint32_t empty(uint32_t base, int s) { return base + bar_off + 8 * (1 + STAGES + s); }
};

// The KV tiles a query tile [q0, q0 + BQ) visits, in order: the prefix tiles
// 0 .. ceil(sep / BK) - 1, then, in the diagonal variant, the tiles past them
// that hold the block's own diagonal keys [q0, q0 + BQ) (Tq == Tk there).
// Every other tile is skipped and never loaded. sep is clamped to [0, Tk].
// row0(i): the first key of the i-th tile.
template <int BQ, int BK, bool DIAG>
struct Tiles {
  int n_prefix, diag_first, n;
  __device__ Tiles(int sep, int q0, int Tk) {
    n_prefix = (sep + BK - 1) / BK;
    diag_first = n_prefix;
    n = n_prefix;
    if (DIAG) {
      diag_first = max(n_prefix, q0 / BK);
      const int last = (min(q0 + BQ, Tk) - 1) / BK;
      n += max(0, last - diag_first + 1);
    }
  }
  __device__ int row0(int i) const { return (i < n_prefix ? i : diag_first + (i - n_prefix)) * BK; }
};

// The query tiles of BQ rows a key tile [k0, k0 + BK) visits (the dk/dv
// kernel's list): every tile when k0 is below sep; past sep, in the diagonal
// variant, the tiles that hold its own diagonal queries [k0, k0 + BK) (Tq ==
// Tk there); else none. row0(i): the first query of the i-th tile.
template <int BQ, int BK, bool DIAG>
struct QueryTiles {
  int first, n;
  __device__ QueryTiles(int sep, int k0, int Tq) {
    first = 0;
    n = 0;
    if (k0 < sep) {
      n = (Tq + BQ - 1) / BQ;
    } else if (DIAG && k0 < Tq) {
      first = k0 / BQ;
      n = (min(k0 + BK, Tq) - 1) / BQ - first + 1;
    }
  }
  __device__ int row0(int i) const { return (first + i) * BQ; }
};

// Key `key` allowed for query `query` under the PFN rule (DIAG) or the prefix rule.
template <bool DIAG>
__device__ __forceinline__ bool allowed(int query, int key, int sep, int Tk) {
  return key < Tk && (key < sep || (DIAG && key == query));
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query,
// so the library needs no -lcuda.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// A tensor map of `rank` dimensions (innermost first) over a bf16 array:
// extents `dims`, byte strides of dimensions 1.. `strides`, box `box`.
// Elements outside the extents load as zeros.
inline cudaError_t encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                              const cuuint64_t* strides, const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D tensor map over a contiguous (BH, T, D) bf16 tensor whose box is one
// panel of `rows` rows of one b*h (see the layout note at the top).
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int BH, int T, int D, int rows) {
  const cuuint32_t cols = D < 64 ? D : 64;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {cols, (cuuint32_t)rows, 1};
  return encode_map(map, ptr, 3, dims, strides, box,
                    cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

// ------------------------------------------------------- barriers and TMA

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The block's dynamic shared memory, rounded up to a 1024-byte boundary.
__device__ __forceinline__ uint32_t smem_base(const void* raw) { return (smem_addr(raw) + 1023u) & ~1023u; }

// A generic pointer to shared address `addr` of the block whose dynamic
// shared memory starts at `raw`.
template <class T>
__device__ __forceinline__ T* smem_ptr(unsigned char* raw, uint32_t addr) {
  return reinterpret_cast<T*>(raw + (addr - smem_addr(raw)));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory"); }

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Wait until the barrier's current phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Rows [row0, row0 + ROWS) of b*h `bh`, every panel, onto barrier `bar`.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar, int row0, int bh) {
  using P = Panel<D>;
#pragma unroll
  for (int p = 0; p < P::count; ++p) tma_load_3d(dst + p * ROWS * P::row_bytes, map, bar, p * P::cols, row0, bh);
}

// The producer side that loads nothing besides the tiles.
struct NoVectors {
  __device__ void operator()(int, int) const {}
};

// The producer: lane 0 of the calling warp starts every TMA load, the NRES
// resident tiles (RES rows at res_row0) on their barrier, then both tiles of
// each ring slot (RING rows at the list's row0(i), from maps ma and mb) for
// the tiles of the list, which are the ring's it0-th tile onwards. After each
// slot's loads every calling thread runs vectors(row0, slot), which may
// store the slot's vectors and arrive on its `full` barrier (whose arrival
// count the kernel sets to match). Called by one thread (lane 0 of its warp)
// when vectors does nothing, or by a whole warp.
template <class L, int D, int RES, int RING, int NRES, class TileList, class Vectors = NoVectors>
__device__ void produce(const CUtensorMap* const (&res)[NRES], const CUtensorMap* ma, const CUtensorMap* mb,
                        uint32_t base, const TileList& tiles, int res_row0, int bh, int it0 = 0,
                        const Vectors& vectors = Vectors()) {
  const bool lane0 = (threadIdx.x & 31) == 0;
  if (lane0) {
    mbar_expect_tx(L::res_bar(base), NRES * L::res_bytes);
#pragma unroll
    for (int r = 0; r < NRES; ++r) load_tile<D, RES>(L::res_tile(base, r), res[r], L::res_bar(base), res_row0, bh);
  }
  for (int i = 0; i < tiles.n; ++i) {
    const int it = it0 + i;
    const int s = it % L::STAGES;
    mbar_wait(L::empty(base, s), ((it / L::STAGES) & 1) ^ 1);  // the first round passes at once
    if (lane0) {
      mbar_expect_tx(L::full(base, s), 2 * L::tile_bytes);
      load_tile<D, RING>(L::ring_tile(base, s, 0), ma, L::full(base, s), tiles.row0(i), bh);
      load_tile<D, RING>(L::ring_tile(base, s, 1), mb, L::full(base, s), tiles.row0(i), bh);
    }
    vectors(tiles.row0(i), s);
  }
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
}

__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
}

// ------------------------------------------------------------------- wgmma

// Descriptor of a swizzled panel operand at shared address `addr`: leading
// byte offset `lbo` and the stride of 8-row groups (one swizzle atom), both
// in 16-byte units.
template <int D>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)lbo << 16) | ((uint64_t)(Panel<D>::atom >> 4) << 32) |
         (Panel<D>::layout << 62);
}

// K-major operand (the reduction dim D contiguous), k-step kd (16 columns of
// D), rows from row0 of a tile of ROWS rows: A of S = Q K^T and dP = dO V^T,
// and their B (K or V, one key per row). A k-step never crosses a panel.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int row0, int kd) {
  using P = Panel<D>;
  return smem_desc<D>(
      tile + (kd * 16 / P::cols) * ROWS * P::row_bytes + row0 * P::row_bytes + (kd * 16 % P::cols) * 2, 1);
}

// MN-major B operand (N = the panel's columns of D contiguous), k-step kk (16
// keys) of panel `panel` of a tile of ROWS keys: B of O += P V and dQ += dS K.
// One wgmma per panel, so the N extent never leaves its swizzle atom and the
// only stride the product needs is that of 8-key groups (one atom); both
// offset fields carry it.
template <int D, int ROWS>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int kk, int panel) {
  using P = Panel<D>;
  return smem_desc<D>(tile + panel * ROWS * P::row_bytes + kk * 16 * P::row_bytes, P::atom >> 4);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
// Wait until at most N committed groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// Keep the compiler from moving reads or writes of wgmma operands across the
// asynchronous product: accumulators before the fence and after the wait, and
// register A fragments until the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// d[64 x N] (+)= A[64 x 16] B[16 x N], A and B in shared memory; scale_d = 0
// overwrites d. TA, TB: the transpose immediates, 1 for an MN-major A or B
// (M or N contiguous), 0 for K-major.
template <int N, int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  static_assert(N == 64 || N == 128, "wgmma_ss: N is 64 or 128");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// d[64 x N] += A[64 x 16] B[16 x N], A in registers, B MN-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs_tb<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs_tb<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// ------------------------------------------------------ fragment helpers
//
// Accumulator element e of an m64nN fragment of this thread lies at row
// 16 * warp + lane / 4 + 8 * ((e >> 1) & 1) of the warpgroup's 64 rows and at
// column 8 * (e >> 2) + 2 * (lane & 3) + (e & 1). A thread holds two rows
// (h = 0, 1), each shared with the three other threads of its quad.

__device__ __forceinline__ int frag_row(int e) {
  return 16 * ((threadIdx.x >> 5) & 3) + ((threadIdx.x & 31) >> 2) + 8 * ((e >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int e) { return 8 * (e >> 2) + 2 * (threadIdx.x & 3) + (e & 1); }

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even, as astype does
  return *reinterpret_cast<const uint32_t*>(&v);
}

// An m64nN f32 accumulator (keys as columns) rounded to bf16 as the register
// A fragments of N / 16 k-steps: the row/column pattern of the two layouts
// matches, so element pairs move without shuffles.
template <int N>
__device__ __forceinline__ void to_a_frags(const float (&s)[N / 2], uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// Store an m64nON accumulator panel (times `scale` of its row) as bf16 to a
// row-major (rows, D) matrix at column col0, rows row_base + frag_row(e),
// only rows below `nrows`.
template <int ON, int D>
__device__ __forceinline__ void store_panel(__nv_bfloat16* out, const float (&acc)[ON / 2], const float (&scale)[2],
                                            int row_base, int nrows, int col0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + frag_row(2 * h);
    if (row >= nrows) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + (size_t)row * D + col0);
#pragma unroll
    for (int j = 0; j < ON / 8; ++j)
      dst[(8 * j + 2 * (threadIdx.x & 3)) / 2] = pack_bf16(acc[4 * j + 2 * h] * scale[h], acc[4 * j + 2 * h + 1] * scale[h]);
  }
}

}  // namespace pfn_flash_sm90
