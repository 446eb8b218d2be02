// Building blocks of the flash kernels' f32 bodies for Hopper (sm_90a): FMA
// on the CUDA cores, no tensor cores, so f32 stays f32 (no TF32).
//
// What bounds an f32 body: every product is an FMA, 67 TFLOP/s on an H100
// SXM against 3.35 TB/s of HBM, so at T ~ 2000 the bodies are bound by
// operations, and the way to that bound is to feed the FMA units from
// registers. Shared memory gives 128 bytes a clock to an SM that does 128
// FMAs a clock: a product that loads one operand for every FMA or two runs
// at the rate of shared memory, not of the FMA units.
//
// * Thread layout. A block is 256 threads. Thread t is (tx, ty) = (t % 16,
//   t / 16). For a product with 16 RM output rows it owns rows ty + 16 i (i <
//   RM): the 16 threads of one row sit in one half of one warp, so a row's
//   max and sum need only shuffles (group_max, group_sum).
// * Micro-kernels, both with 16-byte loads from shared memory:
//   - mma_nt: C (rows x cols) += A B^T with A and B both row-major over the
//     reduced dimension (S = Q K^T, S^T = K Q^T, dP^T = V dO^T); each thread
//     owns RM x CN outputs (columns tx + 16 j) and reads one float4 of each
//     of its rows of A and of B per 4 steps of the reduction: (RM + CN) / (RM
//     CN) floats a thread per FMA, 0.5 at 4 x 4, 0.375 at 8 x 4. A 16-byte
//     load costs a warp 4 shared-memory wavefronts whatever it broadcasts,
//     so this ratio, not the count of loads, sets the rate: at 0.25 the
//     FMA units and shared memory are even.
//   - mma_nn: C (rows x N) += A B with A row-major over the reduced
//     dimension and B row-major over N (P V, P^T dO, dS^T Q); each thread owns
//     RM rows x N / 16 columns (vectors of VW = min(4, N / 16) columns at tx VW
//     + 16 VW g; N = 16, the fused layer's smallest head dim, gives VW 1) and
//     reads one float4 of each A row and one vector of each B row per 4
//     steps: 0.375 floats per FMA at 4 x 8, 0.25 at 8 x 8.
// * Layouts without bank conflicts: an operand tile's rows are padded by 4
//   floats (ld_tile), so the 8 rows that one quarter-warp reads in mma_nt
//   fall into 8 distinct groups of 4 banks; a staged score tile of 64
//   columns has a row stride of 16 banks past a multiple of 32 (ld_scores),
//   so the two rows that one warp writes meet in no bank.
// * Loads: cp.async of 16 bytes (4 bytes for a row's f32 terms), rows past
//   the end zero-filled in flight, so masked entries multiply zeros, never
//   whatever lay in shared memory. Each body keeps the next tile in flight
//   while the current one is computed.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace pfn_flash_f32 {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Row stride, in floats, of an operand tile of width D (a multiple of 4, so
// every row starts on 16 bytes).
__host__ __device__ constexpr int ld_tile(int D) { return D + 4; }
// Row stride of a staged score tile of `cols` columns (a multiple of 32).
__host__ __device__ constexpr int ld_scores(int cols) { return cols + 16; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes when !valid (src
// is then not read, but must be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + ROWS) of a (nrows, D) row-major f32 matrix (row stride
// ld, D by default) into shared memory with row stride ld_tile(D); rows past
// nrows are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile_async(float* dst, const float* __restrict__ src, int row0, int nrows,
                                                int ld = D) {
  constexpr int CHUNKS = D / 4;
  constexpr int LD = ld_tile(D);
  for (int i = threadIdx.x; i < ROWS * CHUNKS; i += kThreads) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool in = row0 + r < nrows;
    cp_async16(dst + r * LD + c, in ? src + (size_t)(row0 + r) * ld + c : src, in);
  }
}

// Entries [row0, row0 + ROWS) of an f32 vector of length nrows; 0 past it.
template <int ROWS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src, int row0, int nrows) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool in = row0 + i < nrows;
    cp_async4(dst + i, in ? src + row0 + i : src, in);
  }
}

// Max and sum over the 16 threads of one row (one half of a warp).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

// acc[i][j] += sum_k a[i * a_step + k] * b[j * b_step + k], k < K: the
// thread's rows of A start at a, i * a_step apart; its rows of B (the
// output's columns) at b, j * b_step apart.
template <int RM, int CN, int K>
__device__ __forceinline__ void mma_nt(float (&acc)[RM][CN], const float* a, int a_step, const float* b,
                                       int b_step) {
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[RM], bv[CN];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = ld4(a + i * a_step + k);
#pragma unroll
    for (int j = 0; j < CN; ++j) bv[j] = ld4(b + j * b_step + k);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// Columns of an N-wide output a thread owns: N / 16, in vectors of VW; its
// c-th entry is column (c / VW) 16 VW + tx VW + c % VW.
template <int N>
struct Cols {
  static constexpr int PER_THREAD = N / 16;
  static constexpr int VW = PER_THREAD < 4 ? PER_THREAD : 4;
  static constexpr int GROUPS = PER_THREAD / VW;
};

// acc[i][c] += sum_k a[i * a_step + k] * b[k * ldb + (column of entry c)],
// k < K (a multiple of 4).
template <int RM, int N, int K>
__device__ __forceinline__ void mma_nn(float (&acc)[RM][N / 16], const float* a, int a_step, const float* b, int ldb,
                                       int tx) {
  using C = Cols<N>;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 av[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i) av[i] = ld4(a + i * a_step + k);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* brow = b + (k + u) * ldb + tx * C::VW;
      float bv[C::PER_THREAD];
#pragma unroll
      for (int g = 0; g < C::GROUPS; ++g) {
        if constexpr (C::VW == 4) {
          const float4 t = ld4(brow + g * 16 * C::VW);
          bv[4 * g] = t.x, bv[4 * g + 1] = t.y, bv[4 * g + 2] = t.z, bv[4 * g + 3] = t.w;
        } else if constexpr (C::VW == 2) {
          const float2 t = *reinterpret_cast<const float2*>(brow + g * 16 * C::VW);
          bv[2 * g] = t.x, bv[2 * g + 1] = t.y;
        } else {
          bv[g] = brow[g * 16];
        }
      }
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float x = u == 0 ? av[i].x : u == 1 ? av[i].y : u == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int c = 0; c < C::PER_THREAD; ++c) acc[i][c] = fmaf(x, bv[c], acc[i][c]);
      }
    }
  }
}

// Store a thread's RM rows (row0 + ty + 16 i) of an N-wide f32 output (row
// stride ld, N by default), each row scaled by scale[i]; rows at or past
// nrows are skipped.
template <int RM, int N>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float (&acc)[RM][N / 16],
                                           const float (&scale)[RM], int row0, int nrows, int tx, int ty,
                                           int ld = N) {
  using C = Cols<N>;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= nrows) continue;
    float* out = dst + (size_t)row * ld + tx * C::VW;
#pragma unroll
    for (int g = 0; g < C::GROUPS; ++g) {
      if constexpr (C::VW == 4) {
        *reinterpret_cast<float4*>(out + g * 16 * C::VW) =
            make_float4(acc[i][4 * g] * scale[i], acc[i][4 * g + 1] * scale[i], acc[i][4 * g + 2] * scale[i],
                        acc[i][4 * g + 3] * scale[i]);
      } else if constexpr (C::VW == 2) {
        *reinterpret_cast<float2*>(out + g * 16 * C::VW) = make_float2(acc[i][2 * g] * scale[i],
                                                                       acc[i][2 * g + 1] * scale[i]);
      } else {
        out[g * 16] = acc[i][g] * scale[i];
      }
    }
  }
}

}  // namespace pfn_flash_f32
