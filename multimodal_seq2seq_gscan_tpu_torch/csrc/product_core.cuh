// The register-tiled float32 product core: one CTA's 128 x 256 tile of
// C = A^T B, where both operands are k-major (row k of A holds the tile's
// 128 output rows side by side, row k of B its 256 output columns).
//
// Shared by the weight-gradient helper (teacher_forced.cu: out = X^T dY
// over row-steps, its large products) and the grid plans of kernels 2, 3
// and 4 (grid_core.cuh: a step's products, activations [k][slot] against
// weights [k][column]; kernels 3 and 4 also take the 64 x 64 Tile<1, 1>
// below for their small products).
//
// Bound on the H100: operations, if the tile feeds the FMA pipe. An SM
// issues 128 float32 FMAs a clock and moves 128 bytes a clock out of shared
// memory, and a warp's 16-byte loads take a wavefront of 128 bytes for
// every 8 lanes, broadcast or not. So a thread that reads 16 floats a k for
// an 8 x 8 block of outputs (64 FMAs) asks shared memory for as many
// clocks as the FMA pipe: such a tile measured 36.1 TFLOP/s at 4096^3, 54%
// of the card's 67, and 30.7 with Kahan compensation (its 192 sums,
// compensations and partial sums a thread also cap it at one CTA per SM);
// torch.matmul 51.3 (scripts/torch_product_core_bench.py). Here each of the
// 256 threads keeps an 8 x 16 block (128 sums) and reads 24 floats a k
// (six float4) for 128 FMAs, three quarters of the FMA pipe's clocks, and
// may load the next k's floats while it multiplies the current ones: 44.0
// TFLOP/s (66%) in the same run. Its rows are ty*4 + 0..3 and 64 + ty*4 +
// 0..3, its columns 64q + tx*4 + 0..3 for q = 0..3 (tx, ty the thread's
// place in a 16 x 16 grid), so that a warp's float4 reads fall on distinct
// banks or broadcast.
//
// Operands come through a ring of kRingStages stages of kDepth k rows (A's
// [32][128] and B's [32][256] tiles, 147,456 bytes of dynamic shared memory,
// so the kernel sets cudaFuncAttributeMaxDynamicSharedMemorySize: one CTA
// per SM), filled by every thread's cp.async (16 bytes, L2 only; or 4 bytes
// where a row is not 16-byte aligned) two stages ahead of the arithmetic.
// Rows and columns past the operand's edge are zero-filled by the copies
// (their outputs are never stored). Each output's sum runs in k order in
// one register, one order fixed by the shapes; callers keep those chains
// short (at most kMaxChain terms: kernel 2 splits K, the helper splits its
// row-steps into chunks), and add the parts in a fixed order. No atomics,
// no TF32.
#pragma once

#include <cuda_runtime.h>

namespace gscan {
namespace core {

constexpr int kDepth = 32;    // k rows per stage
constexpr int kRingStages = 3;  // stages in the ring
constexpr int kThreads = 256;
constexpr int kMaxChain = 1024;  // terms a caller lets one sum run over

// 16 bytes (bytes of them read, the rest zero-filled), through L2 only.
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
// 4 bytes, or a zero where !valid.
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The copies of one operand's stage (every thread of the CTA): rows
// 0 .. kDepth - 1 of src (row r at src + r * ld), columns 0 .. kWidth - 1,
// into dst [kDepth][kWidth]; zeros past `rows` rows and `cols` columns
// (both at least 1). vec: src and ld allow 16-byte copies.
template <int kWidth>
__device__ __forceinline__ void load_stage(float* dst, const float* src,
                                           size_t ld, int rows, int cols,
                                           bool vec) {
  if (vec) {
#pragma unroll
    for (int e = threadIdx.x; e < kDepth * kWidth / 4; e += kThreads) {
      const int r = e / (kWidth / 4), c = e % (kWidth / 4) * 4;
      const int valid = r < rows ? max(0, min(4, cols - c)) : 0;
      copy16(dst + r * kWidth + c, valid > 0 ? src + r * ld + c : src,
             4 * valid);
    }
  } else {
#pragma unroll 4
    for (int e = threadIdx.x; e < kDepth * kWidth; e += kThreads) {
      const int r = e / kWidth, c = e % kWidth;
      const bool valid = r < rows && c < cols;
      copy4(dst + e, valid ? src + r * ld + c : src, valid);
    }
  }
}

// A tile of 64 kRowGroups x 64 kColGroups outputs over the CTA's 256
// threads (a 16 x 16 grid): a thread keeps 4 kRowGroups x 4 kColGroups
// sums, rows ty*4 + 0..3 of each 64-row group and columns tx*4 + 0..3 of
// each 64-column group, so that a warp's float4 reads fall on distinct
// banks or broadcast. Tile<2, 4> is the 128 x 256 tile above; Tile<1, 1>,
// 64 x 64 (16 FMAs per 8 floats read), serves the grid plans' products
// whose 128 x 256 tiles would be too few or too padded to spread a step's
// small products over the grid.
template <int kRowGroups, int kColGroups>
struct Tile {
  static constexpr int kM = 64 * kRowGroups;  // output rows (A's columns)
  static constexpr int kN = 64 * kColGroups;  // output columns (B's)
  static constexpr int kRows = 4 * kRowGroups;  // a thread's rows
  static constexpr int kCols = 4 * kColGroups;  // a thread's columns
  static constexpr int kFloatsA = kDepth * kM;
  static constexpr int kStageFloats = kDepth * (kM + kN);
  static constexpr int kSmemFloats = kRingStages * kStageFloats;

  // This thread's rows (i < kRows) and columns (j < kCols) of the tile.
  __device__ __forceinline__ static int row_of(int i) {
    return 64 * (i / 4) + (threadIdx.x / 16) * 4 + (i & 3);
  }
  __device__ __forceinline__ static int col_of(int j) {
    return 64 * (j / 4) + (threadIdx.x % 16) * 4 + (j & 3);
  }

  // The thread's A and B floats of row k of a stage.
  __device__ __forceinline__ static void fragments(const float* a,
                                                   const float* b, int k,
                                                   float (&av)[kRows],
                                                   float (&bv)[kCols]) {
    const int ra = (threadIdx.x / 16) * 4, cb = (threadIdx.x % 16) * 4;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) {
      const float4 v =
          *reinterpret_cast<const float4*>(a + k * kM + 64 * g + ra);
      av[4 * g] = v.x, av[4 * g + 1] = v.y, av[4 * g + 2] = v.z;
      av[4 * g + 3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < kColGroups; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(b + k * kN + 64 * q + cb);
      bv[4 * q] = v.x, bv[4 * q + 1] = v.y, bv[4 * q + 2] = v.z;
      bv[4 * q + 3] = v.w;
    }
  }

  // One tile's sums over `stages` stages into acc (zeroed first): load(s,
  // a, b) issues stage s's copies of A and B into a ([kDepth][kM]) and b
  // ([kDepth][kN]) (every thread, see load_stage). kPrefetch: row k + 1's
  // floats load while row k's multiply. smem: kSmemFloats floats, free
  // again on return. Every thread of the CTA calls this.
  template <bool kPrefetch = true, typename Load>
  __device__ __forceinline__ static void sums(int stages, float* smem,
                                              Load&& load,
                                              float (&acc)[kRows][kCols]) {
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < stages && s < kRingStages - 1; ++s) {
      float* slot = smem + s * kStageFloats;
      load(s, slot, slot + kFloatsA);
      commit();
    }
    for (int s = 0; s < stages; ++s) {
      // Stages up to s + kRingStages - 2 are issued; s must have landed.
      if (s + kRingStages - 2 < stages)
        wait<kRingStages - 2>();
      else
        wait<0>();
      // Stage s has landed for every thread, and every thread is past
      // stage s - 1, whose slot takes stage s + kRingStages - 1.
      __syncthreads();
      if (s + kRingStages - 1 < stages) {
        float* slot =
            smem + (s + kRingStages - 1) % kRingStages * kStageFloats;
        load(s + kRingStages - 1, slot, slot + kFloatsA);
        commit();
      }
      const float* a = smem + s % kRingStages * kStageFloats;
      const float* b = a + kFloatsA;
      if constexpr (kPrefetch) {
        float av[2][kRows], bv[2][kCols];
        fragments(a, b, 0, av[0], bv[0]);
#pragma unroll
        for (int k = 0; k < kDepth; ++k) {
          if (k + 1 < kDepth)
            fragments(a, b, k + 1, av[(k + 1) & 1], bv[(k + 1) & 1]);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[i][j] = fmaf(av[k & 1][i], bv[k & 1][j], acc[i][j]);
        }
      } else {
#pragma unroll 2
        for (int k = 0; k < kDepth; ++k) {
          float av[kRows], bv[kCols];
          fragments(a, b, k, av, bv);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // the ring is free for the caller
  }
};

// The 128 x 256 tile, as the helper and kernel 2's grid plan name it.
using Wide = Tile<2, 4>;
constexpr int kTileM = Wide::kM;   // output rows of a CTA tile (A's columns)
constexpr int kTileN = Wide::kN;   // output columns of a CTA tile (B's)
constexpr int kRows = Wide::kRows;  // a thread's rows
constexpr int kCols = Wide::kCols;  // a thread's columns
constexpr int kFloatsA = Wide::kFloatsA;
constexpr int kStageFloats = Wide::kStageFloats;
constexpr int kSmemFloats = Wide::kSmemFloats;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);  // 147,456

__device__ __forceinline__ int row_of(int i) { return Wide::row_of(i); }
__device__ __forceinline__ int col_of(int j) { return Wide::col_of(j); }

template <bool kPrefetch = true, typename Load>
__device__ __forceinline__ void tile_sums(int stages, float* smem, Load&& load,
                                          float (&acc)[kRows][kCols]) {
  Wide::sums<kPrefetch>(stages, smem, static_cast<Load&&>(load), acc);
}

}  // namespace core
}  // namespace gscan
