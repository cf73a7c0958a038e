// Micro-benchmark of the register-tiled float32 product core
// (multimodal_seq2seq_gscan_tpu_torch/csrc/product_core.cuh) and of the
// 128 x 128 designs it was chosen over: C [M][N] = A^T B, A [K][M] and B
// [K][N] k-major, M, N multiples of 256 and K of 32. Built and timed by
// scripts/torch_product_core_bench.py; not part of the port's library.
#include "../multimodal_seq2seq_gscan_tpu_torch/csrc/product_core.cuh"

namespace core = gscan::core;

namespace {

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// The 128 x 128 tile with an 8 x 8 block a thread (rows ty*4 + 0..3 and
// 64 + ty*4 + 0..3, columns tx*4 + 0..3 and 64 + tx*4 + 0..3): each
// stage's 32 terms summed on their own, then added plainly (kKahan false)
// or with Kahan compensation. The same ring as the core's: 3 stages of 32.
template <bool kKahan>
__global__ void __launch_bounds__(256, 1)
    tile8x8(const float* A, const float* B, float* C, int M, int N, int K) {
  constexpr int T = 128, D = core::kDepth, S = 3, TS = 2 * D * T;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_m = M / T;
  const int m0 = blockIdx.x % tiles_m * T, n0 = blockIdx.x / tiles_m * T;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8], comp[8][8];
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) acc[i][j] = comp[i][j] = 0.f;
  const int stages = K / D;
  auto load = [&](int st, float* a) {
    core::load_stage<T>(a, A + (size_t)st * D * M + m0, M, D, T, true);
    core::load_stage<T>(a + D * T, B + (size_t)st * D * N + n0, N, D, T,
                        true);
  };
  for (int st = 0; st < stages && st < S - 1; ++st) {
    load(st, smem + st * TS);
    core::commit();
  }
  for (int st = 0; st < stages; ++st) {
    if (st + 1 < stages)
      core::wait<1>();
    else
      core::wait<0>();
    __syncthreads();
    if (st + S - 1 < stages) {
      load(st + S - 1, smem + (st + S - 1) % S * TS);
      core::commit();
    }
    const float* a = smem + st % S * TS;
    const float* b = a + D * T;
    float part[8][8];
#pragma unroll 4
    for (int k = 0; k < D; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(a + k * T + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(a + k * T + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(b + k * T + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(b + k * T + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          part[i][j] = k == 0 ? av[i] * bv[j] : fmaf(av[i], bv[j], part[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if constexpr (kKahan) {
          kahan_add(acc[i][j], comp[i][j], part[i][j]);
        } else {
          acc[i][j] += part[i][j];
        }
      }
  }
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      C[(size_t)(m0 + (i < 4 ? 0 : 64) + ty * 4 + (i & 3)) * N + n0 +
        (j < 4 ? 0 : 64) + tx * 4 + (j & 3)] = acc[i][j];
}

// The core: a 128 x 256 tile, an 8 x 16 block a thread (core::tile_sums).
__global__ void __launch_bounds__(core::kThreads, 1)
    tile8x16(const float* A, const float* B, float* C, int M, int N, int K) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tiles_m = M / core::kTileM;
  const int m0 = blockIdx.x % tiles_m * core::kTileM;
  const int n0 = blockIdx.x / tiles_m * core::kTileN;
  float acc[core::kRows][core::kCols];
  core::tile_sums(
      K / core::kDepth, smem,
      [&](int st, float* a, float* b) {
        core::load_stage<core::kTileM>(
            a, A + (size_t)st * core::kDepth * M + m0, M, core::kDepth,
            core::kTileM, true);
        core::load_stage<core::kTileN>(
            b, B + (size_t)st * core::kDepth * N + n0, N, core::kDepth,
            core::kTileN, true);
      },
      acc);
  for (int i = 0; i < core::kRows; ++i)
    for (int j = 0; j < core::kCols; ++j)
      C[(size_t)(m0 + core::row_of(i)) * N + n0 + core::col_of(j)] =
          acc[i][j];
}

template <typename Kernel>
int launch(Kernel kernel, int tiles, size_t smem, const float* A,
           const float* B, float* C, int M, int N, int K, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<tiles, 256, smem, static_cast<cudaStream_t>(stream)>>>(A, B, C, M,
                                                                  N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant 0: 8 x 8 plain; 1: 8 x 8 Kahan; 2: the core (8 x 16).
extern "C" int product_core_bench(int variant, const float* A,
                                  const float* B, float* C, int M, int N,
                                  int K, void* stream) {
  const size_t smem8 = 3 * 2 * core::kDepth * 128 * sizeof(float);
  switch (variant) {
    case 0:
      return launch(tile8x8<false>, (M / 128) * (N / 128), smem8, A, B, C, M,
                    N, K, stream);
    case 1:
      return launch(tile8x8<true>, (M / 128) * (N / 128), smem8, A, B, C, M,
                    N, K, stream);
    case 2:
      return launch(tile8x16, (M / core::kTileM) * (N / core::kTileN),
                    core::kSmemBytes, A, B, C, M, N, K, stream);

  }
  return -1;
}
