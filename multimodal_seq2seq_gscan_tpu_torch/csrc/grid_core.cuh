// The grid plans' shared machinery: a persistent kernel of one CTA per SM
// (a cooperative launch, so that every CTA is resident) walks a recurrence
// whose every step is a sequence of phases between grid barriers, each
// product of a step spread over the whole grid on product_core.cuh's
// 128 x 256 register tiles.
//
// Used by kernel 2's grid plan (decode_grid.cu) and by kernels 3 and 4's
// grid plans (teacher_forced_grid.cu).
// - GridBarrier: an arrival counter in device memory (zeroed before each
//   launch), acquire loads, a trap after about a minute instead of a hang.
//   A barrier does not make another SM's writes visible to this SM's L1, so
//   everything another CTA wrote is read past L1 (__ldcg, cp.async.cg).
// - product<kSegs>: C = X^T W over the step's rows (slots), X the
//   concatenation of up to four feature-major activation segments
//   ([k][ld], slots fastest) against as many row blocks of a weight matrix
//   ([k][N] row-major). K (the segments' rows, in stages of 32) is split
//   into ks parts: enough that no float32 sum runs over more than 1,024
//   terms (kMaxChain), more where the tiles are too few for the grid. Each
//   part's sums are stored apart ([N][M rounded up to 4]) and added in part
//   order by whoever reads them (part_sums). Every sum has one order, fixed
//   by the shapes and the card: no atomics.
// - attention<NC>: a step's attention rows, each on one warp (attend.cuh's
//   attend_row, or attend_row_wide past H = 1,024 with its query staged in
//   device memory), or on up to 8 warps of its CTA that split its keys when
//   the grid has few rows; its projected query the sum of a product's parts.
// Shared memory is the core's ring (147,456 bytes) at every H, M and V.
#pragma once

#include <climits>
#include <cstdint>

#include "attend.cuh"
#include "product_core.cuh"

namespace gscan {
namespace grid {

namespace core = gscan::core;

constexpr int kThreads = core::kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = core::kDepth;
constexpr int kMaxSplits = 16;    // k-split parts taken to fill the grid
constexpr int kStagedKeys = 256;  // scores in shared memory up to M keys
// Clock cycles a grid barrier waits before it traps (about a minute).
constexpr long long kBarrierTimeout = 120000000000LL;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// A barrier of the whole (co-resident) grid: each CTA adds one to the
// counter and waits for the count of this barrier (target). kTimed: thread
// 0 of CTA 0 adds its cycles waiting to *wait_cycles (phase timing builds).
template <bool kTimed = false>
struct GridBarrier {
  unsigned* count;
  unsigned target;
  unsigned long long* wait_cycles;
  __device__ void sync() {
    target += gridDim.x;
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence();
      atomicAdd(count, 1u);
      const long long start = clock64();
      while (true) {
        unsigned seen;
        asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                     : "=r"(seen)
                     : "l"(count)
                     : "memory");
        if (seen >= target) break;
        if (clock64() - start > kBarrierTimeout) __trap();
      }
      __threadfence();
      if constexpr (kTimed)
        if (blockIdx.x == 0) *wait_cycles += clock64() - start;
    }
    __syncthreads();
  }
};

// Stages of kDepth rows that k rows take.
__host__ __device__ inline int stages_of(int k) {
  return (k + kDepth - 1) / kDepth;
}

// The parts a product of `stages` stages needs so that no sum runs over
// more than kMaxChain terms.
__host__ __device__ inline int parts_for(int stages) {
  return (stages * kDepth + core::kMaxChain - 1) / core::kMaxChain;
}

// The parts a product of `segs` input segments of H rows each needs.
__host__ __device__ inline int chain_parts(int segs, int H) {
  return parts_for(segs * stages_of(H));
}

// A product's input segment: k rows of activations x ([k][ld]) against k
// rows of weights w ([k][N]).
struct Segment {
  const float* x;
  const float* w;
  int k;
};

// A product's k-split sums: ks parts of [N][pld] floats (pld: its rows
// rounded up to 4), part p at p N pld.
struct Parts {
  int ks;
  size_t pld;
  int tasks;  // tiles x ks: the next product of a phase starts past them
};

// The k-split of a product of `tiles` tiles and `stages` stages: the parts
// ks (at least enough that no sum runs over more than kMaxChain terms,
// which the callers' room always holds; more up to kMaxSplits, the stages
// and the room) whose rounds of tasks over the grid times stages a part
// are least.
__device__ inline int split_count(int tiles, int stages, size_t room) {
  const int least = parts_for(stages);
  const int most = max(
      least, (int)min((size_t)min(kMaxSplits, stages), room));
  int best = least;
  long long best_cost = LLONG_MAX;
  for (int ks = least; ks <= most; ++ks) {
    const long long rounds =
        ((long long)tiles * ks + gridDim.x - 1) / gridDim.x;
    const long long cost = rounds * ((stages + ks - 1) / ks);
    if (cost < best_cost) best_cost = cost, best = ks;
  }
  return best;
}

// How a product of M rows, N columns and `stages` stages runs on tile T:
// flipped or not (the tile's rows output columns and its columns slots,
// where that pads the product less: N = 640 takes 768 columns unflipped,
// 640 flipped), its tiles and its k-split (split_count).
template <typename T>
struct Split {
  bool flip;
  int tiles_m, tiles_n, ks;
  __device__ Split(int M, int N, int stages, size_t room) {
    const long long pad_rows = (long long)(M + T::kM - 1) / T::kM * T::kM *
                               ((N + T::kN - 1) / T::kN * T::kN);
    const long long pad_flip = (long long)(N + T::kM - 1) / T::kM * T::kM *
                               ((M + T::kN - 1) / T::kN * T::kN);
    flip = pad_flip < pad_rows;
    tiles_m = flip ? (M + T::kN - 1) / T::kN : (M + T::kM - 1) / T::kM;
    tiles_n = flip ? (N + T::kM - 1) / T::kM : (N + T::kN - 1) / T::kN;
    const size_t pld = ((size_t)M + 3) / 4 * 4;
    ks = split_count(tiles_m * tiles_n, stages, room / (N * pld));
  }
};

// out: part p of the product on tile T, [N][pld] at p N pld for p < ks:
// part p's share of sum over the segments g and k < segs[g].k of
// segs[g].x[k][s] segs[g].w[k][n], for s < M and n < N. room: floats of
// out. vec: every segment's w allows 16-byte copies (N % 4 == 0, 16-byte
// aligned); x always does (ld % 4 == 0). Task i runs in CTA (first + i) %
// G, so that two products of one phase can start on different CTAs. Every
// thread of every CTA calls this.
template <int kSegs, typename T>
__device__ __noinline__ Parts product_on(const Segment (&segs)[kSegs],
                                         int M, int N, size_t ld, float* out,
                                         size_t room, bool vec, float* smem,
                                         int first) {
  int stages = 0;
#pragma unroll
  for (int g = 0; g < kSegs; ++g) stages += stages_of(segs[g].k);
  const Split<T> split(M, N, stages, room);
  const bool flip = split.flip;
  const int tiles_m = split.tiles_m, tiles_n = split.tiles_n, ks = split.ks;
  const size_t pld = ((size_t)M + 3) / 4 * 4;
  const int tasks = tiles_m * tiles_n * ks;
  const int G = gridDim.x;
  for (int task = (blockIdx.x + G - first % G) % G; task < tasks;
       task += G) {
    const int m0 = task % tiles_m * (flip ? T::kN : T::kM);
    const int n0 = task / tiles_m % tiles_n * (flip ? T::kM : T::kN);
    const int p = task / (tiles_m * tiles_n);
    const int s0 = p * stages / ks, s1 = (p + 1) * stages / ks;
    float acc[T::kRows][T::kCols];
    // Without the core's prefetch of the next k's operands: with it, a
    // launch of kernel 2 took 1.11x as long at H = 640 (PERF.md).
    T::template sums<false>(
        s1 - s0, smem,
        [&](int s, float* a, float* b) {
          // Stage s0 + s: its segment and first row.
          int rest = s0 + s, g = 0;
#pragma unroll
          for (int i = 0; i + 1 < kSegs; ++i)
            if (g == i && rest >= stages_of(segs[i].k))
              rest -= stages_of(segs[i].k), g = i + 1;
          const int k0 = rest * kDepth;
          const int rows = min(kDepth, segs[g].k - k0);
          const float* x = segs[g].x + k0 * ld + m0;
          const float* w = segs[g].w + (size_t)k0 * N + n0;
          if (flip) {
            core::load_stage<T::kM>(a, w, N, rows, N - n0, vec);
            core::load_stage<T::kN>(b, x, ld, rows, M - m0, true);
          } else {
            core::load_stage<T::kM>(a, x, ld, rows, M - m0, true);
            core::load_stage<T::kN>(b, w, N, rows, N - n0, vec);
          }
        },
        acc);
    float* o = out + (size_t)p * N * pld;
    if (flip) {
      // acc[i][j]: column n0 + row_of(i), slot m0 + col_of(j), the slots
      // in runs of 4.
#pragma unroll
      for (int i = 0; i < T::kRows; ++i) {
        const int n = n0 + T::row_of(i);
        if (n >= N) continue;
#pragma unroll
        for (int run = 0; run < T::kCols / 4; ++run) {
          const int s = m0 + T::col_of(4 * run);
          float* dst = o + (size_t)n * pld + s;
          if (s + 3 < M) {
            *reinterpret_cast<float4*>(dst) =
                make_float4(acc[i][4 * run], acc[i][4 * run + 1],
                            acc[i][4 * run + 2], acc[i][4 * run + 3]);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (s + q < M) dst[q] = acc[i][4 * run + q];
          }
        }
      }
      continue;
    }
#pragma unroll
    for (int j = 0; j < T::kCols; ++j) {
      const int n = n0 + T::col_of(j);
      if (n >= N) continue;
#pragma unroll
      for (int half = 0; half < T::kRows / 4; ++half) {
        const int s = m0 + T::row_of(4 * half);
        float* dst = o + (size_t)n * pld + s;
        if (s + 3 < M) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[4 * half][j], acc[4 * half + 1][j],
                          acc[4 * half + 2][j], acc[4 * half + 3][j]);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (s + q < M) dst[q] = acc[4 * half + q][j];
        }
      }
    }
  }
  return Parts{ks, pld, tasks};
}

// A product on the 128 x 256 tile (kernel 2's grid plan takes it for every
// product).
template <int kSegs>
__device__ __forceinline__ Parts product(const Segment (&segs)[kSegs], int M,
                                         int N, size_t ld, float* out,
                                         size_t room, bool vec, float* smem,
                                         int first = 0) {
  return product_on<kSegs, core::Wide>(segs, M, N, ld, out, room, vec, smem,
                                       first);
}

// The 64 x 64 tile takes a product of at most kSmallTileMegaMacs million
// multiply-adds (kernels 3 and 4's grid plans; 0: never, for A/B builds).
// Such products are too small to fill the grid with 128 x 256 tiles, whose
// 1M multiply-adds a stage then leave a step's chain waiting on a few CTAs
// (a 64 x 64 stage is 131k); past it the 64 x 64 tiles read 2.7 times the
// bytes from L2 for the same sums and lose (scripts/torch_kernel_ab.py
// --teacher-forced, PERF.md).
constexpr int kSmallTileMegaMacs = 268;

// A product on the 64 x 64 tile where it is small (kSmallTileMegaMacs), else on
// the 128 x 256 tile.
template <int kSegs>
__device__ __forceinline__ Parts product_any(const Segment (&segs)[kSegs],
                                             int M, int N, size_t ld,
                                             float* out, size_t room,
                                             bool vec, float* smem,
                                             int first = 0) {
  long long k = 0;
#pragma unroll
  for (int g = 0; g < kSegs; ++g) k += segs[g].k;
  if ((long long)M * N * k <= kSmallTileMegaMacs * 1000000LL)
    return product_on<kSegs, core::Tile<1, 1>>(segs, M, N, ld, out, room,
                                               vec, smem, first);
  return product_on<kSegs, core::Wide>(segs, M, N, ld, out, room, vec, smem,
                                       first);
}

// The sums of a product's ks parts (`stride` apart) at kN elements i[e]
// (where valid[e]), each in part order; read past L1, as everything another
// CTA wrote. Every element's loads of a block of kPartBlock parts are
// issued before their adds, so that up to kN kPartBlock loads wait on L2
// together (one after another, the passes waited once for each).
constexpr int kPartBlock = 4;
// Elements a thread sums at once in the passes over a product's parts.
constexpr int kBatch = 4;
template <int kN>
__device__ __forceinline__ void part_sums(const float* part, int ks,
                                          size_t stride,
                                          const size_t (&i)[kN],
                                          const bool (&valid)[kN],
                                          float (&sum)[kN]) {
  for (int p0 = 0; p0 < ks; p0 += kPartBlock) {
    float v[kN][kPartBlock];
#pragma unroll
    for (int e = 0; e < kN; ++e)
#pragma unroll
      for (int p = 0; p < kPartBlock; ++p)
        v[e][p] = valid[e] && p0 + p < ks
                      ? __ldcg(part + (p0 + p) * stride + i[e])
                      : 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e)
#pragma unroll
      for (int p = 0; p < kPartBlock; ++p)
        if (p0 + p < ks) sum[e] = p0 + p == 0 ? v[e][p] : sum[e] + v[e][p];
  }
}


// One of a step's attentions for slots [0, n), the projected query the sum
// of a product's parts ([H][pld] each): slot s runs in CTA s % G, on batch
// row slot_row[s] (s where slot_row is null). NC > 0: W warps a row, W the
// largest power of two that the CTA's 8 warps hold at its rows, the queries
// and the chunks combined through shared memory; NC = 0: one warp a row,
// attend_row_wide, slot s's query staged at stage + s H (so that shared
// memory does not grow with H). ctx: [H][ld]; weights_out: the step's
// [B][M] attention rows (also the scores' scratch past kStagedKeys keys);
// query_out (or null): the queries, [H][ld]. kQueryBatch: elements of the
// queries whose part loads a thread issues at once (kernel 2 keeps its 1;
// kernels 3 and 4, whose CTAs stage one or two rows of H and wait on each
// element's parts, take kBatch).
template <int NC, int kQueryBatch>
__device__ __noinline__ void attention(int n, const int* slot_row,
                                       const float* part, Parts q, size_t ld,
                                       int H, const float* __restrict__ keys,
                                       const float* __restrict__ mask,
                                       const float* __restrict__ ew, int M,
                                       float* ctx, float* weights_out,
                                       bool vec, float* smem, float* stage,
                                       float* query_out) {
  const int G = gridDim.x, cta = blockIdx.x, warp = threadIdx.x / 32;
  const int mine = n > cta ? (n - cta + G - 1) / G : 0;
  if (mine == 0) return;
  const int m_s = M <= kStagedKeys ? M : 0;
  int W = 1;
  if constexpr (NC > 0)
    while (2 * W * mine <= kWarps) W *= 2;
  const int R = kWarps / W;  // rows a round
  float* parts = smem + (NC > 0 ? R * H : 0);  // [kWarps][H + 2] (W > 1)
  float* scores = parts + (NC > 0 ? kWarps * (H + 2) : 0);  // [kWarps][m_s]
  for (int base = 0; base < mine; base += R) {
    const int rows = min(R, mine - base);
    // Row r's query: [R][H] in shared memory, or in the stage (NC = 0).
    const auto query = [&](int r) {
      return NC > 0 ? smem + r * H
                    : stage + (size_t)(cta + G * (base + r)) * H;
    };
    for (int i0 = threadIdx.x; i0 < rows * H; i0 += kQueryBatch * kThreads) {
      size_t at[kQueryBatch];
      bool valid[kQueryBatch];
      float v[kQueryBatch];
#pragma unroll
      for (int e = 0; e < kQueryBatch; ++e) {
        const int i = i0 + e * kThreads;
        valid[e] = i < rows * H;
        at[e] = valid[e] ? (size_t)(i % H) * q.pld + cta +
                               (size_t)G * (base + i / H)
                         : 0;
      }
      part_sums(part, q.ks, H * q.pld, at, valid, v);
#pragma unroll
      for (int e = 0; e < kQueryBatch; ++e) {
        const int i = i0 + e * kThreads;
        if (!valid[e]) continue;
        const int r = i / H, h = i % H;
        query(r)[h] = v[e];
        if (query_out != nullptr)
          query_out[h * ld + cta + (size_t)G * (base + r)] = v[e];
      }
    }
    __syncthreads();
    const int r = warp / W, w = warp % W;
    if (r < rows) {
      const int s = cta + G * (base + r);
      const size_t b = slot_row != nullptr ? __ldcg(slot_row + s) : s;
      const float* row_keys = keys + b * M * H;
      const float* row_mask = mask != nullptr ? mask + b * M : nullptr;
      float* row_weights = weights_out + b * M;
      if constexpr (NC == 0) {
        gscan::attend_row_wide(query(r), 1, row_keys, row_mask, ew, M, H,
                               ctx + s, static_cast<int>(ld), row_weights,
                               m_s ? scores + warp * m_s : row_weights, vec);
      } else if (W == 1) {
        gscan::attend_row<NC>(query(r), 1, row_keys, row_mask, ew, M, H,
                              ctx + s, static_cast<int>(ld), row_weights,
                              m_s ? scores + warp * m_s : row_weights, vec);
      } else {
        const int chunk = (M + W - 1) / W;
        const int m_begin = min(M, w * chunk);
        const gscan::AttendPass<NC> pass(
            query(r), 1, row_keys, row_mask, ew, m_begin,
            min(M, m_begin + chunk), M, H,
            m_s ? scores + r * W * m_s : row_weights, vec);
        pass.save(parts + warp * (H + 2), H);
      }
    }
    if (NC > 0 && W > 1) {
      __syncthreads();
      if (warp < rows) {
        const int s = cta + G * (base + warp);
        const size_t b = slot_row != nullptr ? __ldcg(slot_row + s) : s;
        gscan::attend_combine(parts + warp * W * (H + 2), W, M, H, ctx + s,
                              static_cast<int>(ld), weights_out + b * M,
                              m_s ? scores + warp * W * m_s
                                  : weights_out + b * M);
      }
    }
    __syncthreads();
  }
}

// attend.cuh's chunks of 128 features for H: the fewest that hold H, at
// least min_chunks, up to 8 (1,024 features); 0 past that
// (attend_row_wide).
__host__ __device__ inline int grid_chunks(int H, int min_chunks = 4) {
  const int chunks = (H + 127) / 128;
  return chunks <= min_chunks ? min_chunks : chunks <= 8 ? chunks : 0;
}

// attention<NC> for NC = grid_chunks(H, kMinChunks): one kernel, its
// attentions in the chunks the width needs (a lane's features padded to 32
// would compute 1,024 features' tanh for 640 at H = 640). Kernel 2 takes at
// least 4 chunks; kernels 3 and 4, whose grid plans serve H from ~200, 1
// (H = 256 in 4 chunks computed twice the tanh it needs).
template <int kQueryBatch = 1, int kMinChunks = 4>
__device__ inline void attention_any(int n, const int* slot_row,
                                     const float* part, Parts q, size_t ld,
                                     int H, const float* __restrict__ keys,
                                     const float* __restrict__ mask,
                                     const float* __restrict__ ew, int M,
                                     float* ctx, float* weights_out, bool vec,
                                     float* smem, float* stage,
                                     float* query_out = nullptr) {
  const int nc = grid_chunks(H, kMinChunks);
#define GSCAN_ATTENTION_FEW(NC)                                              \
  if constexpr (kMinChunks <= NC)                                           \
    if (nc == NC)                                                            \
      return attention<NC, kQueryBatch>(n, slot_row, part, q, ld, H, keys,  \
                                        mask, ew, M, ctx, weights_out, vec,  \
                                        smem, stage, query_out);
  GSCAN_ATTENTION_FEW(1)
  GSCAN_ATTENTION_FEW(2)
  GSCAN_ATTENTION_FEW(3)
#undef GSCAN_ATTENTION_FEW
  switch (nc) {
#define GSCAN_ATTENTION(NC)                                                  \
  case NC:                                                                   \
    attention<NC, kQueryBatch>(n, slot_row, part, q, ld, H, keys, mask, ew, \
                               M, ctx, weights_out, vec, smem, stage,       \
                               query_out);                                   \
    break;
    GSCAN_ATTENTION(4)
    GSCAN_ATTENTION(5)
    GSCAN_ATTENTION(6)
    GSCAN_ATTENTION(7)
    GSCAN_ATTENTION(8)
    GSCAN_ATTENTION(0)
#undef GSCAN_ATTENTION
  }
}

// The step's passes over the products' sums, each a function of its own
// (registers of its own, not the kernel's). Each walks its elements
// grid-stride, [feature][slot], the slots fastest.

// The visual query tanh(sums + b) for slots [0, n) into vq [H][ld].
static __device__ __noinline__ void visual_query(
    const float* part, Parts q, const float* __restrict__ bias, int n, int H,
    size_t ld, float* vq) {
  const size_t total = (size_t)H * n, threads = (size_t)gridDim.x * kThreads;
  for (size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
       first < total; first += kBatch * threads) {
    size_t at[kBatch];
    bool valid[kBatch];
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const size_t i = first + b * threads;
      valid[b] = i < total;
      at[b] = i / n * q.pld + i % n;
    }
    part_sums(part, q.ks, H * q.pld, at, valid, v);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const size_t i = first + b * threads, u = i / n;
      if (valid[b]) vq[u * ld + i % n] = tanhf(v[b] + __ldg(bias + u));
    }
  }
}

// The LSTM cell for the emitting slots [0, n): gates (i, f, g, o) the
// product's sums [4H][pld] plus b; c in place, the new h into hn.
static __device__ __noinline__ void cell(const float* part, Parts q,
                                         const float* __restrict__ bias,
                                         int n, int H, size_t ld, float* c,
                                         float* hn) {
  const size_t total = (size_t)H * n, threads = (size_t)gridDim.x * kThreads;
  const size_t stride = 4 * (size_t)H * q.pld, gate = H * q.pld;
  constexpr int kCells = kBatch / 2;  // two cells' four gates at once
  for (size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
       first < total; first += kCells * threads) {
    size_t at[4 * kCells];
    bool valid[4 * kCells];
    float g[4 * kCells];
#pragma unroll
    for (int b = 0; b < kCells; ++b) {
      const size_t i = first + b * threads;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        valid[4 * b + x] = i < total;
        at[4 * b + x] = x * gate + i / n * q.pld + i % n;
      }
    }
    part_sums(part, q.ks, stride, at, valid, g);
#pragma unroll
    for (int b = 0; b < kCells; ++b) {
      const size_t i = first + b * threads, u = i / n, s = i % n;
      if (!valid[4 * b]) continue;
      float gi = g[4 * b] + __ldg(bias + u);
      float gf = g[4 * b + 1] + __ldg(bias + H + u);
      float gg = g[4 * b + 2] + __ldg(bias + 2 * H + u);
      float go = g[4 * b + 3] + __ldg(bias + 3 * H + u);
      const float c_new = sigmoidf(gf) * __ldcg(c + u * ld + s) +
                          sigmoidf(gi) * tanhf(gg);
      hn[u * ld + s] = sigmoidf(go) * tanhf(c_new);
      c[u * ld + s] = c_new;
    }
  }
}

// A pass over a product's sums ([N][pld] parts) for slots [0, n): store(u,
// s, sum) for every u < N and s < n, grid-stride, [feature][slot], the
// slots fastest.
template <typename Store>
__device__ __noinline__ void sums_pass(const float* part, Parts q, int N,
                                          int n, Store store) {
  const size_t total = (size_t)N * n, threads = (size_t)gridDim.x * kThreads;
  for (size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
       first < total; first += kBatch * threads) {
    size_t at[kBatch];
    bool valid[kBatch];
    float v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const size_t i = first + b * threads;
      valid[b] = i < total;
      at[b] = i / n * q.pld + i % n;
    }
    part_sums(part, q.ks, N * q.pld, at, valid, v);
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const size_t i = first + b * threads;
      if (valid[b]) store(static_cast<int>(i / n), static_cast<int>(i % n),
                          v[b]);
    }
  }
}

// Floats of shared memory an attention round takes at these shapes (up to
// H = 1,024 eight rows' queries and the chunks' states; the staged scores).
__host__ __device__ inline size_t attention_smem_floats(int H, int M) {
  const size_t m_s = M <= kStagedKeys ? M : 0;
  return (grid_chunks(H) > 0 ? (size_t)kWarps * (2 * H + 2) : 0) +
         kWarps * m_s;
}

// Launches `kernel(args)` cooperatively, one CTA per SM (as many as the
// device holds at `smem` bytes of dynamic shared memory), on `stream`,
// after zeroing the barrier's counter.
template <typename Args>
cudaError_t launch_grid(void (*kernel)(Args), size_t smem, const Args& args,
                        unsigned* counter, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counter, 0, 4 * sizeof(float), st);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(sms * per_sm);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = st;
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeCooperative;
  attribute[0].val.cooperative = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace grid
}  // namespace gscan
