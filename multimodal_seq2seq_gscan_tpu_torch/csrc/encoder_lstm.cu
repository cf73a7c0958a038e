// The encoder kernel: one encoder LSTM layer's whole masked recurrence, both
// directions, in one launch.
//
// It replaces no TPU kernel: the JAX package's encoder is plain XLA (a scan
// over the padded positions). In the port the same loop
// (models/nn.py::masked_lstm_scan, with reverse_padded for the backward
// direction) was about 22 small launches a position and direction, and the
// greedy decode ran it without autograd; ops/encoder_lstm.py is the wrapper,
// models/model.py::encode_input takes it where no gradient is wanted.
//
// Semantics, those of the plain scan: gate order i, f, g, o with
// b_ih + b_hh; a row runs only to its own length (positions past it hold
// the carry and output zero); the backward direction reads position
// len - 1 - t at its step t and writes its output back there; the final
// (h, c) is the state after the last valid step. The output is either the
// directions' sum (the last layer: out = fwd + bwd, width H) or their
// concatenation (an inner layer: [fwd | bwd], width dirs * H); `hidden`
// (nullable) takes the sum of the directions' final h.
//
// Bound on the H100: operations. At the decode's baseline (B = 16,384,
// E = 25, H = 100, lengths 5 to 9 of 16) a step of a row is a 125 x 400
// product, about 24 GFLOP a batch over the real tokens: ~0.35 ms at the
// 67 TFLOP/s float32 peak, against ~105 MB of output (~0.03 ms).
//
// Design. Rows are independent and only the weights are shared, so each CTA
// owns a tile of `rows` rows (64 at the baseline) and runs both directions in
// turn, each up to its tile's longest row (each row's own mask holds its
// carry); the tiles take the batch's rows in order of length, longest first, so
// a tile runs few steps past its rows' own (at the decode's lengths 5 to 9 of a
// random batch, ~7.1 steps a row against 9). Every step's gate product [x_t |
// h] . [W_ih | W_hh]^T is register tiled as in product_core.cuh: a thread keeps
// 4 rows x 2 units x 4 gates (32 sums) and reads, per k, one float4 of the
// activations (its 4 rows, k-major) and two of the weights (its 2 units' 4
// gates, interleaved), so the epilogue (bias, nonlinearities, cell update,
// masking) is the thread's own: nothing of size [B, 4H] leaves the chip.
// Threads of a warp differ in rows first, so the weights' reads broadcast.
// Units run in passes of at most 64 (two at H = 100, eight at H = 512). The
// weights stream from L2 through a ring of 2 stages of 8 k rows in shared
// memory, filled by every thread's 16-byte cp.async one stage ahead of the
// arithmetic, from a copy laid out as the stages take them, [k][unit][gate]
// (the launch's first, small kernel; W's own rows of In = 25 floats allow no
// 16-byte copies, and 4-byte copies that transposed them cost ~0.8 ms a batch
// in issue slots); the activations [x_t | h] live in shared memory in two
// buffers (step t reads one while its epilogue writes h and the copies bring
// x_{t+1} into the other), the cell state c beside them. Step t's outputs leave
// from its h buffer during step t + 1, a row's units side by side (whole rows
// of stores, not one float a row). Each gate's sum runs in k order in one
// register, folded into a second every 1,024 terms where K is longer; no
// atomics, no TF32: the output is the same bits from run to run. The
// directions' sum is exact as the plain version's: the backward direction adds
// its value to what the forward direction stored there. At most 400 threads and
// 80 registers a thread, so two CTAs of the baseline's 64 rows share an SM.
// Where even 4 rows' activations exceed the shared memory (an input of
// thousands), they and c live in a global scratch that the wrapper allocates,
// per CTA, and the arithmetic is the same.
#include <cuda_runtime.h>

#include <algorithm>

#include "product_core.cuh"

namespace {

namespace core = gscan::core;

constexpr int kRowsPerThread = 4;
constexpr int kDepth = 8;        // k rows per weight stage
constexpr int kStages = 2;       // stages in the ring, kStages - 1 in flight
constexpr int kMaxThreads = 400;
constexpr int kMaxChain = 1024;  // terms one register sums before a fold
constexpr int kOutBatch = 4;     // output elements a thread writes at once

struct Direction {
  const float* w_ih;  // [4H, In]
  const float* w_hh;  // [4H, H]
  const float* b_ih;  // [4H]
  const float* b_hh;  // [4H]
};

struct Args {
  const float* x;      // [B, T, In]
  const int* lengths;  // [B]
  const int* order;    // [B]: the batch's rows, longest first
  Direction dir[2];
  float* out;          // [B, T, sum ? H : dirs * H]
  float* hidden;       // [B, H] or null
  float* scratch;      // per CTA: A (2 buffers) and C, or null
  float* packed;       // [dirs][In + H][H][4]: [W_ih | W_hh]^T, gates last
  int B, T, In, H, dirs, sum;
  int rows, unit_groups, passes;
};

// Float counts of the layout; every part is a multiple of 4 floats.
struct Layout {
  int k, kpad, chunks, units, stride, lens, ring, a, c;
};

__host__ __device__ inline Layout layout(int rows, int in, int hidden,
                                         int unit_groups) {
  Layout l;
  l.k = in + hidden;
  l.kpad = (l.k + kDepth - 1) / kDepth * kDepth;
  l.chunks = l.kpad / kDepth;
  l.units = 2 * unit_groups;
  // A k row's floats: the rows, and 4 more, so that a warp's reads of one
  // row's h across 32 units (the output's copy) take 4-way bank conflicts
  // rather than 32-way.
  l.stride = rows + 4;
  l.lens = 2 * rows + 4;  // each row's length and batch row, the longest
  l.ring = kStages * kDepth * 4 * l.units;
  l.a = l.kpad * l.stride;  // one buffer: [k][row]
  l.c = hidden * rows;      // [unit][row]
  return l;
}

__host__ __device__ inline long long shared_floats(const Layout& l,
                                                   bool scratch) {
  return l.lens + l.ring + (scratch ? 0LL : 2LL * l.a + l.c);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The weights as the stages take them: packed[d][k][j][g] =
// [W_ih | W_hh][g * H + j][k], so that a stage's k rows of a pass's units
// are contiguous runs of 16 bytes (a unit's 4 gates).
__global__ void pack_weights_kernel(Args a) {
  const int K = a.In + a.H;
  const long long n = static_cast<long long>(a.dirs) * K * a.H * 4;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = e % 4, j = e / 4 % a.H, k = e / 4 / a.H % K;
    const Direction w = a.dir[e / 4 / a.H / K];
    const size_t row = static_cast<size_t>(g) * a.H + j;
    a.packed[e] = k < a.In ? w.w_ih[row * a.In + k]
                           : w.w_hh[row * a.H + (k - a.In)];
  }
}

// kFold: K > kMaxChain, so each sum is folded into a second register every
// kMaxChain terms (a sum of thousands of terms in one register drifted
// further from float64 than the plain version's blocked product).
template <bool kScratch, bool kFold>
__global__ void __launch_bounds__(kMaxThreads, kFold ? 1 : 2)
    encoder_lstm_kernel(Args a) {
  extern __shared__ float4 shared4[];
  float* shared = reinterpret_cast<float*>(shared4);
  const int rows = a.rows, row_groups = rows / kRowsPerThread;
  const int unit_groups = a.unit_groups, threads = row_groups * unit_groups;
  const int tid = threadIdx.x, rg = tid % row_groups, ug = tid / row_groups;
  const int In = a.In, H = a.H, T = a.T;
  const Layout l = layout(rows, In, H, unit_groups);
  const int U = l.units, rs = l.stride;
  // A thread's first 16-byte unit of a weight stage (most copy just one).
  const int stage_kk = tid / U, stage_uu = tid - stage_kk * U;
  int* lens = reinterpret_cast<int*>(shared);
  int* ids = lens + rows;  // a tile row's batch row, or -1
  int* longest = ids + rows;
  float* ring = shared + l.lens;
  float* A = kScratch ? a.scratch + static_cast<size_t>(blockIdx.x) *
                                        (2 * l.a + l.c)
                      : ring + l.ring;
  float* C = A + 2 * l.a;
  const int row0 = blockIdx.x * rows;
  const int width = a.sum ? H : a.dirs * H;

  if (tid == 0) *longest = 0;
  __syncthreads();
  for (int r = tid; r < rows; r += threads) {
    const int id = row0 + r < a.B ? a.order[row0 + r] : -1;
    const int len = id >= 0 ? min(max(a.lengths[id], 0), T) : 0;
    ids[r] = id;
    lens[r] = len;
    atomicMax(longest, len);
  }
  for (int i = tid; i < 2 * l.a; i += threads) A[i] = 0.0f;  // the k padding
  __syncthreads();
  const int steps = *longest;
  const int total = steps * a.passes * l.chunks;  // weight stages a direction

  for (int d = 0; d < a.dirs; ++d) {
    const Direction w = a.dir[d];
    const float* weights = a.packed + static_cast<size_t>(d) * l.k * H * 4;
    const int column = a.sum ? 0 : d * H;  // this direction's output columns
    // Forward: position t at step t; backward: len - 1 - t.
    auto position = [&](int r, int t) { return d == 0 ? t : lens[r] - 1 - t; };

    // x_t of every row into buffer `buf` (zeros where the row is done).
    auto stage_x = [&](int buf, int t) {
      float* dst = A + buf * l.a;
      for (int e = tid; e < In * rows; e += threads) {
        const int r = e % rows, k = e / rows;
        const bool valid = t < lens[r];
        const float* src =
            valid ? a.x + (static_cast<size_t>(ids[r]) * T + position(r, t)) *
                              In + k
                  : a.x;
        if (kScratch)
          dst[k * rs + r] = valid ? *src : 0.0f;
        else
          core::copy4(dst + k * rs + r, src, valid);
      }
    };
    // The next weight stage to issue (its ring slot, pass and k chunk):
    // its k rows kc * kDepth.. of the pass's units, as [k][unit][gate]
    // (zeros past K and past H).
    int issue_slot = 0, issue_p = 0, issue_kc = 0;
    auto issue_stage = [&]() {
      const int k0 = issue_kc * kDepth, u0 = issue_p * U;
      const int count = min(U, H - u0);
      float* dst = ring + issue_slot * (kDepth * 4 * U);
      const float* src = weights + (static_cast<size_t>(k0) * H + u0) * 4;
      for (int e = tid, kk = stage_kk, uu = stage_uu; e < kDepth * U;
           e += threads, kk = e / U, uu = e - kk * U) {
        const bool valid = k0 + kk < l.k && uu < count;
        core::copy16(dst + 4 * e,
                     valid ? src + (static_cast<size_t>(kk) * H + uu) * 4
                           : weights,
                     valid ? 16 : 0);
      }
      issue_slot = issue_slot + 1 == kStages ? 0 : issue_slot + 1;
      if (++issue_kc == l.chunks) {
        issue_kc = 0;
        issue_p = issue_p + 1 == a.passes ? 0 : issue_p + 1;
      }
    };
    // Step t's outputs, from the h buffer that step wrote, row by row in
    // whole rows of units: h where the row was valid, at its position;
    // else zero at position t (the backward direction of a sum adds its
    // valid values to the forward direction's and leaves the rest).
    // Each thread takes kOutBatch elements at once, so that the backward
    // direction's reads of the forward's values are in flight together.
    auto write_out = [&](const float* h, int t) {
      int r = tid / H, j = tid - r * H;  // element r * H + j, in steps
      while (r < rows) {
        float* o[kOutBatch];
        float v[kOutBatch];
#pragma unroll
        for (int b = 0; b < kOutBatch; ++b) {
          const bool valid = r < rows && t < lens[r];
          o[b] = nullptr;
          if (r < rows && ids[r] >= 0 && !(a.sum && d == 1 && !valid)) {
            o[b] = a.out + (static_cast<size_t>(ids[r]) * T +
                            (valid ? position(r, t) : t)) * width + column + j;
            v[b] = valid ? h[j * rs + r] : 0.0f;
            if (a.sum && d == 1) v[b] += *o[b];
          }
          for (j += threads; j >= H; j -= H) ++r;
        }
#pragma unroll
        for (int b = 0; b < kOutBatch; ++b)
          if (o[b] != nullptr) *o[b] = v[b];
      }
    };

    // h0 = c0 = 0, x_0, and the first weight stages.
    for (int i = tid; i < H * rs; i += threads) A[In * rs + i] = 0.0f;
    for (int i = tid; i < l.c; i += threads) C[i] = 0.0f;
    stage_x(0, 0);
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < total) issue_stage();
      core::commit();
    }

    int s = 0, slot = 0, cur = 0;
    for (int t = 0; t < steps; ++t) {
      const float* act = A + cur * l.a;
      float* next = A + (cur ^ 1) * l.a;
      for (int p = 0; p < a.passes; ++p) {
        float acc[kRowsPerThread][2][4] = {};
        float part[kRowsPerThread][2][4] = {};
        for (int kc = 0; kc < l.chunks; ++kc, ++s) {
          core::wait<kStages - 2>();  // stage s (and x_t) landed here
          __syncthreads();  // ... for every thread; stage s - 1 is free
          if (s + kStages - 1 < total) issue_stage();
          if (p == 0 && kc == 0 && t + 1 < steps) stage_x(cur ^ 1, t + 1);
          core::commit();
          if (p == 0 && kc == 0 && t > 0) write_out(act + In * rs, t - 1);
          const float* ak = act + kc * kDepth * rs + kRowsPerThread * rg;
          const float* wk = ring + slot * (kDepth * 4 * U) + 4 * ug;
          slot = slot + 1 == kStages ? 0 : slot + 1;
#pragma unroll
          for (int kk = 0; kk < kDepth; ++kk) {
            const float4 x4 = *reinterpret_cast<const float4*>(ak + kk * rs);
            const float4 w0 = *reinterpret_cast<const float4*>(wk + kk * 4 * U);
            const float4 w1 = *reinterpret_cast<const float4*>(
                wk + kk * 4 * U + 4 * unit_groups);
            const float xs[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i) {
              acc[i][0][0] += xs[i] * w0.x;
              acc[i][0][1] += xs[i] * w0.y;
              acc[i][0][2] += xs[i] * w0.z;
              acc[i][0][3] += xs[i] * w0.w;
              acc[i][1][0] += xs[i] * w1.x;
              acc[i][1][1] += xs[i] * w1.y;
              acc[i][1][2] += xs[i] * w1.z;
              acc[i][1][3] += xs[i] * w1.w;
            }
          }
          if (kFold && (kc + 1) % (kMaxChain / kDepth) == 0) {
#pragma unroll
            for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
              for (int q = 0; q < 2; ++q)
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                  part[i][q][g] += acc[i][q][g];
                  acc[i][q][g] = 0.0f;
                }
          }
        }
        // The epilogue of this pass's units: this thread's own sums.
        const int u0 = p * U, count = min(U, H - u0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int uu = q * unit_groups + ug;
          if (uu >= count) continue;
          const int j = u0 + uu;
          float b_ih[4], b_hh[4];
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            b_ih[g] = w.b_ih[g * H + j];
            b_hh[g] = w.b_hh[g * H + j];
          }
          float4* c4 = reinterpret_cast<float4*>(C + j * rows) + rg;
          const float4* h4 =
              reinterpret_cast<const float4*>(act + (In + j) * rs) + rg;
          float cs[4] = {c4->x, c4->y, c4->z, c4->w};
          const float4 h_old = *h4;
          float hs[4] = {h_old.x, h_old.y, h_old.z, h_old.w};
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) {
            float gate[4];
#pragma unroll
            for (int g = 0; g < 4; ++g)
              gate[g] = (kFold ? part[i][q][g] + acc[i][q][g] : acc[i][q][g])
                        + b_ih[g] + b_hh[g];
            const float c_new =
                sigmoid(gate[1]) * cs[i] + sigmoid(gate[0]) * tanhf(gate[2]);
            const float h_new = sigmoid(gate[3]) * tanhf(c_new);
            if (t < lens[kRowsPerThread * rg + i]) {
              cs[i] = c_new;
              hs[i] = h_new;
            }
          }
          *c4 = make_float4(cs[0], cs[1], cs[2], cs[3]);
          reinterpret_cast<float4*>(next + (In + j) * rs)[rg] =
              make_float4(hs[0], hs[1], hs[2], hs[3]);
        }
      }
      // Fewer stages a step than in flight: x_{t+1} is among the newest.
      if (a.passes * l.chunks < kStages - 1) core::wait<0>();
      cur ^= 1;
    }
    core::wait<0>();
    __syncthreads();

    // The last step's outputs and the final h; zeros at the positions past
    // the tile's longest row.
    const float* h_final = A + cur * l.a + In * rs;
    if (steps > 0) write_out(h_final, steps - 1);
    for (int e = tid; e < rows * H; e += threads) {
      const int r = e % rows, j = e / rows;
      if (a.hidden == nullptr || ids[r] < 0) continue;
      float* o = a.hidden + static_cast<size_t>(ids[r]) * H + j;
      *o = d == 0 ? h_final[j * rs + r] : *o + h_final[j * rs + r];
    }
    if (!(a.sum && d == 1)) {
      for (long long e = tid; e < static_cast<long long>(T - steps) * rows * H;
           e += threads) {
        const int j = e % H, r = e / H % rows, t = steps + e / H / rows;
        if (ids[r] >= 0)
          a.out[(static_cast<size_t>(ids[r]) * T + t) * width + column + j] =
              0.0f;
      }
    }
    __syncthreads();  // before the next direction resets A and C
  }
}

}  // namespace

// Shared memory bytes of a CTA (A and C counted unless `scratch`), for the
// wrapper's plan.
extern "C" long long gscan_encoder_lstm_shared_bytes(int rows, int in,
                                                     int hidden,
                                                     int unit_groups,
                                                     int scratch) {
  return 4 * shared_floats(layout(rows, in, hidden, unit_groups),
                           scratch != 0);
}

// Floats of the global scratch a CTA takes when its activations do not fit
// shared memory.
extern "C" long long gscan_encoder_lstm_scratch_floats(int rows, int in,
                                                       int hidden,
                                                       int unit_groups) {
  const Layout l = layout(rows, in, hidden, unit_groups);
  return 2LL * l.a + l.c;
}

// order: the batch's rows by length, longest first (a CTA's tile is rows
// of like lengths, so it runs few steps past its rows' own). The backward
// direction's four pointers are null for a unidirectional
// layer (dirs = 1). scratch: null unless the plan puts A and C there;
// packed: dirs * (In + H) * 4H floats, which the first of the two launches
// fills with the weights in the stages' layout.
extern "C" int gscan_encoder_lstm(
    const float* x, const int* lengths, const int* order, const float* w_ih_f,
    const float* w_hh_f, const float* b_ih_f, const float* b_hh_f,
    const float* w_ih_b, const float* w_hh_b, const float* b_ih_b,
    const float* b_hh_b, float* out, float* hidden, float* scratch,
    float* packed, int B, int T, int In, int H, int dirs, int sum, int rows,
    int unit_groups, int passes, void* stream) {
  if (B <= 0 || T <= 0 || In <= 0 || H <= 0 || dirs < 1 || dirs > 2 ||
      rows <= 0 || rows % kRowsPerThread != 0 || unit_groups <= 0 ||
      passes <= 0 || 2 * unit_groups * passes < H ||
      rows / kRowsPerThread * unit_groups > kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{x, lengths, order,
         {{w_ih_f, w_hh_f, b_ih_f, b_hh_f}, {w_ih_b, w_hh_b, b_ih_b, b_hh_b}},
         out, hidden, scratch, packed, B, T, In, H, dirs, sum, rows,
         unit_groups, passes};
  const bool in_scratch = scratch != nullptr, fold = In + H > kMaxChain;
  const long long bytes = 4 * shared_floats(
      layout(rows, In, H, unit_groups), in_scratch);
  const auto kernel =
      in_scratch ? (fold ? encoder_lstm_kernel<true, true>
                         : encoder_lstm_kernel<true, false>)
                 : (fold ? encoder_lstm_kernel<false, true>
                         : encoder_lstm_kernel<false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long packed_floats =
      static_cast<long long>(dirs) * (In + H) * H * 4;
  const int pack_blocks =
      static_cast<int>(std::min<long long>((packed_floats + 255) / 256, 1024));
  pack_weights_kernel<<<pack_blocks, 256, 0, st>>>(a);
  const int blocks = (B + rows - 1) / rows;
  kernel<<<blocks, rows / kRowsPerThread * unit_groups, bytes, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
