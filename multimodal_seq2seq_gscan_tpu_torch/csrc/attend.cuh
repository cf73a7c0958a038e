// Masked additive (Bahdanau) attention for one batch row, computed by one
// warp in one pass over the row's keys.
//
// Shared by kernel 1 (additive_attention.cu, one warp per row) and kernel 2
// (decode_block.cu, the two attentions of every decoder step). Given the
// projected query pq [H] and the row's projected keys K [M, H] (the keys are
// also the values):
//   score[m] = sum_h tanh(pq[h] + K[m, h]) * ew[h]
//   score[m] = -1e9 where mask[m] <= 0   (not -inf: an all-masked row gets
//                                         uniform weights instead of NaN)
//   w = softmax(score)
//   ctx[h] = sum_m w[m] * K[m, h]
// Bound on the H100: bytes (kernel 1) — each key element needs about six
// flops. So each key row is read from device memory once: the score and the
// context come from the same registers, by an online softmax (a running
// maximum and sum; the context so far is rescaled when the maximum grows),
// and each lane loads 16 bytes of a key row at a time (lane l holds features
// 4l .. 4l + 3 of each chunk of 128), two groups of kKeys(NC) keys in flight
// per warp.
// The raw scores are staged in a scratch row (lane m % 32 writes and later
// reads score m, so no other lane touches it), then normalised into the
// weights; the scratch may be the weights row itself.
//
// NC, the chunks of 128 features per lane (H <= 128 NC), is a compile-time
// count so that the query, energy and context stay in registers; the host
// picks the smallest that holds H (attend_chunks). Past 1024 features
// (attend_chunks 0) kernel 1 takes attend_row_wide instead, two passes over
// the keys with the features in runtime chunks. vec says that the keys may
// be read 16 bytes at a time (H % 4 == 0 and a 16-byte aligned base); else
// each lane reads its four features one at a time.
//
// kernels 3 and 4 (teacher_forced.cu) use warp_sum, warp_max and the
// register-resident limits below for their own CTA-wide attentions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gscan {

constexpr int kGroup = 4;   // keys in flight per warp (kernels 3 and 4)
constexpr int kFitH = 128;  // kernels 3 and 4's register-resident form:
constexpr int kFitM = 64;   //   H <= kFitH and M <= kFitM

__host__ __device__ constexpr bool attend_fits(int M, int H) {
  return M <= kFitM && H <= kFitH;
}

// Chunks of 128 features that attend_row<NC> needs for H (1, 2, 4 or 8;
// 0 past 1024 features: attend_row_wide).
__host__ __device__ constexpr int attend_chunks(int H) {
  return H <= 128 ? 1 : H <= 256 ? 2 : H <= 512 ? 4 : H <= 1024 ? 8 : 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, offset);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;
}

// Keys per group for NC chunks: kKeyFloats floats of keys per lane in a
// group, two groups in flight.
constexpr int kKeyFloats = 16;
template <int NC>
constexpr int kKeys = kKeyFloats / (4 * NC) > 0 ? kKeyFloats / (4 * NC) : 1;

// Features h0 .. h0 + 3 of one key row (zeros past H or for an absent key).
__device__ __forceinline__ float4 load_key4(const float* __restrict__ row,
                                            int h0, int H, bool present,
                                            bool vec) {
  float4 k = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!present || h0 >= H) return k;
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + h0));
  k.x = __ldg(row + h0);
  if (h0 + 1 < H) k.y = __ldg(row + h0 + 1);
  if (h0 + 2 < H) k.z = __ldg(row + h0 + 2);
  if (h0 + 3 < H) k.w = __ldg(row + h0 + 3);
  return k;
}

// A group of keys m0 .. m0 + G - 1: the lane's features (zeros past M) and
// the keys' mask values (1 without a mask), loaded together.
template <int NC, int G>
struct KeyGroup {
  float4 k[G][NC];
  float valid[G];

  __device__ __forceinline__ void load(const float* __restrict__ keys,
                                       const float* __restrict__ mask,
                                       int m0, int M, int H, bool vec) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int m = m0 + g;
      valid[g] = mask == nullptr ? 1.f : m < M ? __ldg(mask + m) : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        k[g][c] = load_key4(keys + (size_t)m * H, 128 * c + 4 * lane, H,
                            m < M, vec);
    }
  }
};

// The online softmax over keys m0 .. m0 + G - 1 (m0 < M; keys from M on
// are absent): their scores (staged in scores[m] by lane m % 32), the
// running maximum and sum, and the context so far, rescaled. A masked key's
// score is -1e9 whatever its features, and where the row has a valid key
// (skip_masked) its weight is exactly 0 (exp underflows), so its tanh terms
// are skipped; an all-masked row (uniform weights) computes every key.
template <int NC, int G>
__device__ __forceinline__ void attend_group(
    const KeyGroup<NC, G>& kg, const float (&q)[NC][4],
    const float (&e)[NC][4], float (&acc)[NC][4], float& run_max,
    float& run_sum, int m0, int M, bool skip_masked, float* scores) {
  const int lane = threadIdx.x & 31;
  const auto& k = kg.k;
  // Padding lanes have q = e = 0 and k = 0: they add tanh(0) * 0.
  float p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    p[g] = 0.f;
    if (skip_masked && !(kg.valid[g] > 0.f)) continue;  // warp-uniform
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      p[g] = fmaf(tanhf(q[c][0] + k[g][c].x), e[c][0], p[g]);
      p[g] = fmaf(tanhf(q[c][1] + k[g][c].y), e[c][1], p[g]);
      p[g] = fmaf(tanhf(q[c][2] + k[g][c].z), e[c][2], p[g]);
      p[g] = fmaf(tanhf(q[c][3] + k[g][c].w), e[c][3], p[g]);
    }
  }
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
    for (int g = 0; g < G; ++g)
      p[g] += __shfl_xor_sync(0xffffffffu, p[g], offset);

  float group_max = -INFINITY;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int m = m0 + g;
    if (m >= M)
      p[g] = -INFINITY;
    else if (!(kg.valid[g] > 0.f))
      p[g] = -1e9f;
    if (m < M && lane == (m & 31)) scores[m] = p[g];
    group_max = fmaxf(group_max, p[g]);
  }
  // The group has a key (m0 < M), so the new maximum is finite.
  const float new_max = fmaxf(run_max, group_max);
  const float scale = expf(run_max - new_max);  // 0 at the first group
  run_sum *= scale;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] *= scale;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = expf(p[g] - new_max);  // 0 past M
    run_sum += w;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c][0] = fmaf(w, k[g][c].x, acc[c][0]);
      acc[c][1] = fmaf(w, k[g][c].y, acc[c][1]);
      acc[c][2] = fmaf(w, k[g][c].z, acc[c][2]);
      acc[c][3] = fmaf(w, k[g][c].w, acc[c][3]);
    }
  }
  run_max = new_max;
}

// One warp's pass over keys [m_begin, m_end) of a row of M keys: the
// lane's query and energy features, the softmax state (running maximum and
// sum) and the unnormalised context, the scores staged in scores[m]. All 32
// lanes call it with the same arguments. pq is strided (stride 1 in global
// memory, the buffers' leading dim in the decode block's feature-major
// shared buffers); keys (the row's [M, H]), mask (or null: every key valid)
// and ew are contiguous. The keys go in groups of kKeys, the next group's
// loads issued before the current group's arithmetic.
template <int NC>
struct AttendPass {
  float acc[NC][4];
  float run_max = -INFINITY, run_sum = 0.f;
  bool skip_masked = false;  // the row has a valid key: skip masked ones

  __device__ __forceinline__ AttendPass(
      const float* pq, int pq_stride, const float* __restrict__ keys,
      const float* __restrict__ mask, const float* __restrict__ ew,
      int m_begin, int m_end, int M, int H, float* scores, bool vec) {
    constexpr int G = kKeys<NC>;
    const int lane = threadIdx.x & 31;
    float q[NC][4], e[NC][4];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = 128 * c + 4 * lane + j;
        q[c][j] = h < H ? pq[h * pq_stride] : 0.f;
        e[c][j] = h < H ? __ldg(ew + h) : 0.f;
        acc[c][j] = 0.f;
      }
    KeyGroup<NC, G> ka, kb;
    ka.load(keys, mask, m_begin, m_end, H, vec);  // in flight meanwhile
    if (mask != nullptr)
      for (int base = 0; base < M && !skip_masked; base += 32)
        skip_masked = __any_sync(
            0xffffffffu, base + lane < M && __ldg(mask + base + lane) > 0.f);
    for (int m0 = m_begin; m0 < m_end; m0 += 2 * G) {
      kb.load(keys, mask, m0 + G, m_end, H, vec);
      attend_group<NC, G>(ka, q, e, acc, run_max, run_sum, m0, m_end,
                          skip_masked, scores);
      if (m0 + G >= m_end) break;
      ka.load(keys, mask, m0 + 2 * G, m_end, H, vec);
      attend_group<NC, G>(kb, q, e, acc, run_max, run_sum, m0 + G, m_end,
                          skip_masked, scores);
    }
  }

  // ctx[h] = the context (all keys in this pass), weights[m] from the
  // staged scores (lane m % 32 wrote score m; it alone reads it).
  __device__ __forceinline__ void finish(float* ctx, int ctx_stride,
                                         float* weights,
                                         const float* scores, int M,
                                         int H) const {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = 128 * c + 4 * lane + j;
        if (h < H) ctx[h * ctx_stride] = acc[c][j] / run_sum;
      }
    for (int m = lane; m < M; m += 32)
      weights[m] = expf(scores[m] - run_max) / run_sum;
  }

  // This pass's state into part [H + 2]: the running maximum and sum, then
  // the unnormalised context.
  __device__ __forceinline__ void save(float* part, int H) const {
    const int lane = threadIdx.x & 31;
    if (lane == 0) part[0] = run_max, part[1] = run_sum;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int h = 128 * c + 4 * lane + j;
        if (h < H) part[2 + h] = acc[c][j];
      }
  }
};

// One warp, one row: the attention over all M keys (the score and the
// context in one pass over the keys). weights [M] receives the attention
// weights; scores [M] is the scratch row (shared memory, or weights).
template <int NC>
__device__ __forceinline__ void attend_row(
    const float* pq, int pq_stride, const float* __restrict__ keys,
    const float* __restrict__ mask, const float* __restrict__ ew, int M,
    int H, float* ctx, int ctx_stride, float* weights, float* scores,
    bool vec) {
  const AttendPass<NC> pass(pq, pq_stride, keys, mask, ew, 0, M, M, H,
                            scores, vec);
  pass.finish(ctx, ctx_stride, weights, scores, M, H);
}

// One warp: the attention of a row whose keys W warps took in chunks
// (AttendPass::save into parts[w * (H + 2)], the scores of all chunks in
// scores [M]), combined: the maximum over the chunks, each chunk's sum and
// context rescaled to it.
__device__ __forceinline__ void attend_combine(const float* parts, int W,
                                               int M, int H, float* ctx,
                                               int ctx_stride, float* weights,
                                               const float* scores) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int w = 0; w < W; ++w) mx = fmaxf(mx, parts[w * (H + 2)]);
  float sum = 0.f;
  for (int w = 0; w < W; ++w)
    sum += parts[w * (H + 2) + 1] * expf(parts[w * (H + 2)] - mx);
  for (int h = lane; h < H; h += 32) {
    float v = 0.f;
    for (int w = 0; w < W; ++w)
      v = fmaf(parts[w * (H + 2) + 2 + h], expf(parts[w * (H + 2)] - mx), v);
    ctx[h * ctx_stride] = v / sum;
  }
  for (int m = lane; m < M; m += 32)
    weights[m] = expf(scores[m] - mx) / sum;
}

// One warp, one row, any H: the attention in two passes over the keys, the
// features in runtime chunks of 128 (lane l holds features 4l .. 4l + 3 of
// each). The first pass stages each key's score in scores[m] (by lane
// m % 32) and keeps the maximum; the weights are written (and read back by
// every lane after __syncwarp); the second pass adds the context. For rows
// whose query and context do not fit attend_row's registers.
__device__ __forceinline__ void attend_row_wide(
    const float* pq, int pq_stride, const float* __restrict__ keys,
    const float* __restrict__ mask, const float* __restrict__ ew, int M,
    int H, float* ctx, int ctx_stride, float* weights, float* scores,
    bool vec) {
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int m = 0; m < M; ++m) {
    const float* row = keys + (size_t)m * H;
    float p = 0.f;
    for (int h0 = 4 * lane; h0 < H; h0 += 128) {
      const float4 k = load_key4(row, h0, H, true, vec);
      const float kv[4] = {k.x, k.y, k.z, k.w};
      for (int j = 0; j < 4 && h0 + j < H; ++j)
        p = fmaf(tanhf(pq[(h0 + j) * pq_stride] + kv[j]), __ldg(ew + h0 + j),
                 p);
    }
    p = warp_sum(p);
    if (mask != nullptr && !(__ldg(mask + m) > 0.f)) p = -1e9f;
    if (lane == (m & 31)) scores[m] = p;
    mx = fmaxf(mx, p);
  }
  float sum = 0.f;
  for (int m = lane; m < M; m += 32) sum += expf(scores[m] - mx);
  sum = warp_sum(sum);
  for (int m = lane; m < M; m += 32) weights[m] = expf(scores[m] - mx) / sum;
  __syncwarp();
  for (int h0 = 4 * lane; h0 < H; h0 += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int m = 0; m < M; ++m) {
      const float w = weights[m];
      const float4 k = load_key4(keys + (size_t)m * H, h0, H, true, vec);
      acc.x = fmaf(w, k.x, acc.x);
      acc.y = fmaf(w, k.y, acc.y);
      acc.z = fmaf(w, k.z, acc.z);
      acc.w = fmaf(w, k.w, acc.w);
    }
    const float av[4] = {acc.x, acc.y, acc.z, acc.w};
    for (int j = 0; j < 4 && h0 + j < H; ++j)
      ctx[(h0 + j) * ctx_stride] = av[j];
  }
}

}  // namespace gscan
