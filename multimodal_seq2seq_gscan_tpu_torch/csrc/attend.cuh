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
// and each lane loads V features of a key row at a time (lane l holds
// features V l .. V l + V - 1 of each chunk of 32 V), two groups of
// kKeys(NC) keys in flight per warp.
// The raw scores are staged in a scratch row (lane m % 32 writes and later
// reads score m, so no other lane touches it), then normalised into the
// weights; the scratch may be the weights row itself.
//
// Form F (Form<KT, ST, V>) names the element types: keys KT (float or
// __nv_bfloat16), queries, energy vector and mask ST (float or
// __nv_bfloat16), and V (4 floats, 16 bytes; or 4 or 8 bf16, 8 or 16
// bytes). Every sum, the tanh, the softmax and the context are float32 in
// every form; a bf16 key stays raw in registers until it is used. F32
// (float, float, 4) is the form kernel 2 takes and kernel 1's float32 form.
//
// NC, the chunks of 32 V features per lane (H <= 32 V NC), is a
// compile-time count so that the query, energy and context stay in
// registers; the host picks the smallest that holds H (attend_chunks).
// Past 1024 features (attend_chunks 0) kernel 1 takes attend_row_wide
// instead, two passes over the keys with the features in runtime chunks.
// vec says that the keys may be read V features at a time (H % V == 0 and
// a base aligned to that many bytes); else each lane reads its features
// one at a time.
//
// kernels 3 and 4 (teacher_forced.cu) use warp_sum, warp_max and the
// register-resident limits below for their own CTA-wide attentions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gscan {

constexpr int kGroup = 4;   // keys in flight per warp (kernels 3 and 4)
constexpr int kFitH = 128;  // kernels 3 and 4's register-resident form:
constexpr int kFitM = 64;   //   H <= kFitH and M <= kFitM

__host__ __device__ constexpr bool attend_fits(int M, int H) {
  return M <= kFitM && H <= kFitH;
}

// A lane holds at most this many features of the query, energy vector and
// context in registers (NC V <= kLaneFeatures).
constexpr int kLaneFeatures = 32;

// Chunks of 32 V features that attend_row<NC> needs for H (1, 2, 4 or 8,
// while NC V <= kLaneFeatures; 0 past that, 1024 features:
// attend_row_wide).
template <int V = 4>
__host__ __device__ constexpr int attend_chunks(int H) {
  return H <= 32 * V ? 1
         : H <= 64 * V ? 2
         : H <= 128 * V && 4 * V <= kLaneFeatures ? 4
         : H <= 256 * V && 8 * V <= kLaneFeatures ? 8
                                                  : 0;
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

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V features h0 .. h0 + V - 1 of one key row as loaded (Raw; zeros past H
// or for an absent key), and feature h0 + j of it as a float (get).
template <typename KT, int V>
struct KeyLoad;

template <>
struct KeyLoad<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw load(const float* __restrict__ row,
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
  __device__ __forceinline__ static float get(const Raw& k, int j) {
    return j == 0 ? k.x : j == 1 ? k.y : j == 2 ? k.z : k.w;
  }
};

// bf16 keys: W 32-bit words of two features each (feature 2i in the low
// half of word i); a bf16 widens to float by a shift.
template <int W>
struct Bf16Words {
  uint32_t w[W];
};

template <int V>
struct Bf16KeyLoad {
  static constexpr int W = V / 2;
  using Raw = Bf16Words<W>;
  __device__ __forceinline__ static Raw load(
      const __nv_bfloat16* __restrict__ row, int h0, int H, bool present,
      bool vec) {
    Raw k;
#pragma unroll
    for (int i = 0; i < W; ++i) k.w[i] = 0u;
    if (!present || h0 >= H) return k;
    if (vec) {
      if constexpr (W == 4) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + h0));
        k.w[0] = u.x, k.w[1] = u.y, k.w[2] = u.z, k.w[3] = u.w;
      } else {
        const uint2 u = __ldg(reinterpret_cast<const uint2*>(row + h0));
        k.w[0] = u.x, k.w[1] = u.y;
      }
      return k;
    }
#pragma unroll
    for (int j = 0; j < V; ++j)
      if (h0 + j < H)
        k.w[j / 2] |= static_cast<uint32_t>(__bfloat16_as_ushort(
                          __ldg(row + h0 + j)))
                      << (16 * (j & 1));
    return k;
  }
  __device__ __forceinline__ static float get(const Raw& k, int j) {
    const uint32_t word = k.w[j / 2];
    return __uint_as_float((j & 1) ? (word & 0xffff0000u) : (word << 16));
  }
};

template <>
struct KeyLoad<__nv_bfloat16, 8> : Bf16KeyLoad<8> {};
template <>
struct KeyLoad<__nv_bfloat16, 4> : Bf16KeyLoad<4> {};

template <typename KT_, typename ST_, int V_>
struct Form {
  using KT = KT_;  // keys
  using ST = ST_;  // queries, energy vector, mask
  static constexpr int V = V_;
  using Load = KeyLoad<KT, V>;
  using Raw = typename Load::Raw;
};
using F32 = Form<float, float, 4>;

// Keys per group for NC chunks: kKeyWords 32-bit words of keys per lane in
// a group, two groups in flight.
constexpr int kKeyWords = 16;
template <int NC, typename F = F32>
constexpr int kKeys = kKeyWords / (int(sizeof(typename F::Raw)) / 4 * NC) > 0
                          ? kKeyWords / (int(sizeof(typename F::Raw)) / 4 * NC)
                          : 1;

// A group of keys m0 .. m0 + G - 1: the lane's features (zeros past M) and
// the keys' mask values (1 without a mask), loaded together.
template <int NC, int G, typename F = F32>
struct KeyGroup {
  typename F::Raw k[G][NC];
  float valid[G];

  __device__ __forceinline__ void load(
      const typename F::KT* __restrict__ keys,
      const typename F::ST* __restrict__ mask, int m0, int M, int H,
      bool vec) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int m = m0 + g;
      valid[g] = mask == nullptr ? 1.f
                 : m < M         ? to_float(__ldg(mask + m))
                                 : 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        k[g][c] = F::Load::load(keys + (size_t)m * H,
                                32 * F::V * c + F::V * lane, H, m < M, vec);
    }
  }
};

// The online softmax over keys m0 .. m0 + G - 1 (m0 < M; keys from M on
// are absent): their scores (staged in scores[m] by lane m % 32), the
// running maximum and sum, and the context so far, rescaled. A masked key's
// score is -1e9 whatever its features, and where the row has a valid key
// (skip_masked) its weight is exactly 0 (exp underflows), so its tanh terms
// are skipped; an all-masked row (uniform weights) computes every key.
template <int NC, int G, typename F = F32>
__device__ __forceinline__ void attend_group(
    const KeyGroup<NC, G, F>& kg, const float (&q)[NC][F::V],
    const float (&e)[NC][F::V], float (&acc)[NC][F::V], float& run_max,
    float& run_sum, int m0, int M, bool skip_masked, float* scores) {
  constexpr int V = F::V;
  const int lane = threadIdx.x & 31;
  const auto& k = kg.k;
  // Padding lanes have q = e = 0 and k = 0: they add tanh(0) * 0.
  float p[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    p[g] = 0.f;
    if (skip_masked && !(kg.valid[g] > 0.f)) continue;  // warp-uniform
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < V; ++j)
        p[g] = fmaf(tanhf(q[c][j] + F::Load::get(k[g][c], j)), e[c][j],
                    p[g]);
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
    for (int j = 0; j < V; ++j) acc[c][j] *= scale;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const float w = expf(p[g] - new_max);  // 0 past M
    run_sum += w;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < V; ++j)
        acc[c][j] = fmaf(w, F::Load::get(k[g][c], j), acc[c][j]);
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
template <int NC, typename F = F32>
struct AttendPass {
  static constexpr int V = F::V;
  using ST = typename F::ST;
  float acc[NC][V];
  float run_max = -INFINITY, run_sum = 0.f;
  bool skip_masked = false;  // the row has a valid key: skip masked ones

  __device__ __forceinline__ AttendPass(
      const ST* pq, int pq_stride, const typename F::KT* __restrict__ keys,
      const ST* __restrict__ mask, const ST* __restrict__ ew, int m_begin,
      int m_end, int M, int H, float* scores, bool vec) {
    constexpr int G = kKeys<NC, F>;
    const int lane = threadIdx.x & 31;
    float q[NC][V], e[NC][V];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int h = 32 * V * c + V * lane + j;
        q[c][j] = h < H ? to_float(pq[h * pq_stride]) : 0.f;
        e[c][j] = h < H ? to_float(__ldg(ew + h)) : 0.f;
        acc[c][j] = 0.f;
      }
    KeyGroup<NC, G, F> ka, kb;
    ka.load(keys, mask, m_begin, m_end, H, vec);  // in flight meanwhile
    if (mask != nullptr)
      for (int base = 0; base < M && !skip_masked; base += 32)
        skip_masked = __any_sync(
            0xffffffffu,
            base + lane < M && to_float(__ldg(mask + base + lane)) > 0.f);
    for (int m0 = m_begin; m0 < m_end; m0 += 2 * G) {
      kb.load(keys, mask, m0 + G, m_end, H, vec);
      attend_group<NC, G, F>(ka, q, e, acc, run_max, run_sum, m0, m_end,
                             skip_masked, scores);
      if (m0 + G >= m_end) break;
      ka.load(keys, mask, m0 + 2 * G, m_end, H, vec);
      attend_group<NC, G, F>(kb, q, e, acc, run_max, run_sum, m0 + G, m_end,
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
      for (int j = 0; j < V; ++j) {
        const int h = 32 * V * c + V * lane + j;
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
      for (int j = 0; j < V; ++j) {
        const int h = 32 * V * c + V * lane + j;
        if (h < H) part[2 + h] = acc[c][j];
      }
  }
};

// One warp, one row: the attention over all M keys (the score and the
// context in one pass over the keys). weights [M] receives the attention
// weights; scores [M] is the scratch row (shared memory, or weights).
template <int NC, typename F = F32>
__device__ __forceinline__ void attend_row(
    const typename F::ST* pq, int pq_stride,
    const typename F::KT* __restrict__ keys,
    const typename F::ST* __restrict__ mask,
    const typename F::ST* __restrict__ ew, int M, int H, float* ctx,
    int ctx_stride, float* weights, float* scores, bool vec) {
  const AttendPass<NC, F> pass(pq, pq_stride, keys, mask, ew, 0, M, M, H,
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
// features in runtime chunks of 32 V (lane l holds features V l .. V l +
// V - 1 of each). The first pass stages each key's score in scores[m] (by
// lane m % 32) and keeps the maximum; the weights are written (and read
// back by every lane after __syncwarp); the second pass adds the context.
// For rows whose query and context do not fit attend_row's registers.
template <typename F = F32>
__device__ __forceinline__ void attend_row_wide(
    const typename F::ST* pq, int pq_stride,
    const typename F::KT* __restrict__ keys,
    const typename F::ST* __restrict__ mask,
    const typename F::ST* __restrict__ ew, int M, int H, float* ctx,
    int ctx_stride, float* weights, float* scores, bool vec) {
  constexpr int V = F::V;
  const int lane = threadIdx.x & 31;
  float mx = -INFINITY;
  for (int m = 0; m < M; ++m) {
    const typename F::KT* row = keys + (size_t)m * H;
    float p = 0.f;
    for (int h0 = V * lane; h0 < H; h0 += 32 * V) {
      const typename F::Raw k = F::Load::load(row, h0, H, true, vec);
      for (int j = 0; j < V && h0 + j < H; ++j)
        p = fmaf(tanhf(to_float(pq[(h0 + j) * pq_stride]) +
                       F::Load::get(k, j)),
                 to_float(__ldg(ew + h0 + j)), p);
    }
    p = warp_sum(p);
    if (mask != nullptr && !(to_float(__ldg(mask + m)) > 0.f)) p = -1e9f;
    if (lane == (m & 31)) scores[m] = p;
    mx = fmaxf(mx, p);
  }
  float sum = 0.f;
  for (int m = lane; m < M; m += 32) sum += expf(scores[m] - mx);
  sum = warp_sum(sum);
  for (int m = lane; m < M; m += 32) weights[m] = expf(scores[m] - mx) / sum;
  __syncwarp();
  for (int h0 = V * lane; h0 < H; h0 += 32 * V) {
    float acc[V];
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int m = 0; m < M; ++m) {
      const float w = weights[m];
      const typename F::Raw k =
          F::Load::load(keys + (size_t)m * H, h0, H, true, vec);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(w, F::Load::get(k, j), acc[j]);
    }
    for (int j = 0; j < V && h0 + j < H; ++j)
      ctx[(h0 + j) * ctx_stride] = acc[j];
  }
}

}  // namespace gscan
