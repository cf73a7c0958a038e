// Masked additive (Bahdanau) attention for one batch row, computed by one warp.
//
// Shared by kernel 1 (additive_attention.cu, one warp per row) and kernel 2
// (decode_block.cu, the two attentions of every decoder step). Given the
// projected query pq [H] and the row's projected keys K [M, H] (the keys are
// also the values):
//   score[m] = sum_h tanh(pq[h] + K[m, h]) * ew[h]
//   score[m] = -1e9 where mask[m] <= 0   (not -inf: an all-masked row gets
//                                         uniform weights instead of NaN)
//   w = softmax(score)                    (max-subtracted, then normalised)
//   ctx[h] = sum_m w[m] * K[m, h]
// Lanes run over h for the tanh, the dot with ew and the context (coalesced
// reads of a key row); a warp shuffle reduces each score, and the softmax
// over m uses warp-shuffle max and sum. Each lane keeps at most
// kMaxM / 32 scores and kMaxH / 32 query and context values in registers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gscan {

constexpr int kMaxH = 128;  // widest projected query the lanes hold
constexpr int kMaxM = 64;   // most keys per row
constexpr int kGroup = 4;   // keys in flight per warp (divides 32)

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

// All 32 lanes of the warp must call this with the same arguments.
// pq and ctx are strided (stride 1 in global memory, R in the decode block's
// feature-major shared buffers); keys, mask, ew and weights are contiguous.
// mask may be null (every key valid), and so may weights (not stored).
__device__ __forceinline__ void attend_row(
    const float* pq, int pq_stride, const float* __restrict__ keys,
    const float* __restrict__ mask, const float* __restrict__ ew, int M,
    int H, float* ctx, int ctx_stride, float* __restrict__ weights) {
  constexpr int NH = kMaxH / 32;
  constexpr int NM = kMaxM / 32;
  const int lane = threadIdx.x & 31;

  float q[NH], e[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int h = lane + 32 * i;
    q[i] = h < H ? pq[h * pq_stride] : 0.f;
    e[i] = h < H ? ew[h] : 0.f;
  }

  // Scores: lane (m % 32) keeps score m in s[m / 32]. Keys go kGroup at a
  // time, so that their loads and warp reductions overlap.
  float s[NM];
#pragma unroll
  for (int j = 0; j < NM; ++j) s[j] = -INFINITY;
  for (int m0 = 0; m0 < M; m0 += kGroup) {
    float p[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      p[g] = 0.f;
      if (m0 + g < M) {
        const float* k = keys + (size_t)(m0 + g) * H;
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const int h = lane + 32 * i;
          if (h < H) p[g] = fmaf(tanhf(q[i] + k[h]), e[i], p[g]);
        }
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        p[g] += __shfl_xor_sync(0xffffffffu, p[g], offset);
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int m = m0 + g;
      if (m < M && mask != nullptr && !(mask[m] > 0.f)) p[g] = -1e9f;
#pragma unroll
      for (int j = 0; j < NM; ++j)  // register-indexed store of s[m / 32]
        if (m < M && (m >> 5) == j && lane == (m & 31)) s[j] = p[g];
    }
  }

  // Stable softmax over the M scores.
  float mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < NM; ++j) mx = fmaxf(mx, s[j]);
  mx = warp_max(mx);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    s[j] = (32 * j + lane < M) ? expf(s[j] - mx) : 0.f;
    sum += s[j];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int j = 0; j < NM; ++j) {
    s[j] = s[j] / sum;
    const int m = 32 * j + lane;
    if (weights != nullptr && m < M) weights[m] = s[j];
  }

  // Context: the weighted sum of the key rows, kGroup rows at a time.
  float acc[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) acc[i] = 0.f;
  for (int m0 = 0; m0 < M; m0 += kGroup) {
    float w[kGroup], kv[kGroup][NH];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      const int m = m0 + g;
      float owner = 0.f;  // s[m / 32], picked without a dynamic index
#pragma unroll
      for (int j = 0; j < NM; ++j)
        if ((m >> 5) == j) owner = s[j];
      w[g] = __shfl_sync(0xffffffffu, owner, m & 31);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int h = lane + 32 * i;
        kv[g][i] = (m < M && h < H) ? keys[(size_t)m * H + h] : 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (m0 + g < M) {
#pragma unroll
        for (int i = 0; i < NH; ++i) acc[i] = fmaf(w[g], kv[g][i], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int h = lane + 32 * i;
    if (h < H) ctx[h * ctx_stride] = acc[i];
  }
}

}  // namespace gscan
