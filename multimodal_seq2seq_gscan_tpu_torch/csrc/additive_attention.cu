// Kernel 1: fused masked additive attention, forward.
//
// Replaces the TPU kernel multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py
// (fused_additive_attention, body _attention_kernel). Inputs: projected
// queries pq [B, H], projected keys K [B, M, H] (also the values), an optional
// float mask [B, M] and the energy vector ew [H]; outputs the context [B, H]
// and the weights [B, M], all float32.
//
// Bound on the H100: bytes. Each key element takes about six flops, far
// below the card's ~20 flops per byte of f32 balance. The design reads each
// key byte from device memory once (attend.cuh: one pass, the score and the
// context from the same registers by an online softmax), 16 bytes per lane,
// keeps the [B, M, H] tanh intermediate in registers, skips the tanh terms
// of masked keys where a row has a valid key (their weight is exactly 0),
// and puts many rows in flight: one warp per row, kRowsPerBlock
// rows per CTA, each warp with two groups of keys in flight (8 keys, 3.2 KB
// at H = 100), its scores staged in shared memory. Past H = 1024 the
// query and context leave the registers: a row takes two passes over its
// keys (attend_row_wide), any H. Measured on
// the H100 (PERF.md), the two calls of a decoder step are bound about as
// much by the issue of the tanh terms as by the bytes.
#include "attend.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // warps per CTA, one row each
// Scores staged in shared memory up to the default 48 KB per CTA, else in
// the weights output.
constexpr size_t kScoreBytes = 48 * 1024;

// NC: attend.cuh's chunks of 128 features (0: attend_row_wide).
template <int NC>
__global__ void __launch_bounds__(kRowsPerBlock * 32) additive_attention_kernel(
    const float* __restrict__ pq, const float* __restrict__ keys,
    const float* __restrict__ mask, const float* __restrict__ ew,
    float* __restrict__ ctx, float* __restrict__ weights, int B, int M,
    int H, bool vec, bool staged) {
  extern __shared__ float s_scores[];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= B) return;  // the whole warp leaves together
  float* w = weights + (size_t)row * M;
  const float* row_mask = mask != nullptr ? mask + (size_t)row * M : nullptr;
  float* scores = staged ? s_scores + warp * M : w;
  if constexpr (NC == 0)
    gscan::attend_row_wide(pq + (size_t)row * H, 1,
                           keys + (size_t)row * M * H, row_mask, ew, M, H,
                           ctx + (size_t)row * H, 1, w, scores, vec);
  else
    gscan::attend_row<NC>(pq + (size_t)row * H, 1,
                          keys + (size_t)row * M * H, row_mask, ew, M, H,
                          ctx + (size_t)row * H, 1, w, scores, vec);
}

}  // namespace

extern "C" const char* gscan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vec: H % 4 == 0 and keys 16-byte aligned (checked by the wrapper).
extern "C" int gscan_additive_attention(const float* pq, const float* keys,
                                        const float* mask, const float* ew,
                                        float* ctx, float* weights, int B,
                                        int M, int H, int vec, void* stream) {
  if (B <= 0 || M <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto kernel = additive_attention_kernel<0>;
  switch (gscan::attend_chunks(H)) {
    case 1: kernel = additive_attention_kernel<1>; break;
    case 2: kernel = additive_attention_kernel<2>; break;
    case 4: kernel = additive_attention_kernel<4>; break;
    case 8: kernel = additive_attention_kernel<8>; break;
  }
  const size_t score_bytes = (size_t)kRowsPerBlock * M * sizeof(float);
  const bool staged = score_bytes <= kScoreBytes;
  kernel<<<grid, kRowsPerBlock * 32, staged ? score_bytes : 0, st>>>(
      pq, keys, mask, ew, ctx, weights, B, M, H, vec != 0, staged);
  return static_cast<int>(cudaGetLastError());
}
