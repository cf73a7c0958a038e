// Kernel 1: fused masked additive attention, forward.
//
// Replaces the TPU kernel multimodal_seq2seq_gscan_tpu/ops/pallas_attention.py
// (fused_additive_attention, body _attention_kernel). Inputs: projected
// queries pq [B, H], projected keys K [B, M, H] (also the values), an optional
// float mask [B, M] and the energy vector ew [H]; outputs the context [B, H]
// and the weights [B, M], all float32.
//
// Bound on the H100: bytes. Each key element is read for its score and again
// for the context, with about six flops between the two reads, far below the
// card's ~20 flops per byte of f32 balance. The design keeps the [B, M, H]
// tanh intermediate out of device memory (it lives in registers, one warp per
// row, lanes over H so key rows are read coalesced) and re-reads the row's
// keys for the context from L1/L2 rather than from device memory.
#include "attend.cuh"

namespace {

constexpr int kWarps = 4;  // rows per block

__global__ void __launch_bounds__(kWarps * 32) additive_attention_kernel(
    const float* __restrict__ pq, const float* __restrict__ keys,
    const float* __restrict__ mask, const float* __restrict__ ew,
    float* __restrict__ ctx, float* __restrict__ weights, int B, int M,
    int H) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= B) return;  // the whole warp leaves together
  gscan::attend_row(pq + (size_t)row * H, 1, keys + (size_t)row * M * H,
                    mask != nullptr ? mask + (size_t)row * M : nullptr, ew, M,
                    H, ctx + (size_t)row * H, 1, weights + (size_t)row * M);
}

}  // namespace

extern "C" const char* gscan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int gscan_additive_attention(const float* pq, const float* keys,
                                        const float* mask, const float* ew,
                                        float* ctx, float* weights, int B,
                                        int M, int H, void* stream) {
  if (B <= 0 || M <= 0 || M > gscan::kMaxM || H <= 0 || H > gscan::kMaxH)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kWarps - 1) / kWarps);
  additive_attention_kernel<<<grid, kWarps * 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      pq, keys, mask, ew, ctx, weights, B, M, H);
  return static_cast<int>(cudaGetLastError());
}
