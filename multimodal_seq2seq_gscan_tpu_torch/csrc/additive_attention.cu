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
//
// The bf16 form (gscan_additive_attention_bf16) takes bf16 keys with
// float32 or bf16 queries, energy vector and mask, and computes and writes
// as the float32 form does (the TPU kernel's outputs are float32 whatever
// its inputs): each key feature widens to float32 in registers, so the
// bytes read from the keys halve and the arithmetic is the float32 form's.
// A lane loads 8 features (16 bytes) of a key row at a time, or 4 (8
// bytes) where that pads H to fewer features per warp (H <= 128: at 8 a
// lane, 12.5 of the 32 lanes would hold H = 100 and every key would take
// twice the tanh issue slots).
#include "attend.cuh"

namespace {

constexpr int kRowsPerBlock = 8;  // warps per CTA, one row each
// Scores staged in shared memory up to the default 48 KB per CTA, else in
// the weights output.
constexpr size_t kScoreBytes = 48 * 1024;

// NC: attend.cuh's chunks of 32 F::V features (0: attend_row_wide).
template <int NC, typename F>
__global__ void __launch_bounds__(kRowsPerBlock * 32) additive_attention_kernel(
    const typename F::ST* __restrict__ pq,
    const typename F::KT* __restrict__ keys,
    const typename F::ST* __restrict__ mask,
    const typename F::ST* __restrict__ ew, float* __restrict__ ctx,
    float* __restrict__ weights, int B, int M, int H, bool vec,
    bool staged) {
  extern __shared__ float s_scores[];
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= B) return;  // the whole warp leaves together
  float* w = weights + (size_t)row * M;
  const typename F::ST* row_mask =
      mask != nullptr ? mask + (size_t)row * M : nullptr;
  float* scores = staged ? s_scores + warp * M : w;
  if constexpr (NC == 0)
    gscan::attend_row_wide<F>(pq + (size_t)row * H, 1,
                              keys + (size_t)row * M * H, row_mask, ew, M, H,
                              ctx + (size_t)row * H, 1, w, scores, vec);
  else
    gscan::attend_row<NC, F>(pq + (size_t)row * H, 1,
                             keys + (size_t)row * M * H, row_mask, ew, M, H,
                             ctx + (size_t)row * H, 1, w, scores, vec);
}

// One launch of form F: a warp per row, the chunk count from H.
template <typename F>
int launch(const void* pq, const void* keys, const void* mask,
           const void* ew, float* ctx, float* weights, int B, int M, int H,
           bool vec, cudaStream_t st) {
  using ST = typename F::ST;
  using KT = typename F::KT;
  const dim3 grid((B + kRowsPerBlock - 1) / kRowsPerBlock);
  auto kernel = additive_attention_kernel<0, F>;
  switch (gscan::attend_chunks<F::V>(H)) {
    case 1: kernel = additive_attention_kernel<1, F>; break;
    case 2: kernel = additive_attention_kernel<2, F>; break;
    case 4: kernel = additive_attention_kernel<4, F>; break;
    case 8:
      if constexpr (8 * F::V <= gscan::kLaneFeatures)
        kernel = additive_attention_kernel<8, F>;
      break;
  }
  const size_t score_bytes = (size_t)kRowsPerBlock * M * sizeof(float);
  const bool staged = score_bytes <= kScoreBytes;
  kernel<<<grid, kRowsPerBlock * 32, staged ? score_bytes : 0, st>>>(
      static_cast<const ST*>(pq), static_cast<const KT*>(keys),
      static_cast<const ST*>(mask), static_cast<const ST*>(ew), ctx, weights,
      B, M, H, vec, staged);
  return static_cast<int>(cudaGetLastError());
}

// Features a lane of the bf16 form loads at a time: 8 (16 bytes), or 4 (8
// bytes) where 4 pads H to fewer features per warp.
int bf16_lane_features(int H) {
  const int c4 = gscan::attend_chunks<4>(H), c8 = gscan::attend_chunks<8>(H);
  if (c4 == 0 || c8 == 0) return 8;  // attend_row_wide either way
  return 4 * c4 < 8 * c8 ? 4 : 8;
}

template <typename ST>
int launch_bf16(const void* pq, const void* keys, const void* mask,
                const void* ew, float* ctx, float* weights, int B, int M,
                int H, cudaStream_t st) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(keys);
  if (bf16_lane_features(H) == 4)
    return launch<gscan::Form<__nv_bfloat16, ST, 4>>(
        pq, keys, mask, ew, ctx, weights, B, M, H,
        H % 4 == 0 && base % 8 == 0, st);
  return launch<gscan::Form<__nv_bfloat16, ST, 8>>(
      pq, keys, mask, ew, ctx, weights, B, M, H,
      H % 8 == 0 && base % 16 == 0, st);
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
  return launch<gscan::F32>(pq, keys, mask, ew, ctx, weights, B, M, H,
                            vec != 0, static_cast<cudaStream_t>(stream));
}

// The bf16 form: keys bf16; pq, mask (nullable) and ew bf16 when
// small_bf16, else float32; ctx and weights float32.
extern "C" int gscan_additive_attention_bf16(const void* pq, const void* keys,
                                             const void* mask, const void* ew,
                                             float* ctx, float* weights,
                                             int B, int M, int H,
                                             int small_bf16, void* stream) {
  if (B <= 0 || M <= 0 || H <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (small_bf16)
    return launch_bf16<__nv_bfloat16>(pq, keys, mask, ew, ctx, weights, B, M,
                                      H, st);
  return launch_bf16<float>(pq, keys, mask, ew, ctx, weights, B, M, H, st);
}
