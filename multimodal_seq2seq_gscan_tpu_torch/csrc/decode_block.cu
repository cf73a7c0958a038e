// Kernel 2: K greedy decoder steps per launch (the fused decode block).
//
// Replaces the TPU kernel multimodal_seq2seq_gscan_tpu/ops/pallas_decoder.py
// (fused_decode_block, body _make_kernel). Per step, for every batch row that
// has not emitted EOS: one-hot embedding, masked textual attention over the
// projected command keys, the conditional visual query tanh([h; ctx] W + b),
// unmasked visual attention over the projected grid keys, the LSTM cell
// (gates i, f, g, o with b_ih + b_hh folded), the bias-free two-matmul output
// head, argmax (first maximum wins) and the EOS/done freeze. It writes the
// per-step tokens, emitted flags and both attention rows, and the carried
// h, c, tokens and done.
//
// Bound on the H100: operations. A row-step is ~0.5 MFLOP (products with the
// ~1 MB of decoder weights plus 52 x 100 attention terms) against ~21 KB of
// keys read, so the f32 CUDA-core rate bounds a block launch, not HBM.
// Design: one CTA owns R = 16 batch rows for all K steps; it never talks to
// another CTA (no grid sync, no atomics, no flags; grid = ceil(B / R)).
// The R rows' h, c, embedding, both contexts, queries, new h and head input
// live in shared memory, feature-major ([feature][R]), so a weight element
// read from L2 (the weights stay resident there) feeds a group's R / 4 rows
// through one broadcast float4 read of the activations, and the CTA's other
// groups mostly find it in L1. Threads run over output features:
// the CTA's four groups of 128 threads take R / 4 rows each, and thread u of
// a group owns hidden unit u for its rows, computing its four gate columns in
// registers and the cell, so gate pre-activations never leave registers.
// Each output sums its inputs in one thread, in order. The step is bound by
// latency (weight loads from L2, key loads from HBM), so the groups are there
// to put 16 warps per CTA in flight: measured on the H100, two groups of 8
// rows took 1.46x the time of four groups of 4 for a K=32 launch
// (chip_smoke.py, B=4096). Attention
// rows go one warp per row (attend.cuh); the projected keys are read from
// global memory every step.
#include "attend.cuh"

namespace {

constexpr int R = 16;           // batch rows per CTA
constexpr int kParts = 4;       // thread groups, each for R / kParts rows
constexpr int RH = R / kParts;  // rows per group
constexpr int kGroupThreads = 128;  // threads per group
constexpr int kThreads = kParts * kGroupThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kBuffers = 9;   // [H][R] shared buffers, see the kernel
static_assert(RH % 4 == 0, "rows are read as float4");

struct DecoderWeights {
  const float* txt_qw;    // [H, H]
  const float* txt_ew;    // [H]
  const float* q2k_w;     // [2H, H]
  const float* q2k_b;     // [H]
  const float* vis_qw;    // [H, H]
  const float* vis_ew;    // [H]
  const float* emb;       // [V, H], pad row zeroed
  const float* w_ih;      // [3H, 4H] (transposed LSTM input weights)
  const float* w_hh;      // [H, 4H]
  const float* bias;      // [4H] = b_ih + b_hh
  const float* out_w;     // [4H, H]
  const float* out_proj;  // [H, V]
};

// acc[n][r] += sum_k xs[k][r] * W[k][col0 + n * col_stride] for k < K and
// the RH rows from xs on. xs points into a feature-major [K][R] shared
// buffer; W is row-major with leading dim ldw.
template <int NC>
__device__ __forceinline__ void accum(float (&acc)[NC][RH],
                                      const float* xs,
                                      const float* __restrict__ W, int ldw,
                                      int col0, int col_stride, int K) {
  // Unrolled so that several weight loads from L2 are in flight at once.
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float w[NC];
#pragma unroll
    for (int n = 0; n < NC; ++n)
      w[n] = __ldg(W + (size_t)k * ldw + col0 + n * col_stride);
    const float4* x4 = reinterpret_cast<const float4*>(xs + k * R);
#pragma unroll
    for (int q = 0; q < RH / 4; ++q) {
      const float4 v = x4[q];
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        acc[n][4 * q + 0] = fmaf(v.x, w[n], acc[n][4 * q + 0]);
        acc[n][4 * q + 1] = fmaf(v.y, w[n], acc[n][4 * q + 1]);
        acc[n][4 * q + 2] = fmaf(v.z, w[n], acc[n][4 * q + 2]);
        acc[n][4 * q + 3] = fmaf(v.w, w[n], acc[n][4 * q + 3]);
      }
    }
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[NC][RH]) {
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int r = 0; r < RH; ++r) acc[n][r] = 0.f;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kThreads) decode_block_kernel(
    const float* __restrict__ proj_txt, const float* __restrict__ cmd_mask,
    const float* __restrict__ proj_vis, const float* __restrict__ h_in,
    const float* __restrict__ c_in, const int* __restrict__ tok_in,
    const unsigned char* __restrict__ done_in, DecoderWeights wt,
    float* __restrict__ h_out, float* __restrict__ c_out,
    int* __restrict__ tok_out, unsigned char* __restrict__ done_out,
    int* __restrict__ step_tokens, float* __restrict__ step_emitted,
    float* __restrict__ step_attn_cmd, float* __restrict__ step_attn_sit,
    int B, int Mt, int Mv, int H, int V, int K, int eos) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int HR = H * R;
  float* s_h = smem;            // carried hidden state
  float* s_c = s_h + HR;        // carried cell state
  float* s_emb = s_c + HR;      // embedded previous token
  float* s_ctxc = s_emb + HR;   // textual context
  float* s_ctxs = s_ctxc + HR;  // visual context
  float* s_hn = s_ctxs + HR;    // new hidden state (before the done freeze)
  float* s_pq = s_hn + HR;      // projected query (textual, then visual)
  float* s_vq = s_pq + HR;      // visual query
  float* s_pre = s_vq + HR;     // head's hidden layer
  float* s_logits = s_pre + HR;                       // [R][V]
  int* s_tok = reinterpret_cast<int*>(s_logits + R * V);
  int* s_done = s_tok + R;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r0 = (tid / kGroupThreads) * RH;  // first row of this thread's group
  const int lane_u = tid % kGroupThreads;     // first hidden unit of this thread
  const int b0 = blockIdx.x * R;
  const int rows = min(R, B - b0);

  for (int i = tid; i < kBuffers * HR; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < HR; i += kThreads) {
    const int u = i / R, r = i % R;
    if (r < rows) {
      s_h[i] = h_in[(size_t)(b0 + r) * H + u];
      s_c[i] = c_in[(size_t)(b0 + r) * H + u];
    }
  }
  if (tid < R) {
    s_tok[tid] = tid < rows ? tok_in[b0 + tid] : 0;
    s_done[tid] = tid < rows ? (done_in[b0 + tid] != 0) : 1;
  }
  __syncthreads();

  for (int t = 0; t < K; ++t) {
    // Embedding of the previous token, and the textual query W_q h.
    for (int i = tid; i < HR; i += kThreads)
      s_emb[i] = wt.emb[(size_t)s_tok[i % R] * H + i / R];
    for (int u = lane_u; u < H; u += kGroupThreads) {
      float acc[1][RH];
      zero(acc);
      accum(acc, s_h + r0, wt.txt_qw, H, u, 0, H);
#pragma unroll
      for (int r = 0; r < RH; ++r) s_pq[u * R + r0 + r] = acc[0][r];
    }
    __syncthreads();

    // Masked textual attention, one warp per row.
    for (int r = warp; r < rows; r += kWarps) {
      const size_t b = b0 + r;
      gscan::attend_row(s_pq + r, R, proj_txt + b * Mt * H, cmd_mask + b * Mt,
                        wt.txt_ew, Mt, H, s_ctxc + r, R,
                        step_attn_cmd + ((size_t)t * B + b) * Mt);
    }
    __syncthreads();

    // Conditional visual query tanh([h; ctx_cmd] W + b).
    for (int u = lane_u; u < H; u += kGroupThreads) {
      float acc[1][RH];
      zero(acc);
      accum(acc, s_h + r0, wt.q2k_w, H, u, 0, H);
      accum(acc, s_ctxc + r0, wt.q2k_w + (size_t)H * H, H, u, 0, H);
      const float bias = wt.q2k_b[u];
#pragma unroll
      for (int r = 0; r < RH; ++r)
        s_vq[u * R + r0 + r] = tanhf(acc[0][r] + bias);
    }
    __syncthreads();

    // Projected visual query.
    for (int u = lane_u; u < H; u += kGroupThreads) {
      float acc[1][RH];
      zero(acc);
      accum(acc, s_vq + r0, wt.vis_qw, H, u, 0, H);
#pragma unroll
      for (int r = 0; r < RH; ++r) s_pq[u * R + r0 + r] = acc[0][r];
    }
    __syncthreads();

    // Unmasked visual attention, one warp per row.
    for (int r = warp; r < rows; r += kWarps) {
      const size_t b = b0 + r;
      gscan::attend_row(s_pq + r, R, proj_vis + b * Mv * H, nullptr,
                        wt.vis_ew, Mv, H, s_ctxs + r, R,
                        step_attn_sit + ((size_t)t * B + b) * Mv);
    }
    __syncthreads();

    // LSTM gates and cell: thread u owns hidden unit u (gate columns
    // u, H + u, 2H + u, 3H + u) for its group's rows. c is frozen for done
    // rows.
    const int G = 4 * H;
    for (int u = lane_u; u < H; u += kGroupThreads) {
      float acc[4][RH];
      zero(acc);
      accum(acc, s_emb + r0, wt.w_ih, G, u, H, H);
      accum(acc, s_ctxc + r0, wt.w_ih + (size_t)H * G, G, u, H, H);
      accum(acc, s_ctxs + r0, wt.w_ih + (size_t)2 * H * G, G, u, H, H);
      accum(acc, s_h + r0, wt.w_hh, G, u, H, H);
      const float bi = wt.bias[u], bf = wt.bias[H + u];
      const float bg = wt.bias[2 * H + u], bo = wt.bias[3 * H + u];
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        const float c_old = s_c[u * R + r0 + r];
        const float c_new = sigmoidf(acc[1][r] + bf) * c_old +
                            sigmoidf(acc[0][r] + bi) * tanhf(acc[2][r] + bg);
        s_hn[u * R + r0 + r] = sigmoidf(acc[3][r] + bo) * tanhf(c_new);
        if (!s_done[r0 + r]) s_c[u * R + r0 + r] = c_new;
      }
    }
    __syncthreads();

    // Head's hidden layer [emb; h_new; ctx_cmd; ctx_sit] W_out, and the
    // carried h (frozen for done rows). Nothing here reads s_h.
    for (int u = lane_u; u < H; u += kGroupThreads) {
      float acc[1][RH];
      zero(acc);
      accum(acc, s_emb + r0, wt.out_w, H, u, 0, H);
      accum(acc, s_hn + r0, wt.out_w + (size_t)H * H, H, u, 0, H);
      accum(acc, s_ctxc + r0, wt.out_w + (size_t)2 * H * H, H, u, 0, H);
      accum(acc, s_ctxs + r0, wt.out_w + (size_t)3 * H * H, H, u, 0, H);
#pragma unroll
      for (int r = 0; r < RH; ++r) {
        s_pre[u * R + r0 + r] = acc[0][r];
        if (!s_done[r0 + r]) s_h[u * R + r0 + r] = s_hn[u * R + r0 + r];
      }
    }
    __syncthreads();

    // Logits, one (row, token) pair per thread.
    for (int i = tid; i < R * V; i += kThreads) {
      const int r = i / V, v = i % V;
      float a = 0.f;
      for (int k = 0; k < H; ++k)
        a = fmaf(s_pre[k * R + r], __ldg(wt.out_proj + (size_t)k * V + v), a);
      s_logits[i] = a;
    }
    __syncthreads();

    // Argmax (first maximum wins) and the EOS bookkeeping.
    if (tid < rows) {
      const float* lg = s_logits + tid * V;
      int best = 0;
      float best_value = lg[0];
      for (int v = 1; v < V; ++v)
        if (lg[v] > best_value) {
          best_value = lg[v];
          best = v;
        }
      const bool emitting = !s_done[tid];
      const size_t o = (size_t)t * B + b0 + tid;
      step_tokens[o] = emitting ? best : 0;
      step_emitted[o] = emitting ? 1.f : 0.f;
      if (emitting) s_tok[tid] = best;
      s_done[tid] = s_done[tid] || best == eos;
    }
    __syncthreads();
  }

  for (int i = tid; i < HR; i += kThreads) {
    const int u = i / R, r = i % R;
    if (r < rows) {
      h_out[(size_t)(b0 + r) * H + u] = s_h[i];
      c_out[(size_t)(b0 + r) * H + u] = s_c[i];
    }
  }
  if (tid < rows) {
    tok_out[b0 + tid] = s_tok[tid];
    done_out[b0 + tid] = static_cast<unsigned char>(s_done[tid]);
  }
}

}  // namespace

extern "C" int gscan_decode_block(
    const float* proj_txt, const float* cmd_mask, const float* proj_vis,
    const float* h_in, const float* c_in, const int* tok_in,
    const unsigned char* done_in, const float* txt_qw, const float* txt_ew,
    const float* q2k_w, const float* q2k_b, const float* vis_qw,
    const float* vis_ew, const float* emb, const float* w_ih,
    const float* w_hh, const float* bias, const float* out_w,
    const float* out_proj, float* h_out, float* c_out, int* tok_out,
    unsigned char* done_out, int* step_tokens, float* step_emitted,
    float* step_attn_cmd, float* step_attn_sit, int B, int Mt, int Mv, int H,
    int V, int K, int eos, void* stream) {
  if (B <= 0 || K <= 0 || V <= 0 || H <= 0 || H > gscan::kMaxH || Mt <= 0 ||
      Mt > gscan::kMaxM || Mv <= 0 || Mv > gscan::kMaxM)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      ((size_t)kBuffers * H * R + (size_t)R * V + 2 * R) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      decode_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecoderWeights wt{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew,
                          emb,    w_ih,   w_hh,  bias,  out_w,  out_proj};
  const dim3 grid((B + R - 1) / R);
  decode_block_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      proj_txt, cmd_mask, proj_vis, h_in, c_in, tok_in, done_in, wt, h_out,
      c_out, tok_out, done_out, step_tokens, step_emitted, step_attn_cmd,
      step_attn_sit, B, Mt, Mv, H, V, K, eos);
  return static_cast<int>(cudaGetLastError());
}
