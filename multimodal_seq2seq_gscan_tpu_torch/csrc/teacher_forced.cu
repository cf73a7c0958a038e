// Kernels 3 and 4: the teacher-forced decoder unroll, forward and backward,
// and the helper kernel that forms kernel 4's weight gradients.
//
// Replace the TPU kernels multimodal_seq2seq_gscan_tpu/ops/
// pallas_teacher_forced.py: _forward_impl (kernel 3, body _make_fwd_kernel,
// step math _step_forward) and _backward_impl (kernel 4, body
// _make_bwd_kernel). All float32.
//
// Kernel 3: per step, for every batch row: the teacher token's embedding
// (one-hot semantics: an out-of-range token embeds to 0) times the [T, B, E]
// dropout mask, masked textual attention, the conditional visual query
// tanh([h; ctx] W + b), unmasked visual attention, the LSTM cell (i, f, g, o,
// b_ih + b_hh folded), the bias-free two-matmul head. It stashes the
// pre-step (h, c) to h_res / c_res, writes the logits of every step and sums
// the visual attention over t < num_steps.
//
// Kernel 4: per step in reverse, recompute the step from (h_res, c_res),
// then backpropagate through the head, the cell and both attentions with
// the TPU kernel's math. The per-row gradients (d_proj_txt, d_proj_vis, dh,
// dc) belong to the CTA that owns the row. The weight gradients are sums
// over rows and steps: kernel 4 writes every row-step's operands (the X and
// dY of each X^T dY) to a stash in device memory, and the helper kernel
// (weight_grads_kernel) forms the sums, each output by one thread in a fixed
// order. No atomics anywhere, so every output is bit-identical from run to
// run. The stash layout is ops/teacher_forced.py's StashLayout.
//
// Bound on the H100: operations (a row-step is ~0.5 MFLOP; kernel 4 about
// three times kernel 3), but the T-step chain makes both recurrent kernels
// latency-bound: each step is a chain of small products whose weights
// (~1 MB) come from L2. Design, as kernel 2's: one CTA owns R batch rows
// for all T steps (no communication between CTAs; grid = ceil(B / R)); the
// rows' activations live in shared memory feature-major ([feature][R]), so
// one weight element read from L2 feeds the R rows through float4 reads of
// shared memory; a thread owns one output column of a product for the R
// rows and sums its inputs in a fixed order, in two chains (even and odd
// inputs; see accum). Attention rows go one warp per row
// (attend.cuh forward, attend_row_backward below). R = 4: at the training
// batch of 200 that gives 50 CTAs (R = 16, kernel 2's, gives 13; R = 8 was
// measured 1.3x slower for both kernels, PERF.md).
#include "attend.cuh"

namespace {

constexpr int R = 4;  // batch rows per CTA
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Weights {
  const float* txt_qw;    // [H, H]
  const float* txt_ew;    // [H]
  const float* q2k_w;     // [2H, H]
  const float* q2k_b;     // [H]
  const float* vis_qw;    // [H, H]
  const float* vis_ew;    // [H]
  const float* emb;       // [V, E], pad row zeroed
  const float* w_ih;      // [E + 2H, 4H] (transposed LSTM input weights)
  const float* w_hh;      // [H, 4H]
  const float* bias;      // [4H] = b_ih + b_hh
  const float* out_w;     // [E + 3H, H]
  const float* out_proj;  // [H, V]
};

// The transposed weights of the backward's products.
struct Transposed {
  const float* txt_qw;    // [H, H]
  const float* q2k_w;     // [H, 2H]
  const float* vis_qw;    // [H, H]
  const float* w_ih;      // [4H, E + 2H]
  const float* w_hh;      // [4H, H]
  const float* out_w;     // [H, E + 3H]
  const float* out_proj;  // [V, H]
};

// Column offsets of a row-step in the stash (ops/teacher_forced.py).
struct Stash {
  int onehot, emb, h_new, ctx_cmd, ctx_sit, ph, vq, d_ph, d_gates, d_pq_vis,
      d_joint, d_pq_txt, d_emb, g_vis_ew, g_txt_ew, width;
  __host__ __device__ Stash(int V, int E, int H)
      : onehot(0), emb(V), h_new(V + E), ctx_cmd(V + E + H),
        ctx_sit(V + E + 2 * H), ph(V + E + 3 * H), vq(V + E + 4 * H),
        d_ph(V + E + 5 * H), d_gates(V + E + 6 * H),
        d_pq_vis(V + E + 10 * H), d_joint(V + E + 11 * H),
        d_pq_txt(V + E + 12 * H), d_emb(V + E + 13 * H),
        g_vis_ew(V + 2 * E + 13 * H), g_txt_ew(V + 2 * E + 14 * H),
        width(V + 2 * E + 15 * H) {}
};

__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
}

__device__ __forceinline__ void fma4(float (&acc)[R], const float* x,
                                     float w) {
  static_assert(R == 4, "one float4 of rows");
  const float4 v = *reinterpret_cast<const float4*>(x);
  acc[0] = fmaf(v.x, w, acc[0]);
  acc[1] = fmaf(v.y, w, acc[1]);
  acc[2] = fmaf(v.z, w, acc[2]);
  acc[3] = fmaf(v.w, w, acc[3]);
}

constexpr int kBatch = 8;  // weight loads issued together

// acc[r] += sum_k xs[k][r] * W[k][col] for k < K, over the R rows of a
// feature-major [K][R] shared buffer; W is row-major with leading dim ldw.
// kBatch weights are loaded before they are used. The even and the odd k
// are summed in two chains, added at the end: each float32 chain is half as
// long (less rounding), and the two run in parallel.
__device__ __forceinline__ void accum(float (&acc)[R], const float* xs,
                                      const float* __restrict__ W, int ldw,
                                      int col, int K) {
  float odd[R];
  zero(odd);
  int k = 0;
  for (; k + kBatch <= K; k += kBatch) {
    float w[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      w[i] = __ldg(W + (size_t)(k + i) * ldw + col);
#pragma unroll
    for (int i = 0; i < kBatch; i += 2) {
      fma4(acc, xs + (k + i) * R, w[i]);
      fma4(odd, xs + (k + i + 1) * R, w[i + 1]);
    }
  }
  for (; k + 1 < K; k += 2) {
    fma4(acc, xs + k * R, __ldg(W + (size_t)k * ldw + col));
    fma4(odd, xs + (k + 1) * R, __ldg(W + (size_t)(k + 1) * ldw + col));
  }
  if (k < K) fma4(acc, xs + k * R, __ldg(W + (size_t)k * ldw + col));
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] += odd[r];
}

// sum_k x[k * R] * W[k * ldw] for k < K (one row, one output column), in
// the order of accum.
__device__ __forceinline__ float dot(const float* x,
                                     const float* __restrict__ W, int ldw,
                                     int K) {
  float even = 0.f, odd = 0.f;
  int k = 0;
  for (; k + kBatch <= K; k += kBatch) {
    float w[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) w[i] = __ldg(W + (size_t)(k + i) * ldw);
#pragma unroll
    for (int i = 0; i < kBatch; i += 2) {
      even = fmaf(x[(k + i) * R], w[i], even);
      odd = fmaf(x[(k + i + 1) * R], w[i + 1], odd);
    }
  }
  for (; k + 1 < K; k += 2) {
    even = fmaf(x[k * R], __ldg(W + (size_t)k * ldw), even);
    odd = fmaf(x[(k + 1) * R], __ldg(W + (size_t)(k + 1) * ldw), odd);
  }
  if (k < K) even = fmaf(x[k * R], __ldg(W + (size_t)k * ldw), even);
  return even + odd;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Shared state of one decoder step's forward for R rows, carved from the
// dynamic shared memory. emb, ctx_cmd and ctx_sit are contiguous: together
// they are the LSTM input.
struct StepBuffers {
  float *h, *c, *emb, *ctx_cmd, *ctx_sit, *pq_txt, *vq, *pq_vis, *gates,
      *h_new, *ph, *w_txt, *w_vis;
  __device__ float* carve(float* p, int H, int E, int Mt, int Mv) {
    h = p;                  p += H * R;
    c = p;                  p += H * R;
    emb = p;                p += E * R;
    ctx_cmd = p;            p += H * R;
    ctx_sit = p;            p += H * R;
    pq_txt = p;             p += H * R;
    vq = p;                 p += H * R;
    pq_vis = p;             p += H * R;
    gates = p;              p += 4 * H * R;
    h_new = p;              p += H * R;
    ph = p;                 p += H * R;
    w_txt = p;              p += Mt * R;  // [R][Mt] attention weights
    w_vis = p;              p += Mv * R;  // [R][Mv]
    return p;
  }
  __host__ __device__ static size_t floats(int H, int E, int Mt, int Mv) {
    return (size_t)(13 * H + E + Mt + Mv) * R;
  }
};

// One teacher-forced step's forward for the CTA's R rows, from the state in
// b.h / b.c (left unchanged; the new state goes to b.h_new and b.c_new
// through c_new). Ends with the head's hidden layer in b.ph. Every phase
// ends with __syncthreads().
__device__ void step_forward(const StepBuffers& b, float* c_new,
                             const int* __restrict__ tokens,
                             const float* __restrict__ drop,
                             const float* __restrict__ proj_txt,
                             const float* __restrict__ cmd_mask,
                             const float* __restrict__ proj_vis,
                             const Weights& wt, size_t tb, int b0, int rows,
                             int Mt, int Mv, int H, int E, int V) {
  const int tid = threadIdx.x, warp = tid >> 5;
  // The teacher token's embedding times the dropout mask; the textual query.
  for (int i = tid; i < R * E; i += kThreads) {
    const int r = i / E, e = i % E;
    float v = 0.f;
    if (r < rows) {
      const int tok = tokens[tb + r];
      if (tok >= 0 && tok < V)
        v = __ldg(wt.emb + (size_t)tok * E + e) * drop[(tb + r) * E + e];
    }
    b.emb[e * R + r] = v;
  }
  for (int u = tid; u < H; u += kThreads) {
    float acc[R];
    zero(acc);
    accum(acc, b.h, wt.txt_qw, H, u, H);
#pragma unroll
    for (int r = 0; r < R; ++r) b.pq_txt[u * R + r] = acc[r];
  }
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    const size_t row = b0 + r;
    gscan::attend_row(b.pq_txt + r, R, proj_txt + row * Mt * H,
                      cmd_mask + row * Mt, wt.txt_ew, Mt, H, b.ctx_cmd + r, R,
                      b.w_txt + r * Mt);
  }
  __syncthreads();

  for (int u = tid; u < H; u += kThreads) {
    float acc[R];
    zero(acc);
    accum(acc, b.h, wt.q2k_w, H, u, H);
    accum(acc, b.ctx_cmd, wt.q2k_w + (size_t)H * H, H, u, H);
    const float bias = wt.q2k_b[u];
#pragma unroll
    for (int r = 0; r < R; ++r) b.vq[u * R + r] = tanhf(acc[r] + bias);
  }
  __syncthreads();

  for (int u = tid; u < H; u += kThreads) {
    float acc[R];
    zero(acc);
    accum(acc, b.vq, wt.vis_qw, H, u, H);
#pragma unroll
    for (int r = 0; r < R; ++r) b.pq_vis[u * R + r] = acc[r];
  }
  __syncthreads();

  for (int r = warp; r < rows; r += kWarps) {
    const size_t row = b0 + r;
    gscan::attend_row(b.pq_vis + r, R, proj_vis + row * Mv * H, nullptr,
                      wt.vis_ew, Mv, H, b.ctx_sit + r, R, b.w_vis + r * Mv);
  }
  __syncthreads();

  // Gate pre-activations, one column of [E + 2H | H] x 4H per thread.
  const int G = 4 * H;
  for (int j = tid; j < G; j += kThreads) {
    float a[R], h_part[R];
    zero(a);
    zero(h_part);
    accum(a, b.emb, wt.w_ih, G, j, E + 2 * H);
    accum(h_part, b.h, wt.w_hh, G, j, H);
    const float bias = wt.bias[j];
#pragma unroll
    for (int r = 0; r < R; ++r) b.gates[j * R + r] = a[r] + h_part[r] + bias;
  }
  __syncthreads();

  for (int u = tid; u < H; u += kThreads) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float gi = b.gates[u * R + r], gf = b.gates[(H + u) * R + r];
      const float gg = b.gates[(2 * H + u) * R + r];
      const float go = b.gates[(3 * H + u) * R + r];
      const float cn = sigmoidf(gf) * b.c[u * R + r] + sigmoidf(gi) * tanhf(gg);
      c_new[u * R + r] = cn;
      b.h_new[u * R + r] = sigmoidf(go) * tanhf(cn);
    }
  }
  __syncthreads();

  // The head's hidden layer [emb; h_new; ctx_cmd; ctx_sit] W_out.
  for (int u = tid; u < H; u += kThreads) {
    float acc[R];
    zero(acc);
    accum(acc, b.emb, wt.out_w, H, u, E);
    accum(acc, b.h_new, wt.out_w + (size_t)E * H, H, u, H);
    accum(acc, b.ctx_cmd, wt.out_w + (size_t)(E + H) * H, H, u, 2 * H);
#pragma unroll
    for (int r = 0; r < R; ++r) b.ph[u * R + r] = acc[r];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) forward_kernel(
    const int* __restrict__ tokens, const float* __restrict__ drop,
    const float* __restrict__ proj_txt, const float* __restrict__ cmd_mask,
    const float* __restrict__ proj_vis, const float* __restrict__ h0,
    const float* __restrict__ c0, Weights wt, float* __restrict__ logits,
    float* __restrict__ h_res, float* __restrict__ c_res,
    float* __restrict__ asum, int B, int T, int num_steps, int Mt, int Mv,
    int H, int E, int V) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  StepBuffers b;
  float* s_asum = b.carve(smem, H, E, Mt, Mv);  // [R][Mv]
  const size_t total = StepBuffers::floats(H, E, Mt, Mv) + R * Mv;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, B - b0);

  for (size_t i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();
  for (int i = tid; i < R * H; i += kThreads) {
    const int r = i / H, u = i % H;
    if (r < rows) {
      b.h[u * R + r] = h0[(size_t)(b0 + r) * H + u];
      b.c[u * R + r] = c0[(size_t)(b0 + r) * H + u];
    }
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const size_t tb = (size_t)t * B + b0;
    for (int i = tid; i < R * H; i += kThreads) {
      const int r = i / H, u = i % H;
      if (r < rows) {
        h_res[(tb + r) * H + u] = b.h[u * R + r];
        c_res[(tb + r) * H + u] = b.c[u * R + r];
      }
    }
    // Nothing in the step writes b.h or b.c before its last phase reads
    // them; c_new goes straight into b.c in the cell phase, which is the
    // last reader of the old c.
    step_forward(b, b.c, tokens, drop, proj_txt, cmd_mask, proj_vis, wt, tb,
                 b0, rows, Mt, Mv, H, E, V);
    if (t < num_steps) {
      for (int r = warp; r < rows; r += kWarps)
        for (int m = lane; m < Mv; m += 32)
          s_asum[r * Mv + m] += b.w_vis[r * Mv + m];
    }
    for (int i = tid; i < H * R; i += kThreads) b.h[i] = b.h_new[i];
    for (int i = tid; i < R * V; i += kThreads) {
      const int r = i / V, v = i % V;
      if (r < rows) {
        logits[(tb + r) * V + v] = dot(b.ph + r, wt.out_proj + v, V, H);
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < R * Mv; i += kThreads) {
    const int r = i / Mv;
    if (r < rows) asum[(size_t)b0 * Mv + i] = s_asum[i];
  }
}

// The backward of gscan::attend_row for one row, by one warp (the TPU
// backward kernel's attention part, and _attention_bwd): given the
// context's cotangent dctx = a + b (+ c) (feature-major, stride `stride`),
// the softmax weights w [M] and an optional extra cotangent of the weights
// g [M] * g_scale,
//   dw[m]  = sum_h dctx[h] K[m, h] + g[m] g_scale
//   ds[m]  = w[m] (dw[m] - sum_m' w[m'] dw[m'])
//   hid    = tanh(pq[h] + K[m, h])
//   dK[m, h] += w[m] dctx[h] + ds[m] ew[h] (1 - hid^2)   (global, this row's)
//   dpq[h] = sum_m ds[m] ew[h] (1 - hid^2),  gew[h] = sum_m hid ds[m]
// As in the TPU kernel, no mask: a masked key has weight exactly 0.
__device__ void attend_row_backward(
    const float* pq, const float* dctx_a, const float* dctx_b,
    const float* dctx_c, int stride, const float* __restrict__ keys,
    const float* w, const float* __restrict__ ew,
    const float* __restrict__ g, float g_scale, int M, int H,
    float* __restrict__ dkeys, float* dpq, float* __restrict__ gew,
    float* dw) {
  constexpr int NH = gscan::kMaxH / 32;
  constexpr int kG = gscan::kGroup;
  const int lane = threadIdx.x & 31;
  float q[NH], e[NH], dc[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int h = lane + 32 * i;
    q[i] = e[i] = dc[i] = 0.f;
    if (h < H) {
      q[i] = pq[h * stride];
      e[i] = ew[h];
      dc[i] = dctx_a[h * stride] + dctx_b[h * stride];
      if (dctx_c != nullptr) dc[i] += dctx_c[h * stride];
    }
  }
  for (int m0 = 0; m0 < M; m0 += kG) {
    float p[kG];
#pragma unroll
    for (int gi = 0; gi < kG; ++gi) {
      p[gi] = 0.f;
      if (m0 + gi < M) {
        const float* k = keys + (size_t)(m0 + gi) * H;
#pragma unroll
        for (int i = 0; i < NH; ++i) {
          const int h = lane + 32 * i;
          if (h < H) p[gi] = fmaf(dc[i], k[h], p[gi]);
        }
      }
    }
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
      for (int gi = 0; gi < kG; ++gi)
        p[gi] += __shfl_xor_sync(0xffffffffu, p[gi], offset);
    if (lane == 0) {
#pragma unroll
      for (int gi = 0; gi < kG; ++gi) {
        const int m = m0 + gi;
        if (m < M) dw[m] = g != nullptr ? p[gi] + g[m] * g_scale : p[gi];
      }
    }
  }
  __syncwarp();
  float part = 0.f;
  for (int m = lane; m < M; m += 32) part += w[m] * dw[m];
  const float inner = gscan::warp_sum(part);

  float dq[NH], ge[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) dq[i] = ge[i] = 0.f;
  for (int m = 0; m < M; ++m) {
    const float wm = w[m];
    const float ds = wm * (dw[m] - inner);
    const float* k = keys + (size_t)m * H;
    float* dk = dkeys + (size_t)m * H;
#pragma unroll
    for (int i = 0; i < NH; ++i) {
      const int h = lane + 32 * i;
      if (h < H) {
        const float hid = tanhf(q[i] + k[h]);
        ge[i] = fmaf(hid, ds, ge[i]);
        const float dpre = ds * e[i] * (1.f - hid * hid);
        dq[i] += dpre;
        dk[h] += wm * dc[i] + dpre;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    const int h = lane + 32 * i;
    if (h < H) {
      dpq[h * stride] = dq[i];
      gew[h] = ge[i];
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads) backward_kernel(
    const int* __restrict__ tokens, const float* __restrict__ drop,
    const float* __restrict__ proj_txt, const float* __restrict__ cmd_mask,
    const float* __restrict__ proj_vis, const float* __restrict__ h_res,
    const float* __restrict__ c_res, const float* __restrict__ dlogits,
    const float* __restrict__ g_asum, Weights wt, Transposed tr,
    float* __restrict__ d_proj_txt, float* __restrict__ d_proj_vis,
    float* __restrict__ dh0, float* __restrict__ dc0,
    float* __restrict__ stash, int B, int T, int num_steps, int Mt, int Mv,
    int H, int E, int V) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  StepBuffers b;
  float* p = b.carve(smem, H, E, Mt, Mv);
  float* s_c_new = p;  p += H * R;
  float* s_dlog = p;   p += V * R;            // [V][R]
  float* s_dph = p;    p += H * R;
  float* s_dpre = p;   p += (E + 3 * H) * R;  // d [emb; h_new; ctx_cmd; ctx_sit]
  float* s_dg = p;     p += 4 * H * R;        // d gates (pre-activation)
  float* s_dli = p;    p += (E + 3 * H) * R;  // d [emb; ctx_cmd; ctx_sit] | dh
  float* s_dpqv = p;   p += H * R;
  float* s_djp = p;    p += H * R;            // d visual query pre-activation
  float* s_djoint = p; p += 2 * H * R;        // d [h; ctx_cmd] of the query
  float* s_dpqt = p;   p += H * R;
  float* s_dh = p;     p += H * R;
  float* s_dc = p;     p += H * R;
  float* s_dw = p;     p += gscan::kMaxM * R;  // [R][kMaxM] scratch
  const size_t total = p - smem;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, B - b0);
  const Stash lay(V, E, H);
  const int G = 4 * H;

  for (size_t i = tid; i < total; i += kThreads) smem[i] = 0.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B + b0;
    for (int i = tid; i < R * H; i += kThreads) {
      const int r = i / H, u = i % H;
      const bool in = r < rows;
      b.h[u * R + r] = in ? h_res[(tb + r) * H + u] : 0.f;
      b.c[u * R + r] = in ? c_res[(tb + r) * H + u] : 0.f;
    }
    for (int i = tid; i < R * V; i += kThreads) {
      const int r = i / V, v = i % V;
      s_dlog[v * R + r] = r < rows ? dlogits[(tb + r) * V + v] : 0.f;
    }
    __syncthreads();

    // Recompute the step's forward.
    step_forward(b, s_c_new, tokens, drop, proj_txt, cmd_mask, proj_vis,
                 wt, tb, b0, rows, Mt, Mv, H, E, V);

    // d_ph = dlogits out_proj^T.
    for (int u = tid; u < H; u += kThreads) {
      float acc[R];
      zero(acc);
      accum(acc, s_dlog, tr.out_proj, H, u, V);
#pragma unroll
      for (int r = 0; r < R; ++r) s_dph[u * R + r] = acc[r];
    }
    __syncthreads();

    // d [emb; h_new; ctx_cmd; ctx_sit] = d_ph out_w^T.
    for (int j = tid; j < E + 3 * H; j += kThreads) {
      float acc[R];
      zero(acc);
      accum(acc, s_dph, tr.out_w, E + 3 * H, j, H);
#pragma unroll
      for (int r = 0; r < R; ++r) s_dpre[j * R + r] = acc[r];
    }
    __syncthreads();

    // The cell's backward; dc becomes the gradient of the pre-step c.
    for (int u = tid; u < H; u += kThreads) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float si = sigmoidf(b.gates[u * R + r]);
        const float sf = sigmoidf(b.gates[(H + u) * R + r]);
        const float tg = tanhf(b.gates[(2 * H + u) * R + r]);
        const float so = sigmoidf(b.gates[(3 * H + u) * R + r]);
        const float c = b.c[u * R + r];
        const float tc = tanhf(s_c_new[u * R + r]);
        const float dh_new = s_dh[u * R + r] + s_dpre[(E + u) * R + r];
        const float dct = s_dc[u * R + r] + dh_new * so * (1.f - tc * tc);
        s_dg[u * R + r] = dct * tg * si * (1.f - si);
        s_dg[(H + u) * R + r] = dct * c * sf * (1.f - sf);
        s_dg[(2 * H + u) * R + r] = dct * si * (1.f - tg * tg);
        s_dg[(3 * H + u) * R + r] = dh_new * tc * so * (1.f - so);
        s_dc[u * R + r] = dct * sf;
      }
    }
    __syncthreads();

    // d_lstm_in = d_gates w_ih (columns 0 .. E+2H), dh_lstm = d_gates w_hh.
    for (int j = tid; j < E + 3 * H; j += kThreads) {
      float acc[R];
      zero(acc);
      if (j < E + 2 * H)
        accum(acc, s_dg, tr.w_ih, E + 2 * H, j, G);
      else
        accum(acc, s_dg, tr.w_hh, H, j - (E + 2 * H), G);
#pragma unroll
      for (int r = 0; r < R; ++r) s_dli[j * R + r] = acc[r];
    }
    __syncthreads();

    // Visual attention backward, with the summed attention's cotangent on
    // the valid steps.
    for (int r = warp; r < rows; r += kWarps) {
      const size_t row = b0 + r;
      attend_row_backward(
          b.pq_vis + r, s_dli + (E + H) * R + r, s_dpre + (E + 2 * H) * R + r,
          nullptr, R, proj_vis + row * Mv * H, b.w_vis + r * Mv, wt.vis_ew,
          g_asum + row * Mv, t < num_steps ? 1.f : 0.f, Mv, H,
          d_proj_vis + row * Mv * H, s_dpqv + r,
          stash + (tb + r) * lay.width + lay.g_vis_ew,
          s_dw + r * gscan::kMaxM);
    }
    __syncthreads();

    // d of the visual query's pre-activation.
    for (int u = tid; u < H; u += kThreads) {
      float acc[R];
      zero(acc);
      accum(acc, s_dpqv, tr.vis_qw, H, u, H);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float vq = b.vq[u * R + r];
        s_djp[u * R + r] = acc[r] * (1.f - vq * vq);
      }
    }
    __syncthreads();

    // d [h; ctx_cmd] of the visual query.
    for (int j = tid; j < 2 * H; j += kThreads) {
      float acc[R];
      zero(acc);
      accum(acc, s_djp, tr.q2k_w, 2 * H, j, H);
#pragma unroll
      for (int r = 0; r < R; ++r) s_djoint[j * R + r] = acc[r];
    }
    __syncthreads();

    // Textual attention backward.
    for (int r = warp; r < rows; r += kWarps) {
      const size_t row = b0 + r;
      attend_row_backward(
          b.pq_txt + r, s_dli + E * R + r, s_dpre + (E + H) * R + r,
          s_djoint + H * R + r, R, proj_txt + row * Mt * H, b.w_txt + r * Mt,
          wt.txt_ew, nullptr, 0.f, Mt, H, d_proj_txt + row * Mt * H,
          s_dpqt + r, stash + (tb + r) * lay.width + lay.g_txt_ew,
          s_dw + r * gscan::kMaxM);
    }
    __syncthreads();

    // dh of the pre-step state: dh_lstm + dh_joint + dh_txt.
    for (int u = tid; u < H; u += kThreads) {
      float acc[R];
      zero(acc);
      accum(acc, s_dpqt, tr.txt_qw, H, u, H);
#pragma unroll
      for (int r = 0; r < R; ++r)
        s_dh[u * R + r] = s_dli[(E + 2 * H + u) * R + r] +
                          s_djoint[u * R + r] + acc[r];
    }
    // The row-step's operands for the weight gradients.
    auto put = [&](const float* buf, int width, int offset) {
      for (int i = tid; i < R * width; i += kThreads) {
        const int r = i / width, f = i % width;
        if (r < rows) stash[(tb + r) * lay.width + offset + f] = buf[f * R + r];
      }
    };
    for (int i = tid; i < R * V; i += kThreads) {
      const int r = i / V, v = i % V;
      if (r < rows)
        stash[(tb + r) * lay.width + lay.onehot + v] =
            tokens[tb + r] == v ? 1.f : 0.f;
    }
    put(b.emb, E, lay.emb);
    put(b.h_new, H, lay.h_new);
    put(b.ctx_cmd, 2 * H, lay.ctx_cmd);  // ctx_cmd, ctx_sit
    put(b.ph, H, lay.ph);
    put(b.vq, H, lay.vq);
    put(s_dph, H, lay.d_ph);
    put(s_dg, G, lay.d_gates);
    put(s_dpqv, H, lay.d_pq_vis);
    put(s_djp, H, lay.d_joint);
    put(s_dpqt, H, lay.d_pq_txt);
    for (int i = tid; i < R * E; i += kThreads) {
      const int r = i / E, e = i % E;
      if (r < rows)
        stash[(tb + r) * lay.width + lay.d_emb + e] =
            (s_dli[e * R + r] + s_dpre[e * R + r]) * drop[(tb + r) * E + e];
    }
    __syncthreads();
  }

  for (int i = tid; i < R * H; i += kThreads) {
    const int r = i / H, u = i % H;
    if (r < rows) {
      dh0[(size_t)(b0 + r) * H + u] = s_dh[u * R + r];
      dc0[(size_t)(b0 + r) * H + u] = s_dc[u * R + r];
    }
  }
}

size_t backward_smem_floats(int H, int E, int V, int Mt, int Mv) {
  return StepBuffers::floats(H, E, Mt, Mv) +
         (size_t)R * (H + V + H + (E + 3 * H) + 4 * H + (E + 3 * H) + H +
                      H + 2 * H + H + H + H + gscan::kMaxM);
}

// The helper kernel: weight gradients out = X^T dY, summed over N row-steps.
constexpr int kMaxProblems = 16;
constexpr int kTile = 32;
constexpr int kGradThreads = 256;

struct GradProblem {
  const float* x;   // [N, ldx] from column 0; null: a column of ones
  const float* dy;  // [N, ldy] from column 0
  float* out;       // [rows, cols] row-major
  int ldx, ldy, rows, cols, tile0, tiles_j;
};

struct GradProblems {
  GradProblem p[kMaxProblems];
  int count, N;
};

// One CTA per 32 x 32 tile of one problem's output; each thread sums four
// outputs over all N rows, 32 rows of X and dY at a time through shared
// memory. The order of every sum is fixed by the shapes alone.
__global__ void __launch_bounds__(kGradThreads) weight_grads_kernel(
    GradProblems probs) {
  __shared__ float xs[kTile][kTile + 1];
  __shared__ float ds[kTile][kTile + 1];
  int k = 0;
  while (k + 1 < probs.count && probs.p[k + 1].tile0 <= (int)blockIdx.x) ++k;
  const GradProblem P = probs.p[k];
  const int local = blockIdx.x - P.tile0;
  const int i0 = (local / P.tiles_j) * kTile, j0 = (local % P.tiles_j) * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;
  constexpr int kPer = kTile * kTile / kGradThreads;  // outputs per thread
  float acc[kPer], comp[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) acc[q] = comp[q] = 0.f;
  const int N = probs.N;
  for (int n0 = 0; n0 < N; n0 += kTile) {
    for (int e = threadIdx.x; e < kTile * kTile; e += kGradThreads) {
      const int nn = e / kTile, c = e % kTile, n = n0 + nn;
      float xv = 0.f, dv = 0.f;
      if (n < N && i0 + c < P.rows)
        xv = P.x != nullptr ? P.x[(size_t)n * P.ldx + i0 + c] : 1.f;
      if (n < N && j0 + c < P.cols) dv = P.dy[(size_t)n * P.ldy + j0 + c];
      xs[nn][c] = xv;
      ds[nn][c] = dv;
    }
    __syncthreads();
    // Blocked summation: each tile of 32 rows is summed on its own and
    // then added with a compensated (Kahan) sum, which keeps the float32
    // error of the N-term sums near one rounding.
    float part[kPer];
#pragma unroll
    for (int q = 0; q < kPer; ++q) part[q] = 0.f;
#pragma unroll 8
    for (int nn = 0; nn < kTile; ++nn) {
      const float dv = ds[nn][tx];
#pragma unroll
      for (int q = 0; q < kPer; ++q)
        part[q] = fmaf(xs[nn][ty + q * (kGradThreads / kTile)], dv, part[q]);
    }
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const float y = part[q] - comp[q];
      const float t = acc[q] + y;
      comp[q] = (t - acc[q]) - y;
      acc[q] = t;
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int i = i0 + ty + q * (kGradThreads / kTile), j = j0 + tx;
    if (i < P.rows && j < P.cols) P.out[(size_t)i * P.cols + j] = acc[q];
  }
}

bool valid_shapes(int B, int T, int Mt, int Mv, int H, int E, int V) {
  return B > 0 && T > 0 && H > 0 && H <= gscan::kMaxH && Mt > 0 &&
         Mt <= gscan::kMaxM && Mv > 0 && Mv <= gscan::kMaxM && E > 0 && V > 0;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem_floats, int B, void* stream,
                   Args... args) {
  const size_t smem = smem_floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(B + R - 1) / R, kThreads, smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace

extern "C" int gscan_teacher_forced_forward(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h0,
    const float* c0, const float* txt_qw, const float* txt_ew,
    const float* q2k_w, const float* q2k_b, const float* vis_qw,
    const float* vis_ew, const float* emb, const float* w_ih,
    const float* w_hh, const float* bias, const float* out_w,
    const float* out_proj, float* logits, float* h_res, float* c_res,
    float* asum, int B, int T, int num_steps, int Mt, int Mv, int H, int E,
    int V, void* stream) {
  if (!valid_shapes(B, T, Mt, Mv, H, E, V))
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights wt{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew,
                   emb,    w_ih,   w_hh,  bias,  out_w,  out_proj};
  return static_cast<int>(launch(
      forward_kernel, StepBuffers::floats(H, E, Mt, Mv) + (size_t)R * Mv, B,
      stream, tokens, drop, proj_txt, cmd_mask, proj_vis, h0, c0, wt, logits,
      h_res, c_res, asum, B, T, num_steps, Mt, Mv, H, E, V));
}

extern "C" int gscan_teacher_forced_backward(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h_res,
    const float* c_res, const float* dlogits, const float* g_asum,
    const float* txt_qw, const float* txt_ew, const float* q2k_w,
    const float* q2k_b, const float* vis_qw, const float* vis_ew,
    const float* emb, const float* w_ih, const float* w_hh, const float* bias,
    const float* out_w, const float* out_proj, const float* txt_qw_t,
    const float* q2k_w_t, const float* vis_qw_t, const float* w_ih_t,
    const float* w_hh_t, const float* out_w_t, const float* out_proj_t,
    float* d_proj_txt, float* d_proj_vis, float* dh0, float* dc0,
    float* stash, int B, int T, int num_steps, int Mt, int Mv, int H, int E,
    int V, void* stream) {
  if (!valid_shapes(B, T, Mt, Mv, H, E, V))
    return static_cast<int>(cudaErrorInvalidValue);
  const Weights wt{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew,
                   emb,    w_ih,   w_hh,  bias,  out_w,  out_proj};
  const Transposed tr{txt_qw_t, q2k_w_t, vis_qw_t, w_ih_t,
                      w_hh_t,   out_w_t, out_proj_t};
  return static_cast<int>(launch(
      backward_kernel, backward_smem_floats(H, E, V, Mt, Mv), B, stream,
      tokens, drop, proj_txt, cmd_mask, proj_vis, h_res, c_res, dlogits,
      g_asum, wt, tr, d_proj_txt, d_proj_vis, dh0, dc0, stash, B, T,
      num_steps, Mt, Mv, H, E, V));
}

extern "C" int gscan_teacher_forced_weight_grads(
    const float* stash, const float* h_res, const float* dlogits,
    float* g_txt_qw, float* g_txt_ew, float* g_q2k_w, float* g_q2k_b,
    float* g_vis_qw, float* g_vis_ew, float* g_emb, float* g_w_ih,
    float* g_w_hh, float* g_bias, float* g_out_w, float* g_out_proj, int N,
    int H, int E, int V, void* stream) {
  if (N <= 0 || H <= 0 || E <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Stash lay(V, E, H);
  const int W = lay.width, G = 4 * H;
  const float* s = stash;
  // {x, dy, out, ldx, ldy, rows, cols}: out = X^T dY.
  const GradProblem list[] = {
      {h_res, s + lay.d_pq_txt, g_txt_qw, H, W, H, H},
      {nullptr, s + lay.g_txt_ew, g_txt_ew, 0, W, 1, H},
      {h_res, s + lay.d_joint, g_q2k_w, H, W, H, H},
      {s + lay.ctx_cmd, s + lay.d_joint, g_q2k_w + (size_t)H * H, W, W, H, H},
      {nullptr, s + lay.d_joint, g_q2k_b, 0, W, 1, H},
      {s + lay.vq, s + lay.d_pq_vis, g_vis_qw, W, W, H, H},
      {nullptr, s + lay.g_vis_ew, g_vis_ew, 0, W, 1, H},
      {s + lay.onehot, s + lay.d_emb, g_emb, W, W, V, E},
      {s + lay.emb, s + lay.d_gates, g_w_ih, W, W, E, G},
      {s + lay.ctx_cmd, s + lay.d_gates, g_w_ih + (size_t)E * G, W, W, 2 * H,
       G},
      {h_res, s + lay.d_gates, g_w_hh, H, W, H, G},
      {nullptr, s + lay.d_gates, g_bias, 0, W, 1, G},
      {s + lay.emb, s + lay.d_ph, g_out_w, W, W, E + 3 * H, H},
      {s + lay.ph, dlogits, g_out_proj, W, V, H, V},
  };
  GradProblems probs{};
  probs.count = static_cast<int>(sizeof(list) / sizeof(list[0]));
  probs.N = N;
  int tiles = 0;
  for (int i = 0; i < probs.count; ++i) {
    GradProblem p = list[i];
    p.tile0 = tiles;
    p.tiles_j = (p.cols + kTile - 1) / kTile;
    tiles += ((p.rows + kTile - 1) / kTile) * p.tiles_j;
    probs.p[i] = p;
  }
  weight_grads_kernel<<<tiles, kGradThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(probs);
  return static_cast<int>(cudaGetLastError());
}
