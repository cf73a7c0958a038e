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
// the TPU kernel's math. The weight gradients are sums over rows and steps:
// kernel 4 writes every row-step's operands (the X and dY of each X^T dY)
// to a stash in device memory, and the helper kernel (weight_grads_kernel)
// forms the sums. No atomics anywhere, so every output is bit-identical
// from run to run. The stash layout is ops/teacher_forced.py's StashLayout.
//
// Bound on the H100: operations (a row-step is ~0.5 MFLOP; kernel 4 about
// three times kernel 3), but the T-step chain makes both recurrent kernels
// latency-bound: what a step costs is the chain of its phases, not its
// flops.
//
// Both recurrent kernels run one thread-block cluster of S = 8 CTAs per
// group of RC rows (16, or 8 where 16 do not fit). CTA `rank` of a cluster
// owns the hidden units [u0, u0 + C) (C = ceil(H / S)) and keeps, for the
// whole walk, the column slices of every weight matrix for its units in
// shared memory when they fit (~126 KB at H = E = 100), so that no weight
// is read from L2 after the kernel starts; otherwise it reads the same
// columns from L2 in every product. A product y = x W (x the full input, y
// a slice) runs split-K over all the threads of the CTA; a transposed
// product dx = dy W^T sums over the CTA's own units only, for every output,
// and the S partial sums are added by the CTA that owns each output, in
// rank order (reduce-scatter through distributed shared memory). Full
// vectors that a product reads (h, the LSTM input, the visual query, the
// new h) are broadcast to every CTA of the cluster. The attentions of row r
// run in the CTA of rank r % S, over all its warps (attend_cta). Every sum
// has an order fixed by the shapes, and there are no atomics. The step's
// forward is one device function (step_forward) that both kernels call:
// kernel 3 runs it once per step, kernel 4 recomputes it before each step's
// backward. Kernel 3 also keeps its rows' keys in shared memory for the
// whole walk where they fit, and adds the logits' per-CTA partial sums in
// rank order at the owning CTA one barrier later, so that a forward step
// has 6 cluster barriers. Which layout a launch takes (its "plan") is the
// first of the kernel's plans that fits the device's shared memory per CTA
// and the width (gscan_teacher_forced_plan); past the cluster plans both
// kernels run the grid plans of teacher_forced_grid.cu, which take every
// shape.
#include <climits>
#include <cstdint>

#include "attend.cuh"
#include "product_core.cuh"
#include "teacher_forced.cuh"

// teacher_forced_grid.cu: kernels 3 and 4's grid plans.
size_t gscan_teacher_forced_grid_smem_bytes(int H, int Mt, int Mv);
size_t gscan_teacher_forced_grid_scratch_floats(int kernel, int B, int H,
                                                int E, int V, int Mt, int Mv);
int gscan_teacher_forced_forward_grid(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h0,
    const float* c0, const float* const* weights, float* logits,
    float* h_res, float* c_res, float* asum, float* scratch, int B, int T,
    int num_steps, int Mt, int Mv, int H, int E, int V, void* stream);
int gscan_teacher_forced_backward_grid(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h_res,
    const float* c_res, const float* dlogits, const float* g_asum,
    const float* const* weights, float* d_proj_txt, float* d_proj_vis,
    float* dh0, float* dc0, float* stash, float* scratch, int B, int T,
    int num_steps, int Mt, int Mv, int H, int E, int V, void* stream);

namespace {

using gscan::tf::Stash;
using gscan::tf::Weights;


__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// cp.async copies into shared memory (completed by cp_async_wait).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(pred ? 4 : 0));
}
// Copies `bytes` (0..16) of src and zero-fills the rest of the 16.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Threads per CTA of the cluster kernels: 384 measured fastest for kernel 4
// on the H100 (512, capped at 128 registers a thread, took 1.17x as long;
// 320 and 256 took 1.03x and 1.08x; PERF.md).
constexpr int kClusterThreads = 384;
constexpr int kClusterWarps = kClusterThreads / 32;
constexpr int kClusterSize = 8;  // CTAs per cluster: the largest portable

// Cluster barrier halves: arrive (release this CTA's shared-memory writes
// and reads) and wait (acquire everyone's). Every thread calls both.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// The address of `p` (a shared-memory address of this CTA) in the shared
// memory of CTA `rank` of the cluster.
template <typename T>
__device__ __forceinline__ T* remote(T* p, unsigned rank) {
  size_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(out)
               : "l"(reinterpret_cast<size_t>(p)), "r"(rank));
  return reinterpret_cast<T*>(out);
}

__device__ __forceinline__ void fma4v(float4& acc, const float4 v, float w) {
  acc.x = fmaf(v.x, w, acc.x);
  acc.y = fmaf(v.y, w, acc.y);
  acc.z = fmaf(v.z, w, acc.z);
  acc.w = fmaf(v.w, w, acc.w);
}
__device__ __forceinline__ void add4(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
// Rows 4g .. 4g+3 of feature f of a feature-major [feature][RC] buffer.
template <int RC>
__device__ __forceinline__ float4& at4(float* buf, int f, int g) {
  return *reinterpret_cast<float4*>(buf + f * RC + 4 * g);
}

constexpr int kRowGroup = 8;  // rows per product item
constexpr int kScratch = kClusterThreads * kRowGroup;  // see cta_product

// Reserve n floats at p, float4-aligned; returns where they start.
__host__ __device__ inline size_t take(size_t& p, size_t n) {
  const size_t at = p;
  p += (n + 3) & ~size_t(3);
  return at;
}

// ---------------------------------------------------------------------------
// Where a CTA finds its weight columns.
// ---------------------------------------------------------------------------

// Offsets (in floats) of the weight part of a cluster kernel's shared
// memory. Resident: the column slices of every matrix for the CTA's units
// (column j < C of a slice is the global column u0 + j, of gate g: g H +
// u0 + j; columns past H stay 0). Always: the head's out_proj rows, the
// biases.
struct WeightLayout {
  int C = 0, CE = 0;
  size_t w_txt = 0, w_q2k = 0, w_vis = 0, w_ih = 0, w_out = 0;
  size_t w_proj = 0, b_q2k = 0, b_gate = 0;
  __host__ __device__ void place(size_t& p, int S, int H, int E, int V,
                                 bool resident) {
    C = (H + S - 1) / S;
    CE = (E + S - 1) / S;
    if (resident) {
      w_txt = take(p, (size_t)H * C);
      w_q2k = take(p, (size_t)2 * H * C);
      w_vis = take(p, (size_t)H * C);
      w_ih = take(p, (size_t)(E + 3 * H) * 4 * C);  // w_ih rows, then w_hh
      w_out = take(p, (size_t)(E + 3 * H) * C);
    }
    w_proj = take(p, (size_t)C * V);
    b_q2k = take(p, C);
    b_gate = take(p, 4 * C);
  }
};

// A block of weight rows: rows k < split from `a`, the rest from `b` (the
// LSTM's w_ih, then w_hh), with row stride ld.
struct WMat {
  const float* a;
  const float* b;
  int split, ld;
  __device__ const float* row(int k) const {
    return k < split ? a + (size_t)k * ld : b + (size_t)(k - split) * ld;
  }
};

// Column n of a CTA's weight slice (n < C, or n < 4C for the gates, gate
// n / C): in the resident slice, column n; in the matrix itself, column
// (n / C) H + u0 + n % C, clamped into the matrix for the padding columns
// past the CTA's nu units (their products are never used).
template <bool kResident>
struct Cols {
  int C, H, u0, nu;
  __device__ int col(int n) const {
    if constexpr (kResident)
      return n;
    else
      return (n / C) * H + min(u0 + n % C, H - 1);
  }
};

// The five products of a step and the biases.
struct StepWeights {
  WMat txt, q2k, vis, gates, out;
  const float* b_q2k;
  const float* b_gate;
};

template <bool kResident>
__device__ StepWeights step_weights(const WeightLayout& L, float* sm,
                                    const Weights& wt, int H, int E) {
  if constexpr (kResident) {
    const int C = L.C;
    return {{sm + L.w_txt, nullptr, INT_MAX, C},
            {sm + L.w_q2k, nullptr, INT_MAX, C},
            {sm + L.w_vis, nullptr, INT_MAX, C},
            {sm + L.w_ih, nullptr, INT_MAX, 4 * C},
            {sm + L.w_out, nullptr, INT_MAX, C},
            sm + L.b_q2k,
            sm + L.b_gate};
  } else {
    return {{wt.txt_qw, nullptr, INT_MAX, H},
            {wt.q2k_w, nullptr, INT_MAX, H},
            {wt.vis_qw, nullptr, INT_MAX, H},
            {wt.w_ih, wt.w_hh, E + 2 * H, 4 * H},
            {wt.out_w, nullptr, INT_MAX, H},
            sm + L.b_q2k,
            sm + L.b_gate};
  }
}

// Copies this CTA's weight slices (resident plans), out_proj rows and
// biases into shared memory, which must be zero.
template <bool kResident>
__device__ void load_weights(float* sm, const WeightLayout& L,
                             const Weights& wt, int H, int E, int V, int u0,
                             int nu) {
  const int C = L.C, G4 = 4 * C, tid = threadIdx.x;
  if constexpr (kResident) {
    float *w_txt = sm + L.w_txt, *w_vis = sm + L.w_vis;
    float *w_q2k = sm + L.w_q2k, *w_ih = sm + L.w_ih, *w_out = sm + L.w_out;
    for (int i = tid; i < H * C; i += kClusterThreads) {
      const int k = i / C, j = i % C;
      if (j < nu) {
        w_txt[i] = wt.txt_qw[(size_t)k * H + u0 + j];
        w_vis[i] = wt.vis_qw[(size_t)k * H + u0 + j];
      }
    }
    for (int i = tid; i < 2 * H * C; i += kClusterThreads) {
      const int k = i / C, j = i % C;
      if (j < nu) w_q2k[i] = wt.q2k_w[(size_t)k * H + u0 + j];
    }
    for (int i = tid; i < (E + 3 * H) * G4; i += kClusterThreads) {
      const int k = i / G4, gj = i % G4, g = gj / C, j = gj % C;
      if (j < nu) {
        const int col = g * H + u0 + j;
        w_ih[i] = k < E + 2 * H
                      ? wt.w_ih[(size_t)k * 4 * H + col]
                      : wt.w_hh[(size_t)(k - E - 2 * H) * 4 * H + col];
      }
    }
    for (int i = tid; i < (E + 3 * H) * C; i += kClusterThreads) {
      const int k = i / C, j = i % C;
      if (j < nu) w_out[i] = wt.out_w[(size_t)k * H + u0 + j];
    }
  }
  float *w_proj = sm + L.w_proj, *b_q2k = sm + L.b_q2k;
  float* b_gate = sm + L.b_gate;
  for (int i = tid; i < C * V; i += kClusterThreads) {
    const int j = i / V;
    if (j < nu) w_proj[i] = wt.out_proj[(size_t)(u0 + j) * V + i % V];
  }
  for (int gj = tid; gj < G4; gj += kClusterThreads) {
    const int g = gj / C, j = gj % C;
    if (j < nu) {
      b_gate[gj] = wt.bias[g * H + u0 + j];
      if (g == 0) b_q2k[j] = wt.q2k_b[u0 + j];
    }
  }
}

// ---------------------------------------------------------------------------
// Products and attentions over the threads of one CTA.
// ---------------------------------------------------------------------------

struct Seg {
  const float* x;  // feature-major [k][RC]
  int k;
  const float* w;  // the weight row of this segment's first input
};

// y[n][r] = sum_k x[k][r] W[k, col(n)] for n < nc and the RC rows, with x
// the concatenation of up to three segments along k (each with its weight
// rows, row stride ldw). Items are (column n, kRowGroup rows); K is split
// over the threads the items leave free, and the splits' partial sums are
// added in split order. epi(n, g, float4) receives rows 4g .. 4g+3 of
// column n. Ends with __syncthreads().
template <int RC, bool kRes, typename Epi>
__device__ void cta_product(Seg s0, Seg s1, Seg s2, int ldw,
                            const Cols<kRes>& cols, int nc, float* scratch,
                            Epi epi) {
  constexpr int RG = RC < kRowGroup ? RC : kRowGroup;
  constexpr int Q = RG / 4;  // float4s per item
  constexpr int G = RC / RG;
  constexpr int kMinK = 8;
  const int K = s0.k + s1.k + s2.k;
  const int items = nc * G;
  int ks = items > 0 ? kClusterThreads / items : 1;
  ks = max(1, min(ks, (K + kMinK - 1) / kMinK));
  float4* scratch4 = reinterpret_cast<float4*>(scratch);
  for (int t = threadIdx.x; t < items * ks; t += kClusterThreads) {
    const int i = t % items, s = t / items;
    const int n = i / G, g = i % G;
    const int kb = K * s / ks, ke = K * (s + 1) / ks;
    const int c = cols.col(n);
    float4 acc[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    int base = 0;
    const Seg segs[3] = {s0, s1, s2};
#pragma unroll
    for (int sg = 0; sg < 3; ++sg) {
      const int lo = max(kb - base, 0), hi = min(ke - base, segs[sg].k);
      const float* x = segs[sg].x + RG * g;
      const float* w = segs[sg].w + c;
#pragma unroll 4
      for (int k = lo; k < hi; ++k) {
        const float wk = w[(size_t)k * ldw];
#pragma unroll
        for (int q = 0; q < Q; ++q)
          fma4v(acc[q], *reinterpret_cast<const float4*>(x + k * RC + 4 * q),
                wk);
      }
      base += segs[sg].k;
    }
    if (ks == 1) {
#pragma unroll
      for (int q = 0; q < Q; ++q) epi(n, g * Q + q, acc[q]);
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q) scratch4[(s * items + i) * Q + q] = acc[q];
    }
  }
  if (ks > 1) {
    __syncthreads();
    for (int t = threadIdx.x; t < items * Q; t += kClusterThreads) {
      const int i = t / Q, q = t % Q;
      float4 a = scratch4[i * Q + q];
      for (int s = 1; s < ks; ++s) add4(a, scratch4[(s * items + i) * Q + q]);
      epi(i / G, (i % G) * Q + q, a);
    }
  }
  __syncthreads();
}

// part[j][r] = sum_u dy[u][r] W[j, col(u)] for j < J: a transposed product
// over this CTA's units only (u < blocks * C; blocks = 4 for the gates).
// epi(j, g, float4) as cta_product's.
template <int RC, bool kRes, typename Epi>
__device__ void cta_partial(const float* dy, int blocks, const WMat& W,
                            const Cols<kRes>& cols, int J, Epi epi) {
  constexpr int G = RC / 4;
  for (int t = threadIdx.x; t < J * G; t += kClusterThreads) {
    const int j = t / G, g = t % G;
    const float* w = W.row(j);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (kRes) {
      const int K = blocks * cols.C;
#pragma unroll 4
      for (int u = 0; u < K; ++u)
        fma4v(acc, *reinterpret_cast<const float4*>(dy + u * RC + 4 * g),
              w[u]);
    } else {
      // The padding units (u >= nu) have dy = 0: skipping them adds
      // nothing, and their columns lie past the matrix.
      for (int b = 0; b < blocks; ++b) {
        const float* wb = w + b * cols.H + cols.u0;
        const float* db = dy + b * cols.C * RC + 4 * g;
#pragma unroll 4
        for (int u = 0; u < cols.nu; ++u)
          fma4v(acc, *reinterpret_cast<const float4*>(db + u * RC), wb[u]);
      }
    }
    epi(j, g, acc);
  }
}

// Key loads issued together per lane (12, 18 and 36 measured slower:
// registers, PERF.md).
constexpr int kKeyBatch = 8;
// Features per lane per chunk in the attentions' score loops.
constexpr int kNH = gscan::kFitH / 32;

template <int kOwn>
struct RowTeam {
  static constexpr int kWarpsPerRow = kClusterWarps / kOwn;
  int o, lw, lane, b;
  bool valid;
  __device__ RowTeam(int b_first, int b_stride, int B) {
    const int warp = threadIdx.x >> 5;
    lane = threadIdx.x & 31;
    o = warp / kWarpsPerRow;
    lw = warp % kWarpsPerRow;
    b = b_first + o * b_stride;
    valid = b < B;
  }
};

// The attentions come in two forms, as attend.cuh's: kFit, for M <= 64 and
// H <= 128 (gscan::attend_fits), where every loop over chunks of features
// or keys has a trip count fixed at compile time (one chunk of 32 kNH
// features, 64 / 32 scores per lane, one feature per lane of the context);
// and any M and H, where the same loops run over as many chunks as the
// shapes need.

// Forward: w = softmax(masked scores), ctx[h] = sum_m w[m] K[m, h].
// pq [H][kOwn]; the keys of owned row o are keys + o M H (kOwnKeys: a copy
// in shared memory) or keys + b M H (the [B][M][H] keys); ctx_out(h, o,
// value) stores the context; weights go to wts [kOwn][M]; sc [kOwn][M] is
// scratch.
template <int kOwn, bool kFit, bool kOwnKeys, typename Out>
__device__ void attend_cta(const float* pq, const float* __restrict__ keys,
                           const float* __restrict__ mask,
                           const float* __restrict__ ew, int M, int H,
                           int b_first, int b_stride, int B, float* wts,
                           float* sc, Out ctx_out) {
  constexpr int NH = kNH;
  constexpr int kStride = RowTeam<kOwn>::kWarpsPerRow;
  const RowTeam<kOwn> team(b_first, b_stride, B);
  const int o = team.o, lane = team.lane;
  const float* K = keys + (size_t)(kOwnKeys ? o : team.b) * M * H;
  const int chunks = kFit ? 1 : (H + 32 * NH - 1) / (32 * NH);
  if (team.valid) {
    constexpr int kG = gscan::kGroup;
    for (int c = 0; c < chunks; ++c) {
      const int h0 = 32 * NH * c;
      float q[NH], e[NH];
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int h = h0 + lane + 32 * i;
        q[i] = h < H ? pq[h * kOwn + o] : 0.f;
        e[i] = h < H ? ew[h] : 0.f;
      }
      for (int m0 = team.lw; m0 < M; m0 += kG * kStride) {
        float p[kG];
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) {
          const int m = m0 + gi * kStride;
          p[gi] = 0.f;
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            const int h = h0 + lane + 32 * i;
            if (m < M && h < H)
              p[gi] = fmaf(tanhf(q[i] + K[(size_t)m * H + h]), e[i], p[gi]);
          }
        }
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
            p[gi] += __shfl_xor_sync(0xffffffffu, p[gi], offset);
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) {
          const int m = m0 + gi * kStride;
          if (lane == 0 && m < M) {
            float v = c > 0 ? sc[o * M + m] + p[gi] : p[gi];
            if (c == chunks - 1 && mask != nullptr &&
                !(mask[(size_t)team.b * M + m] > 0.f))
              v = -1e9f;
            sc[o * M + m] = v;
          }
        }
      }
    }
  }
  __syncthreads();
  if (team.valid && team.lw == 0) {
    // Lane l takes the scores m = l + 32 j.
    const int nm = kFit ? gscan::kFitM / 32 : (M + 31) / 32;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < nm; ++j) {
      const int m = lane + 32 * j;
      if (m < M) mx = fmaxf(mx, sc[o * M + m]);
    }
    mx = gscan::warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < nm; ++j) {
      const int m = lane + 32 * j;
      if (m < M) {
        const float s = expf(sc[o * M + m] - mx);
        sc[o * M + m] = s;
        sum += s;
      }
    }
    sum = gscan::warp_sum(sum);
#pragma unroll
    for (int j = 0; j < nm; ++j) {
      const int m = lane + 32 * j;
      if (m < M) wts[o * M + m] = sc[o * M + m] / sum;
    }
  }
  __syncthreads();
  // Context: warp lw takes features 32 (lw + k kStride) + lane, all keys.
  if (team.valid) {
    const float* wrow = wts + o * M;
    const int rounds = kFit ? 1 : (H + 32 * kStride - 1) / (32 * kStride);
    for (int k = 0; k < rounds; ++k) {
      const int hb = 32 * (team.lw + k * kStride);
      if (hb >= H) break;
      const int h = hb + lane;
      float acc = 0.f;
      if (h < H) {
        int m = 0;
        for (; m + kKeyBatch <= M; m += kKeyBatch) {
          float kv[kKeyBatch];
#pragma unroll
          for (int j = 0; j < kKeyBatch; ++j)
            kv[j] = K[(size_t)(m + j) * H + h];
#pragma unroll
          for (int j = 0; j < kKeyBatch; ++j)
            acc = fmaf(wrow[m + j], kv[j], acc);
        }
        for (; m < M; ++m) acc = fmaf(wrow[m], K[(size_t)m * H + h], acc);
      }
      ctx_out(h, o, acc);
    }
  }
  __syncthreads();
}

// Backward (the TPU backward kernel's attention part, and _attention_bwd):
// given the context's cotangent dctx [H][kOwn], the weights wts [kOwn][M],
// pq [H][kOwn] and an optional cotangent of the weights g [B][M] * g_scale,
//   dw[m]  = sum_h dctx[h] K[m, h] + g[m] g_scale
//   ds[m]  = w[m] (dw[m] - sum_m' w[m'] dw[m'])
//   hid    = tanh(pq[h] + K[m, h])
//   dK[m, h] += w[m] dctx[h] + ds[m] ew[h] (1 - hid^2)   (dkeys, [B][M][H])
//   dpq[h] = sum_m ds[m] ew[h] (1 - hid^2),  gew[h] = sum_m hid ds[m]
// dpq_out(h, o, value) stores dpq; gew has a row stride of gew_stride.
// As in the TPU kernel, no mask: a masked key has weight exactly 0. dw
// [kOwn][M] is scratch.
template <int kOwn, bool kFit, typename Out>
__device__ void attend_cta_backward(
    const float* pq, const float* dctx, const float* __restrict__ keys,
    const float* wts, const float* __restrict__ ew,
    const float* __restrict__ g, float g_scale, int M, int H, int b_first,
    int b_stride, int B, float* __restrict__ dkeys, float* __restrict__ gew,
    size_t gew_stride, float* dw, Out dpq_out) {
  constexpr int NH = kNH;
  constexpr int kStride = RowTeam<kOwn>::kWarpsPerRow;
  const RowTeam<kOwn> team(b_first, b_stride, B);
  const int o = team.o, lane = team.lane;
  const float* K = keys + (size_t)team.b * M * H;
  float* dK = dkeys + (size_t)team.b * M * H;
  const int chunks = kFit ? 1 : (H + 32 * NH - 1) / (32 * NH);
  if (team.valid) {
    constexpr int kG = gscan::kGroup;
    for (int c = 0; c < chunks; ++c) {
      const int h0 = 32 * NH * c;
      float dc[NH];
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int h = h0 + lane + 32 * i;
        dc[i] = h < H ? dctx[h * kOwn + o] : 0.f;
      }
      for (int m0 = team.lw; m0 < M; m0 += kG * kStride) {
        float p[kG];
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) {
          const int m = m0 + gi * kStride;
          p[gi] = 0.f;
#pragma unroll
          for (int i = 0; i < NH; ++i) {
            const int h = h0 + lane + 32 * i;
            if (m < M && h < H)
              p[gi] = fmaf(dc[i], K[(size_t)m * H + h], p[gi]);
          }
        }
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
          for (int gi = 0; gi < kG; ++gi)
            p[gi] += __shfl_xor_sync(0xffffffffu, p[gi], offset);
#pragma unroll
        for (int gi = 0; gi < kG; ++gi) {
          const int m = m0 + gi * kStride;
          if (lane == 0 && m < M) {
            float v = c > 0 ? dw[o * M + m] + p[gi] : p[gi];
            if (c == chunks - 1 && g != nullptr)
              v = v + g[(size_t)team.b * M + m] * g_scale;
            dw[o * M + m] = v;
          }
        }
      }
    }
  }
  __syncthreads();
  if (team.valid) {
    const int nm = kFit ? gscan::kFitM / 32 : (M + 31) / 32;
    float part = 0.f;
#pragma unroll
    for (int j = 0; j < nm; ++j) {
      const int m = lane + 32 * j;
      if (m < M) part += wts[o * M + m] * dw[o * M + m];
    }
    const float inner = gscan::warp_sum(part);
    const float* dwrow = dw + o * M;
    const float* wrow = wts + o * M;
    // Warp lw takes features 32 (lw + k kStride) + lane, all keys.
    const int rounds = kFit ? 1 : (H + 32 * kStride - 1) / (32 * kStride);
    for (int k = 0; k < rounds; ++k) {
      const int hb = 32 * (team.lw + k * kStride);
      if (hb >= H) break;
      const int h = hb + lane;
      float dq = 0.f, ge = 0.f;
      if (h < H) {
        const float q = pq[h * kOwn + o], e = ew[h], d = dctx[h * kOwn + o];
        auto key = [&](int m, float kv, float dk) {
          const float wm = wrow[m];
          const float dsm = wm * (dwrow[m] - inner);
          const float hid = tanhf(q + kv);
          ge = fmaf(hid, dsm, ge);
          const float dpre = dsm * e * (1.f - hid * hid);
          dq += dpre;
          dK[(size_t)m * H + h] = dk + (wm * d + dpre);
        };
        int m = 0;
        for (; m + kKeyBatch <= M; m += kKeyBatch) {
          float kv[kKeyBatch], dk[kKeyBatch];
#pragma unroll
          for (int j = 0; j < kKeyBatch; ++j) {
            kv[j] = K[(size_t)(m + j) * H + h];
            dk[j] = dK[(size_t)(m + j) * H + h];
          }
#pragma unroll
          for (int j = 0; j < kKeyBatch; ++j) key(m + j, kv[j], dk[j]);
        }
        for (; m < M; ++m)
          key(m, K[(size_t)m * H + h], dK[(size_t)m * H + h]);
        gew[(size_t)team.b * gew_stride + h] = ge;
      }
      dpq_out(h, o, dq);
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The step forward, shared by both cluster kernels.
// ---------------------------------------------------------------------------

// A cluster of S CTAs over RC rows, from the view of one CTA.
template <int S, int RC>
struct Cluster {
  static constexpr int kOwn = RC / S;
  unsigned rank;
  int b0, B, C, u0, nu;
  __device__ Cluster(int B_, int H, int C_)
      : rank(cluster_rank()), b0((blockIdx.x / S) * RC), B(B_), C(C_) {
    u0 = rank * C;
    nu = max(0, min(C, H - u0));
  }
  __device__ bool valid(int r) const { return b0 + r < B; }
  // A value of row r to the CTA that runs row r's attentions.
  __device__ void to_owner(float* buf, int h, int r, float v) const {
    remote(buf, r % S)[h * kOwn + r / S] = v;
  }
  __device__ void to_owner4(float* buf, int h, int g, float4 v) const {
    to_owner(buf, h, 4 * g, v.x);
    to_owner(buf, h, 4 * g + 1, v.y);
    to_owner(buf, h, 4 * g + 2, v.z);
    to_owner(buf, h, 4 * g + 3, v.w);
  }
  __device__ void broadcast4(float* buf, int f, int g, float4 v) const {
    for (int d = 0; d < S; ++d)
      *reinterpret_cast<float4*>(remote(buf, d) + f * RC + 4 * g) = v;
  }
};

// The shared-memory buffers of a step forward. Full vectors are
// feature-major [feature][RC]; slices hold this CTA's units, [unit][RC];
// "owned" buffers hold the rows whose attentions this CTA runs.
struct StepBuffers {
  float* f_h;   // the pre-step h
  float* f_in;  // the LSTM input [emb; ctx_cmd; ctx_sit] (emb: the caller's)
  float* f_vh;  // the visual query, then the new h
  float* s_c;   // the pre-step c
  float* s_cn;  // the new c (may be s_c)
  float* s_hn;  // the new h (kStash)
  float* s_g;   // gate pre-activations [4C][RC]
  float* s_vq;  // the visual query (kStash)
  float* s_ph;  // the head's hidden layer
  float *o_pqt, *o_pqv;  // projected queries [H][kOwn]
  float *o_wt, *o_wv;    // attention weights [kOwn][M]
  float* o_sc;           // scores [kOwn][max(M_t, M_v)], scratch
  float* scratch;        // cta_product's
};

// One teacher-forced step's forward for the cluster's rows, from f_h and
// s_c (left unchanged): the textual query, the textual attention, the
// visual query, the visual attention, the gates and the cell (the new h
// broadcast into f_vh), the head's hidden layer into s_ph. kStash: also
// keep this CTA's slices of the visual query and the new h (kernel 4). The
// keys are the owned rows' copies (kOwnKeys) or the [B][M][H] tensors.
// Five cluster barriers; after_query() runs after the first, after_gates()
// once the gate product has read f_h for the last time. Ends with
// __syncthreads().
template <int S, int RC, bool kResW, bool kOwnKeys, bool kFit, bool kStash,
          typename AfterQuery, typename AfterGates>
__device__ __forceinline__ void step_forward(
    const Cluster<S, RC>& cx, const StepBuffers& b, const StepWeights& w,
    const Cols<kResW>& cols, const float* keys_txt, const float* keys_vis,
    const float* __restrict__ cmd_mask, const float* __restrict__ txt_ew,
    const float* __restrict__ vis_ew, int Mt, int Mv, int H, int E,
    AfterQuery after_query, AfterGates after_gates) {
  constexpr int kOwn = RC / S;
  const int C = cx.C, nu = cx.nu, u0 = cx.u0;
  const unsigned rank = cx.rank;
  const Seg none{nullptr, 0, nullptr};
  // Textual query slice, to the rows' attention CTAs.
  cta_product<RC>(Seg{b.f_h, H, w.txt.row(0)}, none, none, w.txt.ld, cols,
                  C, b.scratch, [&](int n, int g, float4 v) {
                    if (n < nu) cx.to_owner4(b.o_pqt, u0 + n, g, v);
                  });
  cluster_sync();
  after_query();
  // Textual attention of the owned rows; the context to every CTA.
  attend_cta<kOwn, kFit, kOwnKeys>(
      b.o_pqt, keys_txt, cmd_mask, txt_ew, Mt, H, cx.b0 + rank, S, cx.B,
      b.o_wt, b.o_sc, [&](int h, int o, float v) {
        if (h < H)
          for (int d = 0; d < S; ++d)
            remote(b.f_in, d)[(E + h) * RC + o * S + rank] = v;
      });
  cluster_sync();
  // Visual query slice tanh([h; ctx_cmd] W + b), to every CTA.
  cta_product<RC>(Seg{b.f_h, H, w.q2k.row(0)},
                  Seg{b.f_in + E * RC, H, w.q2k.row(H)}, none, w.q2k.ld,
                  cols, C, b.scratch, [&](int n, int g, float4 v) {
                    if (n >= nu) return;
                    const float bias = w.b_q2k[n];
                    v = make_float4(tanhf(v.x + bias), tanhf(v.y + bias),
                                    tanhf(v.z + bias), tanhf(v.w + bias));
                    if constexpr (kStash) at4<RC>(b.s_vq, n, g) = v;
                    cx.broadcast4(b.f_vh, u0 + n, g, v);
                  });
  cluster_sync();
  cta_product<RC>(Seg{b.f_vh, H, w.vis.row(0)}, none, none, w.vis.ld, cols,
                  C, b.scratch, [&](int n, int g, float4 v) {
                    if (n < nu) cx.to_owner4(b.o_pqv, u0 + n, g, v);
                  });
  cluster_sync();
  attend_cta<kOwn, kFit, kOwnKeys>(
      b.o_pqv, keys_vis, nullptr, vis_ew, Mv, H, cx.b0 + rank, S, cx.B,
      b.o_wv, b.o_sc, [&](int h, int o, float v) {
        if (h < H)
          for (int d = 0; d < S; ++d)
            remote(b.f_in, d)[(E + H + h) * RC + o * S + rank] = v;
      });
  cluster_sync();
  // Gate pre-activations of this CTA's units: [emb; ctx_cmd; ctx_sit] W_ih
  // + h W_hh + b.
  cta_product<RC>(Seg{b.f_in, E + 2 * H, w.gates.row(0)},
                  Seg{b.f_h, H, w.gates.row(E + 2 * H)}, none, w.gates.ld,
                  cols, 4 * C, b.scratch, [&](int n, int g, float4 v) {
                    const float bias = w.b_gate[n];
                    at4<RC>(b.s_g, n, g) = make_float4(
                        v.x + bias, v.y + bias, v.z + bias, v.w + bias);
                  });
  after_gates();
  // The cell; the new h to every CTA (over the visual query, which no CTA
  // reads after the last barrier).
  for (int i = threadIdx.x; i < nu * RC; i += kClusterThreads) {
    const int j = i / RC, r = i % RC;
    const float gi = b.s_g[j * RC + r], gf = b.s_g[(C + j) * RC + r];
    const float gg = b.s_g[(2 * C + j) * RC + r];
    const float go = b.s_g[(3 * C + j) * RC + r];
    const float cn = sigmoidf(gf) * b.s_c[i] + sigmoidf(gi) * tanhf(gg);
    const float hn = sigmoidf(go) * tanhf(cn);
    b.s_cn[i] = cn;
    if constexpr (kStash) b.s_hn[i] = hn;
    for (int d = 0; d < S; ++d) remote(b.f_vh, d)[(u0 + j) * RC + r] = hn;
  }
  cluster_sync();
  // The head's hidden layer [emb; h_new; ctx_cmd; ctx_sit] W_out.
  cta_product<RC>(Seg{b.f_in, E, w.out.row(0)},
                  Seg{b.f_vh, H, w.out.row(E)},
                  Seg{b.f_in + E * RC, 2 * H, w.out.row(E + H)}, w.out.ld,
                  cols, C, b.scratch,
                  [&](int n, int g, float4 v) { at4<RC>(b.s_ph, n, g) = v; });
}

// ---------------------------------------------------------------------------
// Kernel 3: forward_cluster_kernel.
// ---------------------------------------------------------------------------

struct ForwardArgs {
  const int* tokens;
  const float *drop, *proj_txt, *cmd_mask, *proj_vis, *h0, *c0;
  Weights wt;
  float *logits, *h_res, *c_res, *asum;
  int B, T, num_steps, Mt, Mv, H, E, V;
};

// Offsets (in floats) of kernel 3's shared memory.
template <int S, int RC>
struct ForwardLayout {
  static constexpr int kOwn = RC / S;
  WeightLayout w;
  size_t f_h, f_vh, f_in, s_c, s_g, s_ph, s_drop;
  size_t o_pqt, o_pqv, o_wt, o_wv, o_sc, o_asum, k_txt, k_vis;
  size_t recv, scratch, total;
  __host__ __device__ ForwardLayout(int H, int E, int V, int Mt, int Mv,
                                    bool resident_weights, bool own_keys) {
    size_t p = 0;
    w.place(p, S, H, E, V, resident_weights);
    const int C = w.C;
    f_h = take(p, (size_t)H * RC);
    f_vh = take(p, (size_t)H * RC);
    f_in = take(p, (size_t)(E + 2 * H) * RC);
    s_c = take(p, (size_t)C * RC);
    s_g = take(p, (size_t)4 * C * RC);
    s_ph = take(p, (size_t)C * RC);
    s_drop = take(p, (size_t)E * RC);
    o_pqt = take(p, (size_t)H * kOwn);
    o_pqv = take(p, (size_t)H * kOwn);
    o_wt = take(p, (size_t)Mt * kOwn);
    o_wv = take(p, (size_t)Mv * kOwn);
    o_sc = take(p, (size_t)(Mt > Mv ? Mt : Mv) * kOwn);
    o_asum = take(p, (size_t)Mv * kOwn);
    k_txt = own_keys ? take(p, (size_t)kOwn * Mt * H) : 0;
    k_vis = own_keys ? take(p, (size_t)kOwn * Mv * H) : 0;
    recv = take(p, (size_t)S * V * kOwn);  // logits' partial sums
    scratch = take(p, (size_t)kScratch);
    total = p;
  }
};

template <int S, int RC, bool kResW, bool kOwnKeys, bool kFit>
__global__ void __launch_bounds__(kClusterThreads, 1)
    forward_cluster_kernel(const ForwardArgs a) {
  static_assert(RC % 4 == 0 && RC % S == 0, "rows per cluster");
  constexpr int kOwn = RC / S;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int H = a.H, E = a.E, V = a.V, Mt = a.Mt, Mv = a.Mv, B = a.B;
  const ForwardLayout<S, RC> L(H, E, V, Mt, Mv, kResW, kOwnKeys);
  const Cluster<S, RC> cx(B, H, L.w.C);
  const int C = cx.C, u0 = cx.u0, nu = cx.nu, b0 = cx.b0;
  const unsigned rank = cx.rank;
  const int tid = threadIdx.x;
  float *f_h = sm + L.f_h, *f_vh = sm + L.f_vh, *f_in = sm + L.f_in;
  float *s_c = sm + L.s_c, *s_ph = sm + L.s_ph, *s_drop = sm + L.s_drop;
  float *o_wv = sm + L.o_wv, *o_asum = sm + L.o_asum, *recv = sm + L.recv;
  const float* w_proj = sm + L.w.w_proj;

  for (size_t i = tid; i < L.total; i += kClusterThreads) sm[i] = 0.f;
  __syncthreads();
  load_weights<kResW>(sm, L.w, a.wt, H, E, V, u0, nu);
  // The initial state: h in full, c in this CTA's slice.
  for (int i = tid; i < H * RC; i += kClusterThreads) {
    const int r = i / H, k = i % H;
    if (cx.valid(r)) f_h[k * RC + r] = a.h0[(size_t)(b0 + r) * H + k];
  }
  for (int i = tid; i < RC * C; i += kClusterThreads) {
    const int r = i / C, j = i % C;
    if (cx.valid(r) && j < nu)
      s_c[j * RC + r] = a.c0[(size_t)(b0 + r) * H + u0 + j];
  }
  if constexpr (kOwnKeys) {
    // The keys of the owned rows, for the whole walk.
    for (int o = 0; o < kOwn; ++o) {
      const int b = b0 + o * S + rank;
      if (b >= B) continue;
      for (int i = tid; i < Mt * H; i += kClusterThreads)
        sm[L.k_txt + (size_t)o * Mt * H + i] =
            a.proj_txt[(size_t)b * Mt * H + i];
      for (int i = tid; i < Mv * H; i += kClusterThreads)
        sm[L.k_vis + (size_t)o * Mv * H + i] =
            a.proj_vis[(size_t)b * Mv * H + i];
    }
  }
  // The dropout mask of step t, copied asynchronously: each thread later
  // reads exactly the elements it copied.
  auto fetch_drop = [&](int t) {
    const size_t tb = (size_t)t * B + b0;
    for (int i = tid; i < E * RC; i += kClusterThreads) {
      const int e = i / RC, r = i % RC;
      cp_async4(s_drop + i,
                a.drop + (tb + (cx.valid(r) ? r : 0)) * E + e, cx.valid(r));
    }
    cp_async_commit();
  };
  fetch_drop(0);
  // Every CTA of the cluster has started (its shared memory exists) before
  // any CTA writes into another's.
  cluster_sync();

  StepBuffers bufs{f_h,    f_in,          f_vh,          s_c,
                   s_c,    nullptr,       sm + L.s_g,    nullptr,
                   s_ph,   sm + L.o_pqt,  sm + L.o_pqv,  sm + L.o_wt,
                   o_wv,   sm + L.o_sc,   sm + L.scratch};
  const float* keys_txt = kOwnKeys ? sm + L.k_txt : a.proj_txt;
  const float* keys_vis = kOwnKeys ? sm + L.k_vis : a.proj_vis;
  const StepWeights w = step_weights<kResW>(L.w, sm, a.wt, H, E);
  const Cols<kResW> cols{C, H, u0, nu};
  // The logits of the owned rows at step t: the S partial sums in rank
  // order.
  auto reduce_logits = [&](int t) {
    for (int i = tid; i < kOwn * V; i += kClusterThreads) {
      const int o = i / V, v = i % V, b = b0 + o * S + rank;
      if (b >= B) continue;
      float sum = recv[v * kOwn + o];
      for (int s = 1; s < S; ++s) sum += recv[(s * V + v) * kOwn + o];
      a.logits[((size_t)t * B + b) * V + v] = sum;
    }
  };

  for (int t = 0; t < a.T; ++t) {
    const size_t tb = (size_t)t * B + b0;
    cp_async_wait<0>();
    // The teacher token's embedding times the dropout mask; the residuals.
    for (int i = tid; i < E * RC; i += kClusterThreads) {
      const int e = i / RC, r = i % RC;
      float v = 0.f;
      if (cx.valid(r)) {
        const int tok = a.tokens[tb + r];
        if (tok >= 0 && tok < V)
          v = __ldg(a.wt.emb + (size_t)tok * E + e) * s_drop[i];
      }
      f_in[i] = v;
    }
    if (t + 1 < a.T) fetch_drop(t + 1);
    for (int i = tid; i < RC * nu; i += kClusterThreads) {
      const int r = i / nu, j = i % nu;
      if (!cx.valid(r)) continue;
      a.h_res[(tb + r) * H + u0 + j] = f_h[(u0 + j) * RC + r];
      a.c_res[(tb + r) * H + u0 + j] = s_c[j * RC + r];
    }
    bufs.f_h = f_h;
    bufs.f_vh = f_vh;
    step_forward<S, RC, kResW, kOwnKeys, kFit, false>(
        cx, bufs, w, cols, keys_txt, keys_vis, a.cmd_mask, a.wt.txt_ew,
        a.wt.vis_ew, Mt, Mv, H, E, [&] {
          if (t > 0) reduce_logits(t - 1);
        },
        [] {});
    if (t < a.num_steps) {
      for (int i = tid; i < kOwn * Mv; i += kClusterThreads) {
        const int b = b0 + (i / Mv) * S + rank;
        if (b < B) o_asum[i] += o_wv[i];
      }
    }
    // This CTA's partial sums of the logits, to the rows' owners (added
    // after the next step's first barrier).
    for (int i = tid; i < V * RC; i += kClusterThreads) {
      const int v = i / RC, r = i % RC;
      float acc = 0.f;
      for (int j = 0; j < nu; ++j)
        acc = fmaf(s_ph[j * RC + r], w_proj[j * V + v], acc);
      remote(recv, r % S)[(rank * V + v) * kOwn + r / S] = acc;
    }
    // The new h (in f_vh) is the next step's h.
    float* swap = f_h;
    f_h = f_vh;
    f_vh = swap;
  }
  cluster_sync();
  reduce_logits(a.T - 1);
  for (int i = tid; i < kOwn * Mv; i += kClusterThreads) {
    const int b = b0 + (i / Mv) * S + rank;
    if (b < B) a.asum[(size_t)b * Mv + i % Mv] = o_asum[i];
  }
}

// ---------------------------------------------------------------------------
// Kernel 4: backward_cluster_kernel.
// ---------------------------------------------------------------------------

// Offsets (in floats) of kernel 4's shared memory.
template <int S, int RC>
struct BackwardLayout {
  static constexpr int kOwn = RC / S;
  WeightLayout w;
  int WR;
  size_t f_h, f_in, f_vh;  // full vectors: h, [emb; ctx_cmd; ctx_sit], vq|h_new
  size_t s_c, s_cn, s_g, s_vq, s_hn, s_ph, s_dph, s_dg, s_dpqv, s_djp, s_djt,
      s_dpqt, s_dh, s_dc, s_dpre, s_dli, s_dlog;  // this CTA's slices
  size_t o_pqt, o_pqv, o_dcs, o_dcc, o_wt, o_wv, o_dw;
  size_t recv, scratch, total;
  __host__ __device__ BackwardLayout(int H, int E, int V, int Mt, int Mv,
                                     bool resident_weights) {
    size_t p = 0;
    w.place(p, S, H, E, V, resident_weights);
    const int C = w.C;
    WR = w.CE + 3 * C;
    f_h = take(p, (size_t)H * RC);
    f_in = take(p, (size_t)(E + 2 * H) * RC);
    f_vh = take(p, (size_t)H * RC);
    s_c = take(p, C * RC);
    s_cn = take(p, C * RC);
    s_g = take(p, 4 * C * RC);
    s_vq = take(p, C * RC);
    s_hn = take(p, C * RC);
    s_ph = take(p, C * RC);
    s_dph = take(p, C * RC);
    s_dg = take(p, 4 * C * RC);
    s_dpqv = take(p, C * RC);
    s_djp = take(p, C * RC);
    s_djt = take(p, 2 * C * RC);
    s_dpqt = take(p, C * RC);
    s_dh = take(p, C * RC);
    s_dc = take(p, C * RC);
    s_dpre = take(p, (size_t)WR * RC);
    s_dli = take(p, (size_t)WR * RC);
    s_dlog = take(p, (size_t)V * RC);
    o_pqt = take(p, (size_t)H * kOwn);
    o_pqv = take(p, (size_t)H * kOwn);
    o_dcs = take(p, (size_t)H * kOwn);
    o_dcc = take(p, (size_t)H * kOwn);
    o_wt = take(p, (size_t)Mt * kOwn);
    o_wv = take(p, (size_t)Mv * kOwn);
    o_dw = take(p, (size_t)(Mt > Mv ? Mt : Mv) * kOwn);
    recv = take(p, (size_t)S * WR * RC);
    scratch = take(p, (size_t)kScratch);
    total = p;
  }
};

struct BackwardArgs {
  const int* tokens;
  const float *drop, *proj_txt, *cmd_mask, *proj_vis, *h_res, *c_res,
      *dlogits, *g_asum;
  Weights wt;
  float *d_proj_txt, *d_proj_vis, *dh0, *dc0, *stash;
  int B, T, num_steps, Mt, Mv, H, E, V;
};

template <int S, int RC, bool kResW, bool kFit>
__global__ void __launch_bounds__(kClusterThreads, 1)
    backward_cluster_kernel(const BackwardArgs a) {
  static_assert(RC % 4 == 0 && RC % S == 0, "rows per cluster");
  constexpr int G = RC / 4;
  constexpr int kOwn = RC / S;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int H = a.H, E = a.E, V = a.V, Mt = a.Mt, Mv = a.Mv, B = a.B;
  const BackwardLayout<S, RC> L(H, E, V, Mt, Mv, kResW);
  const Cluster<S, RC> cx(B, H, L.w.C);
  const int C = cx.C, CE = L.w.CE, WR = L.WR;
  const unsigned rank = cx.rank;
  const int u0 = cx.u0, nu = cx.nu;
  const int e0 = rank * CE, ne = max(0, min(CE, E - e0));
  const int tid = threadIdx.x;
  const int b0 = cx.b0;
  const Stash lay(V, E, H);
  const int G4 = 4 * C;

  float *w_proj = sm + L.w.w_proj;
  float *f_h = sm + L.f_h, *f_in = sm + L.f_in, *f_vh = sm + L.f_vh;
  float *s_c = sm + L.s_c, *s_cn = sm + L.s_cn, *s_g = sm + L.s_g;
  float *s_vq = sm + L.s_vq, *s_hn = sm + L.s_hn, *s_ph = sm + L.s_ph;
  float *s_dph = sm + L.s_dph, *s_dg = sm + L.s_dg, *s_dpqv = sm + L.s_dpqv;
  float *s_djp = sm + L.s_djp, *s_djt = sm + L.s_djt, *s_dpqt = sm + L.s_dpqt;
  float *s_dh = sm + L.s_dh, *s_dc = sm + L.s_dc, *s_dpre = sm + L.s_dpre;
  float *s_dli = sm + L.s_dli, *s_dlog = sm + L.s_dlog;
  float *o_pqt = sm + L.o_pqt, *o_pqv = sm + L.o_pqv;
  float *o_dcs = sm + L.o_dcs, *o_dcc = sm + L.o_dcc;
  float *o_wt = sm + L.o_wt, *o_wv = sm + L.o_wv, *o_dw = sm + L.o_dw;
  float *recv = sm + L.recv, *scratch = sm + L.scratch;

  for (size_t i = tid; i < L.total; i += kClusterThreads) sm[i] = 0.f;
  __syncthreads();
  const Weights& wt = a.wt;
  load_weights<kResW>(sm, L.w, wt, H, E, V, u0, nu);
  // Every CTA of the cluster has started (its shared memory exists) before
  // any CTA writes into another's.
  cluster_sync();

  const StepWeights w = step_weights<kResW>(L.w, sm, wt, H, E);
  const Cols<kResW> cols{C, H, u0, nu};
  const StepBuffers bufs{f_h,   f_in,  f_vh, s_c,  s_cn, s_hn,
                         s_g,   s_vq,  s_ph, o_pqt, o_pqv, o_wt,
                         o_wv,  o_dw,  scratch};
  auto valid = [&](int r) { return cx.valid(r); };
  auto at = [&](float* buf, int f, int g) -> float4& {
    return at4<RC>(buf, f, g);
  };
  // Reduce-scatter: the partial sum of output j in the layout [E | H | H | H]
  // (E features sliced by CE, each H block by C) goes to slot `rank` of the
  // receive buffer of the CTA that owns j.
  auto push_e3h = [&](int j, int g, float4 v) {
    int owner, local;
    if (j < E) {
      owner = j / CE;
      local = j % CE;
    } else {
      const int seg = (j - E) / H, u = (j - E) % H;
      owner = u / C;
      local = CE + seg * C + u % C;
    }
    *reinterpret_cast<float4*>(remote(recv, owner) +
                               ((size_t)rank * WR + local) * RC + 4 * g) = v;
  };
  // The same for outputs in blocks of H, the block's slice at `first` + seg*C.
  auto push_h = [&](int j, int g, float4 v, int first) {
    const int seg = j / H, u = j % H;
    *reinterpret_cast<float4*>(
        remote(recv, u / C) +
        ((size_t)rank * WR + first + seg * C + u % C) * RC + 4 * g) = v;
  };
  // Sum slots 0 .. S-1 of receive columns [first, first + n), in rank order.
  auto reduce = [&](int first, int n, auto store) {
    for (int t = tid; t < n * G; t += kClusterThreads) {
      const int l = t / G, g = t % G;
      float4 sum = at(recv, first + l, g);
      for (int s = 1; s < S; ++s) add4(sum, at(recv, s * WR + first + l, g));
      store(l, g, sum);
    }
  };

  // The step inputs, copied asynchronously into their buffers as soon as
  // the step before has read them for the last time: h in full, c in this
  // CTA's slice, the logits' cotangent.
  auto fetch_h = [&](int t) {
    const size_t tb = (size_t)t * B + b0;
    for (int i = tid; i < H * RC; i += kClusterThreads) {
      const int r = i / H, k = i % H;
      cp_async4(f_h + k * RC + r,
                a.h_res + (tb + (valid(r) ? r : 0)) * H + k, valid(r));
    }
    cp_async_commit();
  };
  auto fetch_c = [&](int t) {
    const size_t tb = (size_t)t * B + b0;
    for (int i = tid; i < RC * C; i += kClusterThreads) {
      const int r = i / C, j = i % C;
      const bool in = valid(r) && j < nu;
      cp_async4(s_c + j * RC + r,
                a.c_res + (tb + (in ? r : 0)) * H + (in ? u0 + j : 0), in);
    }
    cp_async_commit();
  };
  auto fetch_dlog = [&](int t) {
    const size_t tb = (size_t)t * B + b0;
    for (int i = tid; i < RC * V; i += kClusterThreads) {
      const int r = i / V, v = i % V;
      cp_async4(s_dlog + v * RC + r,
                a.dlogits + (tb + (valid(r) ? r : 0)) * V + v, valid(r));
    }
    cp_async_commit();
  };
  fetch_h(a.T - 1);
  fetch_c(a.T - 1);
  fetch_dlog(a.T - 1);

  for (int t = a.T - 1; t >= 0; --t) {
    const size_t tb = (size_t)t * B + b0;
    cp_async_wait<0>();
    for (int i = tid; i < E * RC; i += kClusterThreads) {
      const int e = i / RC, r = i % RC;
      float v = 0.f;
      if (valid(r)) {
        const int tok = a.tokens[tb + r];
        if (tok >= 0 && tok < V)
          v = __ldg(wt.emb + (size_t)tok * E + e) * a.drop[(tb + r) * E + e];
      }
      f_in[i] = v;
    }
    __syncthreads();

    // --- The step's forward, recomputed (h is not read again in the step
    // once the gate product has run).
    step_forward<S, RC, kResW, false, kFit, true>(
        cx, bufs, w, cols, a.proj_txt, a.proj_vis, a.cmd_mask, wt.txt_ew,
        wt.vis_ew, Mt, Mv, H, E,
        [] {},
        [&] {
          if (t > 0) fetch_h(t - 1);
        });

    // --- The step's backward.
    // d_ph = dlogits out_proj^T, this CTA's units.
    for (int t2 = tid; t2 < C * G; t2 += kClusterThreads) {
      const int j = t2 / G, g = t2 % G;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int v = 0; v < V; ++v)
        fma4v(acc, at(s_dlog, v, g), w_proj[j * V + v]);
      at(s_dph, j, g) = acc;
    }
    __syncthreads();
    if (t > 0) fetch_dlog(t - 1);
    // d [emb; h_new; ctx_cmd; ctx_sit] = d_ph out_w^T.
    cta_partial<RC>(s_dph, 1, w.out, cols, E + 3 * H, push_e3h);
    cluster_sync();
    reduce(0, WR, [&](int l, int g, float4 v) { at(s_dpre, l, g) = v; });
    cluster_arrive();  // this CTA is done reading its receive buffer
    __syncthreads();
    // The cell's backward; dc becomes the gradient of the pre-step c.
    for (int i = tid; i < nu * RC; i += kClusterThreads) {
      const int j = i / RC, r = i % RC;
      const float si = sigmoidf(s_g[j * RC + r]);
      const float sf = sigmoidf(s_g[(C + j) * RC + r]);
      const float tg = tanhf(s_g[(2 * C + j) * RC + r]);
      const float so = sigmoidf(s_g[(3 * C + j) * RC + r]);
      const float c = s_c[i];
      const float tc = tanhf(s_cn[i]);
      const float dh_new = s_dh[i] + s_dpre[(CE + j) * RC + r];
      const float dct = s_dc[i] + dh_new * so * (1.f - tc * tc);
      s_dg[j * RC + r] = dct * tg * si * (1.f - si);
      s_dg[(C + j) * RC + r] = dct * c * sf * (1.f - sf);
      s_dg[(2 * C + j) * RC + r] = dct * si * (1.f - tg * tg);
      s_dg[(3 * C + j) * RC + r] = dh_new * tc * so * (1.f - so);
      s_dc[i] = dct * sf;
    }
    __syncthreads();
    if (t > 0) fetch_c(t - 1);
    cluster_wait();
    // d [emb; ctx_cmd; ctx_sit] = d_gates w_ih^T, dh_lstm = d_gates w_hh^T.
    cta_partial<RC>(s_dg, 4, w.gates, cols, E + 3 * H, push_e3h);
    cluster_sync();
    reduce(0, WR, [&](int l, int g, float4 v) { at(s_dli, l, g) = v; });
    __syncthreads();
    // The visual context's cotangent, to the rows' attention CTAs.
    for (int i = tid; i < nu * RC; i += kClusterThreads) {
      const int j = i / RC, r = i % RC;
      cx.to_owner(o_dcs, u0 + j, r,
                  s_dli[(CE + C + j) * RC + r] +
                      s_dpre[(CE + 2 * C + j) * RC + r]);
    }
    cluster_sync();
    // Visual attention backward, with the summed attention's cotangent on
    // the valid steps; d_pq_vis back to the units' CTAs.
    attend_cta_backward<kOwn, kFit>(
        o_pqv, o_dcs, a.proj_vis, o_wv, wt.vis_ew, a.g_asum,
        t < a.num_steps ? 1.f : 0.f, Mv, H, b0 + rank, S, B, a.d_proj_vis,
        a.stash + (size_t)t * B * lay.width + lay.g_vis_ew, lay.width, o_dw,
        [&](int h, int o, float v) {
          if (h < H) remote(s_dpqv, h / C)[(h % C) * RC + o * S + rank] = v;
        });
    cluster_sync();
    // d of the visual query = d_pq_vis vis_qw^T; times tanh' its
    // pre-activation's.
    cta_partial<RC>(s_dpqv, 1, w.vis, cols, H, [&](int j, int g, float4 v) {
      push_h(j, g, v, 0);
    });
    cluster_sync();
    reduce(0, C, [&](int l, int g, float4 v) {
      const float4 q = at(s_vq, l, g);
      at(s_djp, l, g) = make_float4(v.x * (1.f - q.x * q.x),
                                    v.y * (1.f - q.y * q.y),
                                    v.z * (1.f - q.z * q.z),
                                    v.w * (1.f - q.w * q.w));
    });
    __syncthreads();
    // d [h; ctx_cmd] of the visual query = d_joint q2k_w^T (receive columns
    // C .. 3C, which the reduce above does not read).
    cta_partial<RC>(s_djp, 1, w.q2k, cols, 2 * H, [&](int j, int g, float4 v) {
      push_h(j, g, v, C);
    });
    cluster_sync();
    reduce(C, 2 * C, [&](int l, int g, float4 v) { at(s_djt, l, g) = v; });
    __syncthreads();
    for (int i = tid; i < nu * RC; i += kClusterThreads) {
      const int j = i / RC, r = i % RC;
      cx.to_owner(o_dcc, u0 + j, r,
                  (s_dli[(CE + j) * RC + r] + s_dpre[(CE + C + j) * RC + r]) +
                      s_djt[(C + j) * RC + r]);
    }
    cluster_sync();
    // Textual attention backward; d_pq_txt back to the units' CTAs.
    attend_cta_backward<kOwn, kFit>(
        o_pqt, o_dcc, a.proj_txt, o_wt, wt.txt_ew, nullptr, 0.f, Mt, H,
        b0 + rank, S, B, a.d_proj_txt,
        a.stash + (size_t)t * B * lay.width + lay.g_txt_ew, lay.width, o_dw,
        [&](int h, int o, float v) {
          if (h < H) remote(s_dpqt, h / C)[(h % C) * RC + o * S + rank] = v;
        });
    cluster_sync();
    // dh of the pre-step state: dh_lstm + dh_joint + d_pq_txt txt_qw^T.
    cta_partial<RC>(s_dpqt, 1, w.txt, cols, H, [&](int j, int g, float4 v) {
      push_h(j, g, v, 0);
    });
    cluster_sync();
    reduce(0, C, [&](int l, int g, float4 v) {
      const float4 lstm = at(s_dli, CE + 2 * C + l, g);
      const float4 joint = at(s_djt, l, g);
      at(s_dh, l, g) = make_float4((lstm.x + joint.x) + v.x,
                                   (lstm.y + joint.y) + v.y,
                                   (lstm.z + joint.z) + v.z,
                                   (lstm.w + joint.w) + v.w);
    });
    // The row-step's operands for the weight gradients, this CTA's slices.
    for (int i = tid; i < RC * lay.emb; i += kClusterThreads) {
      const int r = i / lay.emb, v = i % lay.emb;  // one-hot, then zeros
      if (rank == 0 && valid(r))
        a.stash[(tb + r) * lay.width + lay.onehot + v] =
            a.tokens[tb + r] == v ? 1.f : 0.f;
    }
    for (int i = tid; i < RC * ne; i += kClusterThreads) {
      const int r = i / ne, l = i % ne, e = e0 + l;
      if (!valid(r)) continue;
      float* row = a.stash + (tb + r) * lay.width;
      row[lay.emb + e] = f_in[e * RC + r];
      row[lay.d_emb + e] =
          (s_dli[l * RC + r] + s_dpre[l * RC + r]) * a.drop[(tb + r) * E + e];
    }
    for (int i = tid; i < RC * nu; i += kClusterThreads) {
      const int r = i / nu, j = i % nu, u = u0 + j;
      if (!valid(r)) continue;
      float* row = a.stash + (tb + r) * lay.width;
      row[lay.h_new + u] = s_hn[j * RC + r];
      row[lay.ctx_cmd + u] = f_in[(E + u) * RC + r];
      row[lay.ctx_sit + u] = f_in[(E + H + u) * RC + r];
      row[lay.ph + u] = s_ph[j * RC + r];
      row[lay.vq + u] = s_vq[j * RC + r];
      row[lay.d_ph + u] = s_dph[j * RC + r];
      for (int g = 0; g < 4; ++g)
        row[lay.d_gates + g * H + u] = s_dg[(g * C + j) * RC + r];
      row[lay.d_pq_vis + u] = s_dpqv[j * RC + r];
      row[lay.d_joint + u] = s_djp[j * RC + r];
      row[lay.d_pq_txt + u] = s_dpqt[j * RC + r];
    }
    __syncthreads();
  }

  for (int i = tid; i < RC * nu; i += kClusterThreads) {
    const int r = i / nu, j = i % nu;
    if (valid(r)) {
      a.dh0[(size_t)(b0 + r) * H + u0 + j] = s_dh[j * RC + r];
      a.dc0[(size_t)(b0 + r) * H + u0 + j] = s_dc[j * RC + r];
    }
  }
  // No CTA leaves while another may still write into its shared memory.
  cluster_sync();
}

// ---------------------------------------------------------------------------
// The helper kernels: the weight gradients out = X^T dY, summed over N
// row-steps of the stash, for 14 products (~241k outputs at H = E = 100,
// ~1.58M at H = E = 256).
//
// Bound on the H100: operations (2 flops per output per row-step) over the
// stash read once. A CTA owns one tile of one product's output AND one
// chunk of the N row-steps, so a grid holds tiles x chunks CTAs (the chunk
// count is the one whose waves of resident CTAs take least time). The X and
// dY rows of the chunk go through shared memory 32 rows at a time in 3
// stages of cp.async (16 bytes at a time where the rows are aligned), so
// later rows load while the current ones are summed. Two tile sizes, two
// kernels:
// - weight_grads_kernel: a 64 x 64 tile, each thread a 4 x 4 block of
//   outputs; each 32-row block is summed on its own and added to the
//   chunk's sum with Kahan compensation. 4 CTAs per SM. It takes the
//   products whose outputs a 128 x 256 tile would pad by more than a
//   quarter: every product at H = E = 100 and 136, so those widths keep
//   their numbers.
// - weight_grads_wide_kernel: the other products take product_core.cuh's
//   128 x 256 tile, each thread an 8 x 16 block (128 fmas per 24 floats
//   read from shared memory); its sums run in row-step order over runs of
//   at most kMaxChain row-steps, one run a chunk where the room for chunks
//   allows, else each run's sums added in order to the chunk's. The
//   4 x 4 tile's compensated blocks would take it to 8 x 8 blocks (192
//   registers of sums a thread), where shared memory, not the FMA pipe,
//   bounds it: 30.7 against 44.0 TFLOP/s (PERF.md).
// A third kernel adds the chunks' sums in chunk order, compensated. A sum
// over row-steps alone (a bias, an energy vector) is a product with a
// column of ones: the last column of a small product's X, or a one-row
// product of its own (a wide product's bias row); in such a one-row
// product only the threads of row 0 sum. The order of every sum is fixed
// by the shapes and the card: no atomics.
// ---------------------------------------------------------------------------
constexpr int kMaxProblems = 16;
constexpr int kTileI = 64, kTileJ = 64, kRowsPerStage = 32, kStages = 3;
constexpr int kGradThreads = 256;
constexpr int kSplits = 12;  // at most this many chunks of row-steps
static_assert(kRowsPerStage == gscan::core::kDepth, "one stage, one block");

struct GradProblem {
  const float* x;   // [N, ldx] from column 0; null: a column of ones
  const float* dy;  // [N, ldy] from column 0
  float* out;       // [rows, cols] row-major
  int ldx, ldy, rows, cols;
  // Non-null: X has a last column of ones (row rows - 1 of the output, the
  // sum of dY over the row-steps), and that output row goes here.
  float* out_ones;
  int tile0, tiles_j;
  size_t part0;     // offset of this product in each chunk's partial sums
  int splits;       // chunks of row-steps of its kernel
  bool vec_x, vec_y;  // rows 16-byte aligned: load 4 floats at a time
  bool transposed;  // out is [cols, rows]: the product of out^T
};

struct GradProblems {
  GradProblem p[kMaxProblems];
  int count, N, chunk, splits, tiles;
  size_t outputs;  // sum of rows * cols
};

__device__ __forceinline__ void kahan_add(float& sum, float& comp, float v) {
  const float y = v - comp;
  const float t = sum + y;
  comp = (t - sum) - y;
  sum = t;
}

// Four columns c .. c+3 (of `limit` valid ones) of row n of a [N, ld]
// operand into dst, zero past the limit or when the row is out of range.
__device__ __forceinline__ void load4(float* dst, const float* base, int ld,
                                      bool vec, int n, bool in_n, int c,
                                      int limit) {
  const float* row = base + (size_t)n * ld;
  if (vec) {
    const int valid = in_n ? max(0, min(4, limit - c)) : 0;
    cp_async16(dst, row + (c < limit ? c : 0), 4 * valid);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async4(dst + q, row + min(c + q, limit - 1), in_n && c + q < limit);
  }
}

// blockIdx.x = split * tiles + tile. Writes the chunk's sums to
// partial[split * outputs + part0 + i * cols + j].
// Compiled for 4 resident CTAs per SM (64 registers a thread): measured
// 1.06x faster than for 1 or 2 (PERF.md).
constexpr int kHelperMinBlocks = 4;
__global__ void __launch_bounds__(kGradThreads, kHelperMinBlocks)
    weight_grads_kernel(const GradProblems probs,
                        float* __restrict__ partial) {
  __shared__ __align__(16) float xs[kStages][kRowsPerStage][kTileI];
  __shared__ __align__(16) float ds[kStages][kRowsPerStage][kTileJ];
  const int tile = blockIdx.x % probs.tiles, split = blockIdx.x / probs.tiles;
  int k = 0;
  while (k + 1 < probs.count && probs.p[k + 1].tile0 <= tile) ++k;
  const GradProblem& P = probs.p[k];
  const int local = tile - P.tile0;
  const int i0 = (local / P.tiles_j) * kTileI, j0 = (local % P.tiles_j) * kTileJ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int n_begin = split * probs.chunk;
  const int n_end = min(probs.N, n_begin + probs.chunk);
  const int stages = (n_end - n_begin + kRowsPerStage - 1) / kRowsPerStage;
  // Threads whose rows are all past the product's last (a one-row product
  // of a column of ones, the embedding's V rows) sum nothing.
  const bool active = ty * 4 < P.rows - i0;

  // One stage: rows n_begin + s * 32 .. +32 of X (columns i0..i0+63) and dY
  // (j0..j0+63); out-of-range elements are zero-filled.
  auto load = [&](int s, int buf) {
    const int n0 = n_begin + s * kRowsPerStage;
    for (int e = threadIdx.x; e < kRowsPerStage * kTileI / 4;
         e += kGradThreads) {
      const int nn = e / (kTileI / 4), c = e % (kTileI / 4) * 4;
      const int n = min(n0 + nn, probs.N - 1);
      const bool in_n = n0 + nn < n_end;
      const int ones = P.out_ones != nullptr ? P.rows - 1 - i0 : -1;
      if (ones >= c && ones < c + 4) {
        // The chunk that holds the column of ones: data, then ones, then 0.
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c + q < ones)
            cp_async4(&xs[buf][nn][c + q],
                      P.x + (size_t)n * P.ldx + i0 + c + q, in_n);
          else
            xs[buf][nn][c + q] = in_n && c + q == ones ? 1.f : 0.f;
        }
      } else if (P.x != nullptr) {
        load4(&xs[buf][nn][c], P.x + i0, P.ldx, P.vec_x, n, in_n, c,
              P.rows - i0 - (P.out_ones != nullptr));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xs[buf][nn][c + q] = in_n && i0 + c + q < P.rows ? 1.f : 0.f;
      }
      load4(&ds[buf][nn][c], P.dy + j0, P.ldy, P.vec_y, n, in_n, c,
            P.cols - j0);
    }
    cp_async_commit();
  };

  float acc[4][4], comp[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = comp[a][b] = 0.f;
  for (int s = 0; s < min(stages, kStages - 1); ++s) load(s, s);
  for (int s = 0; s < stages; ++s) {
    const int buf = s % kStages;
    if (s + kStages - 1 < stages) {
      load(s + kStages - 1, (s + kStages - 1) % kStages);
      cp_async_wait<kStages - 1>();
    } else if (s + 1 < stages) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) part[a][b] = 0.f;
    if (active)
#pragma unroll 8
      for (int nn = 0; nn < kRowsPerStage; ++nn) {
        const float4 xv =
            *reinterpret_cast<const float4*>(&xs[buf][nn][ty * 4]);
        const float4 dv =
            *reinterpret_cast<const float4*>(&ds[buf][nn][tx * 4]);
        const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
        const float da[4] = {dv.x, dv.y, dv.z, dv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b)
            part[a][b] = fmaf(xa[a], da[b], part[a][b]);
      }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) kahan_add(acc[a][b], comp[a][b], part[a][b]);
    __syncthreads();  // the buffer is free for the next load into it
  }
  float* out = partial + (size_t)split * probs.outputs + P.part0;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + ty * 4 + a, j = j0 + tx * 4 + b;
      if (i < P.rows && j < P.cols) out[(size_t)i * P.cols + j] = acc[a][b];
    }
}

// The wide products (no column of ones): blockIdx.x = split * tiles +
// tile, a 128 x 256 tile of product_core.cuh over one chunk of row-steps
// (its sums in k order, at most kMaxChain row-steps a chunk); the chunk's
// sums to partial as weight_grads_kernel's. One CTA per SM: the ring is
// 147 KB of dynamic shared memory and a thread's 128 sums and two rows of
// operands take ~240 registers.
__global__ void __launch_bounds__(gscan::core::kThreads, 1)
    weight_grads_wide_kernel(const GradProblems probs,
                             float* __restrict__ partial) {
  namespace core = gscan::core;
  extern __shared__ float4 wide_smem4[];
  float* smem = reinterpret_cast<float*>(wide_smem4);
  const int tile = blockIdx.x % probs.tiles, split = blockIdx.x / probs.tiles;
  int k = 0;
  while (k + 1 < probs.count && probs.p[k + 1].tile0 <= tile) ++k;
  const GradProblem& P = probs.p[k];
  const int local = tile - P.tile0;
  const int i0 = (local / P.tiles_j) * core::kTileM;
  const int j0 = (local % P.tiles_j) * core::kTileN;
  const int n_begin = split * probs.chunk;
  const int n_end = min(probs.N, n_begin + probs.chunk);
  const int stages = (n_end - n_begin + core::kDepth - 1) / core::kDepth;
  float* out = partial + (size_t)split * probs.outputs + P.part0;
  // A thread's columns come in runs of 4: one float4 each where the run is
  // whole and 16-byte aligned.
  const bool vec = (reinterpret_cast<uintptr_t>(out) | P.cols * 4) % 16 == 0;
  using Sums = float[core::kRows][core::kCols];
  // The sums of stages [r0, r0 + count) into acc.
  const auto sums = [&](int r0, int count, Sums& acc) {
    core::tile_sums(count, smem,
                    [&](int s, float* a, float* b) {
                      const int n0 = n_begin + (r0 + s) * core::kDepth;
                      const int rows = min(core::kDepth, n_end - n0);
                      core::load_stage<core::kTileM>(
                          a, P.x + (size_t)n0 * P.ldx + i0, P.ldx, rows,
                          P.rows - i0, P.vec_x);
                      core::load_stage<core::kTileN>(
                          b, P.dy + (size_t)n0 * P.ldy + j0, P.ldy, rows,
                          P.cols - j0, P.vec_y);
                    },
                    acc);
  };
  // acc into out (add: added to what out holds).
  const auto store = [&](const Sums& acc, bool add) {
#pragma unroll
    for (int a = 0; a < core::kRows; ++a) {
      const int i = i0 + core::row_of(a);
      if (i >= P.rows) continue;
#pragma unroll
      for (int run = 0; run < core::kCols / 4; ++run) {
        const int j = j0 + core::col_of(4 * run);
        float* dst = out + (size_t)i * P.cols + j;
        if (vec && j + 3 < P.cols) {
          float4 v = make_float4(acc[a][4 * run], acc[a][4 * run + 1],
                                 acc[a][4 * run + 2], acc[a][4 * run + 3]);
          if (add) {
            const float4 sum = *reinterpret_cast<const float4*>(dst);
            v = make_float4(sum.x + v.x, sum.y + v.y, sum.z + v.z,
                            sum.w + v.w);
          }
          *reinterpret_cast<float4*>(dst) = v;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (j + q < P.cols)
              dst[q] = add ? dst[q] + acc[a][4 * run + q]
                           : acc[a][4 * run + q];
        }
      }
    }
  };
  // No sum runs over more than kMaxChain row-steps: a longer chunk is
  // summed in runs, each run's sums added in order to the chunk's in out.
  // The first run apart: in the loop below, the one-run chunks of W3
  // (H = E = 256) took 1.017 against 0.948 ms (PERF.md).
  constexpr int kRunStages = core::kMaxChain / core::kDepth;
  {
    Sums acc;
    sums(0, min(kRunStages, stages), acc);
    store(acc, false);
  }
  for (int r0 = kRunStages; r0 < stages; r0 += kRunStages) {
    Sums acc;
    sums(r0, min(kRunStages, stages - r0), acc);
    store(acc, true);
  }
}

// Adds the chunks' sums of every output in chunk order, compensated.
__global__ void __launch_bounds__(256) weight_grads_combine_kernel(
    const GradProblems probs, const float* __restrict__ partial) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= probs.outputs) return;
  int k = 0;
  while (k + 1 < probs.count && probs.p[k + 1].part0 <= e) ++k;
  const GradProblem& P = probs.p[k];
  const size_t local = e - P.part0;
  // Every chunk's load issued before the first add.
  float v[kSplits];
#pragma unroll
  for (int s = 0; s < kSplits; ++s)
    v[s] = s < P.splits ? partial[(size_t)s * probs.outputs + e] : 0.f;
  float sum = 0.f, comp = 0.f;
#pragma unroll
  for (int s = 0; s < kSplits; ++s)
    if (s < P.splits) kahan_add(sum, comp, v[s]);
  const size_t last = (size_t)(P.rows - 1) * P.cols;
  if (P.out_ones != nullptr && local >= last)
    P.out_ones[local - last] = sum;
  else if (P.transposed)
    P.out[(local % P.cols) * P.rows + local / P.cols] = sum;
  else
    P.out[local] = sum;
}

// ---------------------------------------------------------------------------
// Plans and launches.
// ---------------------------------------------------------------------------

// The plans, tried in order: the first that fits the device's shared memory
// per CTA (and, for the L2 plans, the width) is taken. The cluster plans:
// rows per cluster 16 (at B = 200, 13 clusters in one wave; kernel 4 with 8
// took 1.4x as long in two waves, PERF.md), or 8 where the activations of 16
// do not fit; their weights resident in shared memory, or read from L2 in
// every product. Past the resident plans the L2 plans measured faster than
// the grid plan (teacher_forced_grid.cu) only at narrow widths and few keys
// (scripts/torch_kernel_ab.py --teacher-forced, PERF.md): kernel 3's up to
// H = 320 with H (M_t + M_v) <= 18,432 (at M_t + M_v = 52 it won to H =
// 320; at W3, H = 256 with 216 keys, it took 17.0 ms against 11.9), kernel
// 4's up to H = 192. Past them the grid plan, which takes every shape.
constexpr int kForwardL2MaxHidden = 320;
constexpr int kForwardL2MaxKeyWork = 18432;
constexpr int kBackwardL2MaxHidden = 192;
struct Plan {
  bool resident_weights, own_keys;
  int rows;
  const char* name;
  bool grid;         // teacher_forced_grid.cu's grid plan
  int max_hidden;    // the widest H the plan takes (0: any)
  int max_key_work;  // the largest H (M_t + M_v) it takes (0: any)
};
constexpr Plan kForwardPlans[] = {
    {true, true, 16, "weights+keys in smem, 16 rows", false, 0, 0},
    {true, false, 16, "weights in smem, keys from L2, 16 rows", false, 0, 0},
    {false, false, 16, "weights+keys from L2, 16 rows", false,
     kForwardL2MaxHidden, kForwardL2MaxKeyWork},
    {false, false, 0, "grid plan, one CTA per SM", true, 0, 0},
};
constexpr Plan kBackwardPlans[] = {
    {true, false, 16, "weights in smem, 16 rows", false, 0, 0},
    {false, false, 16, "weights from L2, 16 rows", false,
     kBackwardL2MaxHidden, 0},
    {false, false, 8, "weights from L2, 8 rows", false, kBackwardL2MaxHidden,
     0},
    {false, false, 0, "grid plan, one CTA per SM", true, 0, 0},
};
constexpr int kForwardPlanCount = sizeof(kForwardPlans) / sizeof(Plan);
constexpr int kBackwardPlanCount = sizeof(kBackwardPlans) / sizeof(Plan);

const Plan* find_plan(int kernel, int plan) {
  if (kernel == 3 && plan >= 0 && plan < kForwardPlanCount)
    return &kForwardPlans[plan];
  if (kernel == 4 && plan >= 0 && plan < kBackwardPlanCount)
    return &kBackwardPlans[plan];
  return nullptr;
}

// Bytes of shared memory per CTA of `kernel`'s plan at these shapes.
size_t plan_smem_bytes(int kernel, const Plan& p, int H, int E, int V, int Mt,
                       int Mv) {
  if (p.grid) return gscan_teacher_forced_grid_smem_bytes(H, Mt, Mv);
  size_t floats;
  if (kernel == 3)
    floats = ForwardLayout<kClusterSize, 16>(H, E, V, Mt, Mv,
                                             p.resident_weights, p.own_keys)
                 .total;
  else if (p.rows == 16)
    floats = BackwardLayout<kClusterSize, 16>(H, E, V, Mt, Mv,
                                              p.resident_weights)
                 .total;
  else
    floats = BackwardLayout<kClusterSize, 8>(H, E, V, Mt, Mv,
                                             p.resident_weights)
                 .total;
  return floats * sizeof(float);
}

bool valid_shapes(int B, int T, int Mt, int Mv, int H, int E, int V) {
  return B > 0 && T > 0 && H > 0 && Mt > 0 && Mv > 0 && E > 0 && V > 0;
}

// One cluster of kClusterSize CTAs per `rows` rows.
template <typename Args>
cudaError_t launch_cluster(void (*kernel)(Args), int rows, size_t smem,
                           const Args& args, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(((args.B + rows - 1) / rows) * kClusterSize);
  config.blockDim = dim3(kClusterThreads);
  config.dynamicSmemBytes = smem;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attribute[1];
  attribute[0].id = cudaLaunchAttributeClusterDimension;
  attribute[0].val.clusterDim.x = kClusterSize;
  attribute[0].val.clusterDim.y = 1;
  attribute[0].val.clusterDim.z = 1;
  config.attrs = attribute;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The kernel of a plan, in the attentions' form the shapes take.
using ForwardKernel = void (*)(ForwardArgs);
using BackwardKernel = void (*)(BackwardArgs);
template <bool kFit>
ForwardKernel forward_kernel(int plan) {
  constexpr int S = kClusterSize;
  switch (plan) {
    case 0: return forward_cluster_kernel<S, 16, true, true, kFit>;
    case 1: return forward_cluster_kernel<S, 16, true, false, kFit>;
    case 2: return forward_cluster_kernel<S, 16, false, false, kFit>;
    default: return nullptr;
  }
}
template <bool kFit>
BackwardKernel backward_kernel(int plan) {
  constexpr int S = kClusterSize;
  switch (plan) {
    case 0: return backward_cluster_kernel<S, 16, true, kFit>;
    case 1: return backward_cluster_kernel<S, 16, false, kFit>;
    case 2: return backward_cluster_kernel<S, 8, false, kFit>;
    default: return nullptr;
  }
}

template <typename Args, typename Kernel>
cudaError_t launch_plan(int kernel_number, Kernel fit, Kernel wide,
                        const Args& args, int plan, void* stream) {
  const Plan* p = find_plan(kernel_number, plan);
  if (p == nullptr) return cudaErrorInvalidValue;
  const bool narrow =
      gscan::attend_fits(args.Mt > args.Mv ? args.Mt : args.Mv, args.H);
  return launch_cluster(narrow ? fit : wide, p->rows,
                        plan_smem_bytes(kernel_number, *p, args.H, args.E,
                                        args.V, args.Mt, args.Mv),
                        args, stream);
}

}  // namespace

// The first of kernel `kernel`'s (3 or 4) shared-memory plans that fits in
// `limit_bytes` per CTA at these shapes, or -1 if none does. *need_bytes
// gets that plan's need, or, if none fits, the least that any plan needs.
extern "C" int gscan_teacher_forced_plan(int kernel, int H, int E, int V,
                                         int Mt, int Mv,
                                         long long limit_bytes,
                                         long long* need_bytes) {
  long long least = -1;
  for (int plan = 0; find_plan(kernel, plan) != nullptr; ++plan) {
    const Plan& p = *find_plan(kernel, plan);
    if ((p.max_hidden > 0 && H > p.max_hidden) ||
        (p.max_key_work > 0 && (long long)H * (Mt + Mv) > p.max_key_work))
      continue;
    const long long need = static_cast<long long>(
        plan_smem_bytes(kernel, p, H, E, V, Mt, Mv));
    if (need <= limit_bytes) {
      *need_bytes = need;
      return plan;
    }
    if (least < 0 || need < least) least = need;
  }
  *need_bytes = least;
  return -1;
}

// The name of a plan (null if there is no such plan).
extern "C" const char* gscan_teacher_forced_plan_name(int kernel, int plan) {
  const Plan* p = find_plan(kernel, plan);
  return p != nullptr ? p->name : nullptr;
}

// Bytes of shared memory a CTA may opt in to on `device`, or -1.
extern "C" long long gscan_max_shared_memory_per_block(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

// Floats of the scratch that kernel `kernel`'s plan `plan` takes at these
// shapes (0 for a cluster plan; -1 for no such plan).
extern "C" long long gscan_teacher_forced_scratch_floats(int kernel, int plan,
                                                         int B, int H, int E,
                                                         int V, int Mt,
                                                         int Mv) {
  const Plan* p = find_plan(kernel, plan);
  if (p == nullptr) return -1;
  return p->grid ? static_cast<long long>(
                       gscan_teacher_forced_grid_scratch_floats(
                           kernel, B, H, E, V, Mt, Mv))
                 : 0;
}

extern "C" int gscan_teacher_forced_forward(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h0,
    const float* c0, const float* txt_qw, const float* txt_ew,
    const float* q2k_w, const float* q2k_b, const float* vis_qw,
    const float* vis_ew, const float* emb, const float* w_ih,
    const float* w_hh, const float* bias, const float* out_w,
    const float* out_proj, float* logits, float* h_res, float* c_res,
    float* asum, float* scratch, int B, int T, int num_steps, int Mt, int Mv,
    int H, int E, int V, int plan, void* stream) {
  if (!valid_shapes(B, T, Mt, Mv, H, E, V))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan* p = find_plan(3, plan);
  if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (p->grid) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const float* weights[12] = {txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew,
                                emb,    w_ih,   w_hh,  bias,  out_w,  out_proj};
    return gscan_teacher_forced_forward_grid(
        tokens, drop, proj_txt, cmd_mask, proj_vis, h0, c0, weights, logits,
        h_res, c_res, asum, scratch, B, T, num_steps, Mt, Mv, H, E, V,
        stream);
  }
  const ForwardArgs args{
      tokens, drop, proj_txt, cmd_mask, proj_vis, h0, c0,
      Weights{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew, emb, w_ih, w_hh,
              bias, out_w, out_proj},
      logits, h_res, c_res, asum, B, T, num_steps, Mt, Mv, H, E, V};
  return static_cast<int>(launch_plan(3, forward_kernel<true>(plan),
                                      forward_kernel<false>(plan), args,
                                      plan, stream));
}

extern "C" int gscan_teacher_forced_backward(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h_res,
    const float* c_res, const float* dlogits, const float* g_asum,
    const float* txt_qw, const float* txt_ew, const float* q2k_w,
    const float* q2k_b, const float* vis_qw, const float* vis_ew,
    const float* emb, const float* w_ih, const float* w_hh, const float* bias,
    const float* out_w, const float* out_proj, float* d_proj_txt,
    float* d_proj_vis, float* dh0, float* dc0, float* stash, float* scratch,
    int B, int T, int num_steps, int Mt, int Mv, int H, int E, int V,
    int plan, void* stream) {
  if (!valid_shapes(B, T, Mt, Mv, H, E, V))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan* p = find_plan(4, plan);
  if (p == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (p->grid) {
    if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    const float* weights[12] = {txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew,
                                emb,    w_ih,   w_hh,  bias,  out_w,  out_proj};
    return gscan_teacher_forced_backward_grid(
        tokens, drop, proj_txt, cmd_mask, proj_vis, h_res, c_res, dlogits,
        g_asum, weights, d_proj_txt, d_proj_vis, dh0, dc0, stash, scratch, B,
        T, num_steps, Mt, Mv, H, E, V, stream);
  }
  const BackwardArgs args{
      tokens, drop, proj_txt, cmd_mask, proj_vis, h_res, c_res, dlogits,
      g_asum,
      Weights{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew, emb, w_ih, w_hh,
              bias, out_w, out_proj},
      d_proj_txt, d_proj_vis, dh0, dc0, stash, B, T, num_steps, Mt, Mv, H, E,
      V};
  return static_cast<int>(launch_plan(4, backward_kernel<true>(plan),
                                      backward_kernel<false>(plan), args,
                                      plan, stream));
}

// `partial` holds `partial_floats` floats: room for the chunks' sums of
// the 14 products' outputs, for at most kSplits chunks.
extern "C" int gscan_teacher_forced_weight_grads(
    const float* stash, const float* h_res, const float* dlogits,
    float* g_txt_qw, float* g_txt_ew, float* g_q2k_w, float* g_q2k_b,
    float* g_vis_qw, float* g_vis_ew, float* g_emb, float* g_w_ih,
    float* g_w_hh, float* g_bias, float* g_out_w, float* g_out_proj,
    float* partial, int partial_floats, int N, int H, int E, int V,
    void* stream) {
  if (N <= 0 || H <= 0 || E <= 0 || V <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Stash lay(V, E, H);
  const int W = lay.width, G = 4 * H;
  const float* s = stash;
  // {x, dy, out, ldx, ldy, rows, cols[, out_ones]}: out = X^T dY.
  const GradProblem list[] = {
      {h_res, s + lay.d_pq_txt, g_txt_qw, H, W, H, H},
      {nullptr, s + lay.g_txt_ew, g_txt_ew, 0, W, 1, H},
      {h_res, s + lay.d_joint, g_q2k_w, H, W, H, H},
      {s + lay.ctx_cmd, s + lay.d_joint, g_q2k_w + (size_t)H * H, W, W,
       H + 1, H, g_q2k_b},
      {s + lay.vq, s + lay.d_pq_vis, g_vis_qw, W, W, H, H},
      {nullptr, s + lay.g_vis_ew, g_vis_ew, 0, W, 1, H},
      {s + lay.onehot, s + lay.d_emb, g_emb, W, W, V, E},
      {s + lay.emb, s + lay.d_gates, g_w_ih, W, W, E, G},
      {s + lay.ctx_cmd, s + lay.d_gates, g_w_ih + (size_t)E * G, W, W, 2 * H,
       G},
      {h_res, s + lay.d_gates, g_w_hh, H, W, H + 1, G, g_bias},
      {s + lay.emb, s + lay.d_ph, g_out_w, W, W, E + 3 * H, H},
      // out_proj^T = dlogits^T ph: its V rows, not its V columns, are the
      // thin side, which the small tile skips.
      {dlogits, s + lay.ph, g_out_proj, V, W, V, H},
  };
  auto aligned = [](const float* ptr, int ld) {
    return ptr != nullptr && ld % 4 == 0 &&
           reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  };
  // Every product in list order (the partial sums' layout, the combine's
  // list), and the tiles of each kernel. A product (without its row of
  // ones) is wide where its 128 x 256 tiles pad its outputs by at most a
  // quarter; its row of ones, if any, becomes a one-row product of its own.
  // The others keep the 64 x 64 tile, which pads less at their widths.
  namespace core = gscan::core;
  GradProblems all{}, narrow{}, wide{};
  all.N = narrow.N = wide.N = N;
  size_t outputs = 0;
  bool is_wide[kMaxProblems] = {};
  auto add = [&](GradProblems& to, GradProblem p, int tile_i, int tile_j) {
    is_wide[all.count] = &to == &wide;
    p.tile0 = to.tiles;
    p.tiles_j = (p.cols + tile_j - 1) / tile_j;
    p.part0 = outputs;
    p.vec_x = aligned(p.x, p.ldx);
    p.vec_y = aligned(p.dy, p.ldy);
    to.tiles += ((p.rows + tile_i - 1) / tile_i) * p.tiles_j;
    outputs += (size_t)p.rows * p.cols;
    to.p[to.count++] = p;
    all.p[all.count++] = p;
  };
  for (GradProblem p : list) {
    p.transposed = p.out == g_out_proj;
    const int x_rows = p.rows - (p.out_ones != nullptr);
    const long long padded =
        (long long)((x_rows + core::kTileM - 1) / core::kTileM) *
        core::kTileM *
        ((p.cols + core::kTileN - 1) / core::kTileN) * core::kTileN;
    if (p.x != nullptr && x_rows >= core::kTileM && p.cols >= core::kTileN &&
        4 * padded <= 5LL * x_rows * p.cols) {
      GradProblem body = p;
      body.rows = x_rows;
      body.out_ones = nullptr;
      add(wide, body, core::kTileM, core::kTileN);
      if (p.out_ones != nullptr)
        add(narrow, GradProblem{nullptr, p.dy, p.out_ones, 0, p.ldy, 1,
                                p.cols},
            kTileI, kTileJ);
    } else {
      add(narrow, p, kTileI, kTileJ);
    }
  }
  all.outputs = narrow.outputs = wide.outputs = outputs;
  const int room = min(kSplits, static_cast<int>(partial_floats / outputs));
  if (room < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Each kernel's chunk count: the one whose waves of resident CTAs take
  // the least time, waves / chunks (a function of the card and the shapes).
  auto chunk = [&](GradProblems& probs, int resident, int least) {
    int best = min(room, least);
    for (int s = best + 1;
         s <= min(room, (N + kRowsPerStage - 1) / kRowsPerStage); ++s) {
      const long long waves_s =
          (probs.tiles * (long long)s + resident - 1) / resident;
      const long long waves_b =
          (probs.tiles * (long long)best + resident - 1) / resident;
      if (waves_s * best <= waves_b * s) best = s;
    }
    const int per = (N + best - 1) / best;
    probs.chunk = (per + kRowsPerStage - 1) / kRowsPerStage * kRowsPerStage;
    probs.splits = (N + probs.chunk - 1) / probs.chunk;
    for (int i = 0; i < probs.count; ++i) probs.p[i].splits = probs.splits;
  };
  static int resident_narrow = 0, resident_wide = 0;
  if (resident_narrow == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, weight_grads_kernel, kGradThreads, 0);
    resident_narrow = max(1, sms * per_sm);
    cudaError_t err = cudaFuncSetAttribute(
        weight_grads_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(core::kSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, weight_grads_wide_kernel, core::kThreads, core::kSmemBytes);
    resident_wide = max(1, sms * per_sm);
  }
  chunk(narrow, resident_narrow, 1);
  // The wide tile's chunks: at most kMaxChain row-steps each where the room
  // allows, so that each is summed in one run.
  chunk(wide, resident_wide, (N + core::kMaxChain - 1) / core::kMaxChain);
  for (int i = 0; i < all.count; ++i)
    all.p[i].splits = is_wide[i] ? wide.splits : narrow.splits;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (narrow.count > 0) {
    weight_grads_kernel<<<narrow.tiles * narrow.splits, kGradThreads, 0,
                          st>>>(narrow, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (wide.count > 0) {
    weight_grads_wide_kernel<<<wide.tiles * wide.splits, core::kThreads,
                               core::kSmemBytes, st>>>(wide, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  weight_grads_combine_kernel<<<(unsigned)((outputs + 255) / 256), 256, 0,
                                st>>>(all, partial);
  return static_cast<int>(cudaGetLastError());
}
