// Kernels 3 and 4's grid plans: the teacher-forced unroll, forward and
// backward, for the widths past their resident cluster plans
// (teacher_forced.cu), with each of a step's products spread over the whole
// grid.
//
// Replace, with teacher_forced.cu, the TPU kernels multimodal_seq2seq_gscan_
// tpu/ops/pallas_teacher_forced.py: _forward_impl (kernel 3) and
// _backward_impl (kernel 4), the same step math as teacher_forced.cu's note
// describes; kernel 4 writes the same stash, in the same layout, for the
// same weight-gradient helper.
//
// Bound on the H100: operations. A row-step of kernel 3 is ~2 (E + 3H) 5H
// flops of products (0.6 GFLOP a step at H = E = 256, B = 200); kernel 4
// recomputes it and adds as many in transposed products. The cluster plans
// keep each CTA's weight columns in shared memory; past the widths where
// they fit (H ~ 105-116 at M_t = 16, M_v = 36), every cluster of 8 CTAs
// reads its columns from L2 in every product of every step (6 MB a step at
// H = 256 for each of 13-25 clusters), which only narrow widths still take,
// and past H ~ 480 no cluster plan fits at all. Here (grid_core.cuh, as
// kernel 2's grid plan) a persistent cooperative kernel of one CTA per SM
// walks all T steps; each product of a step is one grid-wide product over
// the batch's rows on product_core.cuh's register tiles (128 x 256, or 64 x
// 64 for the small products, product_any; k-split so that no float32 sum
// runs over more than 1,024 terms, the parts added in part order by their
// readers), the step's phases between grid barriers, so that each weight is
// read once a step for every 64 or 128 rows. At B = 200 the step's chain
// of phases, each a few microseconds at least, bounds it in practice below
// H ~ 1,000.
//
// Layout: the activations live feature-major in a global scratch the
// wrapper allocates ([feature][slot], slot b the batch row, slots padded to
// 4), with two regions for k-split sums (A for the recurrence's products, B
// for kernel 4's gradient products that do not wait on the recurrence, so
// that two products share a phase), the attentions' rows ([B][M]) and
// staged vectors ([B][H]). Kernel 4 copies the six weight matrices its
// transposed products (dx = dy W^T) read into the scratch transposed at
// entry ([N][K]), so that those products are products of the same core.
// Each phase reads what another CTA wrote past L1 (__ldcg, cp.async.cg).
//
// Kernel 3, a step (11 barriers):
//   textual query (and the step's embedding, the residuals, the last step's
//   logits) | textual attention | visual query | its tanh | its projection
//   | visual attention | gates (and the summed attention) | cell | the
//   head's hidden layer | its sums | the logits.
// Kernel 4, a step in reverse (16 barriers): the forward above recomputed
// from (h_res, c_res), up to the head's hidden layer, with d_ph = dlogits
// W_proj^T and d_pre = d_ph W_out^T beside its first products; the cell's
// backward in the cell's pass; d_lstm = d_gates [W_ih; W_hh]^T beside the
// head's product; the visual attention's backward; d_vq = d_pq_vis
// W_vis^T; d_joint = d_vq (1 - vq^2) W_q2k^T; the textual attention's
// backward; dh_txt = d_pq_txt W_txt^T; dh.
// Each attention row runs in CTA b % G (attend.cuh through grid_core.cuh's
// attention; its backward below: a row's keys split over its CTA's warps,
// then its features). Shared memory is the core's ring at every H, M and
// V. Every sum has one order, fixed by the shapes and the card; no atomics
// but the barrier's counter. float32 on the CUDA cores only.
#include <cstdint>

#include "grid_core.cuh"
#include "teacher_forced.cuh"

namespace {

namespace core = gscan::core;
using namespace gscan::grid;

// Phase timing (scripts/torch_kernel_phases.py --kernel tf-grid builds a
// copy with 1): thread 0 of CTA 0 adds the clock cycles of each phase (from
// the barrier before it to the barrier after it: the slowest CTA's) to
// gscan_tf_grid_cycles[kernel - 3][p], p = 0 the entry and p = 1, 2, ... a
// step's phases in order, its cycles waiting in the barriers to
// [kTfPhases] and the steps to [kTfPhases + 1]; off, it compiles to
// nothing.
constexpr int kTfGridPhaseTiming = 0;
constexpr int kTfPhases = 17;
__device__ unsigned long long gscan_tf_grid_cycles[2][kTfPhases + 2];

// The grid barrier, counting the phases of a step (phase timing builds).
struct Phases {
  GridBarrier<kTfGridPhaseTiming != 0> barrier;
  unsigned long long* cycles;  // this kernel's counters
  long long last;
  int phase;
  __device__ Phases(unsigned* count, int kernel)
      : barrier{count, 0u, gscan_tf_grid_cycles[kernel - 3] + kTfPhases},
        cycles(gscan_tf_grid_cycles[kernel - 3]), last(0), phase(0) {
    if constexpr (kTfGridPhaseTiming != 0) last = clock64();
  }
  __device__ void sync() {
    barrier.sync();
    if constexpr (kTfGridPhaseTiming != 0)
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        const long long now = clock64();
        cycles[min(phase, kTfPhases - 1)] += now - last;
        last = now;
      }
    ++phase;
  }
  // A step begins (its first phase is 1).
  __device__ void step() {
    phase = 1;
    if constexpr (kTfGridPhaseTiming != 0)
      if (blockIdx.x == 0 && threadIdx.x == 0) cycles[kTfPhases + 1] += 1;
  }
};


using gscan::tf::Stash;
using gscan::tf::Weights;

struct GridArgs {
  const int* tokens;                 // [T, B]
  const float *drop, *proj_txt, *cmd_mask, *proj_vis;
  const float *h0, *c0;              // kernel 3: [B, H]
  const float *h_res_in, *c_res_in;  // kernel 4: [T, B, H]
  const float *dlogits, *g_asum;     // kernel 4: [T, B, V], [B, M_v]
  Weights wt;
  float *logits, *h_res, *c_res, *asum;                  // kernel 3
  float *d_proj_txt, *d_proj_vis, *dh0, *dc0, *stash;    // kernel 4
  float* scratch;
  int B, T, num_steps, Mt, Mv, H, E, V;
  bool vec_keys;  // H % 4 == 0 and the keys 16-byte aligned
};

// Reserve n floats at p, float4-aligned; returns where they start.
__host__ __device__ inline size_t take(size_t& p, size_t n) {
  const size_t at = p;
  p += (n + 3) & ~size_t(3);
  return at;
}

// Room for a product of `stages` stages and N columns: its parts up to
// kMaxSplits (at least those the 1,024-term cap needs), [N][ld] each.
__host__ __device__ inline size_t room_of(int stages, int N) {
  const int most = stages < kMaxSplits ? stages : kMaxSplits;
  const int least = parts_for(stages);
  return (size_t)(least > most ? least : most) * N;
}
__host__ __device__ inline size_t larger(size_t a, size_t b) {
  return a > b ? a : b;
}

// The scratch of kernel 3 (kernel = 3) or 4, in floats. [feature][ld]
// buffers (ld: B rounded up to 4), [B][M] attention rows, [B][H] staged
// vectors, kernel 4's transposed weights ([N][K]), the parts' regions A and
// B, then the barrier's counter.
struct Layout {
  size_t ld, h[2], c, emb, ctxc, ctxs, vq, ph;
  size_t pqt, pqv, dlog, dph, dpre, dg, dli, dpqv, djp, djh, dpqt, dh, dc;
  size_t wt, wv, dw, dstage, qstage;
  size_t t_proj, t_out, t_lstm, t_vis, t_q2k, t_txt;
  size_t part_a, room_a, part_b, room_b, counter, total;
  __host__ __device__ Layout(int kernel, int B, int H, int E, int V, int Mt,
                             int Mv) {
    ld = ((size_t)B + 3) / 4 * 4;
    const size_t f = (size_t)H * ld, X = (size_t)E + 3 * H;
    size_t p = 0;
    h[0] = take(p, f), h[1] = take(p, f), c = take(p, f);
    emb = take(p, (size_t)E * ld), ctxc = take(p, f), ctxs = take(p, f);
    vq = take(p, f);
    const int sH = stages_of(H), sE = stages_of(E);
    const int s_in = sE + 3 * sH;  // [emb; three H segments]
    room_a = larger(larger(room_of(sH, H), room_of(2 * sH, H)),
                    larger(room_of(s_in, 4 * H), room_of(s_in, H)));
    if (kernel == 3) {
      ph = take(p, f);
      room_b = room_of(sH, V);
      pqt = pqv = dlog = dph = dpre = dg = dli = dpqv = djp = djh = dpqt =
          dh = dc = dw = dstage = 0;
      t_proj = t_out = t_lstm = t_vis = t_q2k = t_txt = 0;
    } else {
      ph = 0;  // kernel 4 writes the head's sums to the stash
      pqt = take(p, f), pqv = take(p, f), dlog = take(p, (size_t)V * ld);
      dph = take(p, f), dpre = take(p, X * ld), dg = take(p, 4 * f);
      dli = take(p, X * ld), dpqv = take(p, f), djp = take(p, f);
      djh = take(p, f), dpqt = take(p, f), dh = take(p, f), dc = take(p, f);
      dw = take(p, (size_t)B * (Mt > Mv ? Mt : Mv));
      dstage = take(p, (size_t)B * H);
      t_proj = take(p, (size_t)V * H), t_out = take(p, (size_t)H * X);
      t_lstm = take(p, (size_t)4 * H * X), t_vis = take(p, (size_t)H * H);
      t_q2k = take(p, (size_t)2 * H * H), t_txt = take(p, (size_t)H * H);
      room_a = larger(room_a, room_of(sH, 2 * H));
      room_b = larger(larger(room_of(stages_of(V), H), room_of(sH, (int)X)),
                      room_of(stages_of(4 * H), (int)X));
    }
    wt = take(p, (size_t)B * Mt), wv = take(p, (size_t)B * Mv);
    qstage = take(p, (size_t)B * H);
    room_a *= ld, room_b *= ld;
    part_a = take(p, room_a), part_b = take(p, room_b);
    counter = take(p, 4);
    total = p;
  }
};

__host__ __device__ inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// kV consecutive floats at p (kV = 4: one 16-byte load), through the
// read-only path (kLdg) or past L1.
template <int kV, bool kLdg>
__device__ __forceinline__ void load_v(const float* p, float (&v)[kV]) {
  if constexpr (kV == 4) {
    const float4 x = kLdg ? __ldg(reinterpret_cast<const float4*>(p))
                          : __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int f = 0; f < kV; ++f) v[f] = kLdg ? __ldg(p + f) : __ldcg(p + f);
  }
}


// One of a step's attentions backward (the TPU backward kernel's attention
// part, _attention_bwd), for rows [0, B): row b in CTA b % G, its keys and
// then its features split over W warps of the CTA (W as the forward
// attention's). Given the context's cotangent dctx(h, b) (staged in
// dstage, [B][H]), the forward's weights w_rows [B][M], the projected
// query pq [H][ld] and an optional cotangent of the weights g [B][M] *
// g_scale:
//   dw[m]  = sum_h dctx[h] K[m, h] + g[m] g_scale   (dw_rows, [B][M])
//   ds[m]  = w[m] (dw[m] - sum_m' w[m'] dw[m'])
//   hid    = tanh(pq[h] + K[m, h])
//   dK[m, h] += w[m] dctx[h] + ds[m] ew[h] (1 - hid^2)
//   dpq[h] = sum_m ds[m] ew[h] (1 - hid^2),  gew[h] = sum_m hid ds[m]
// dpq into [H][ld] and the stash's row (stash_dpq + b width); gew into the
// stash's row. As in the TPU kernel, no mask: a masked key has weight
// exactly 0. kV features a lane loads at once (4: 16-byte loads of the keys
// and their gradients). smem: a round's key chunks' sums of dq and gew
// (at most 16 H floats, H < 1,024 where they are used).
template <int kV, typename Dctx>
__device__ __noinline__ void attention_backward(
    int B, size_t ld, int H, int M, const float* pq, Dctx dctx,
    const float* __restrict__ keys, const float* w_rows,
    const float* __restrict__ ew, const float* __restrict__ g, float g_scale,
    float* dkeys, float* dw_rows, float* dstage, float* dpq,
    float* stash_dpq, float* stash_gew, int width, float* smem) {
  constexpr int kG = gscan::kGroup;  // keys a warp sums at once
  constexpr int kKeys = 4;           // keys whose loads a lane issues at once
  const int G = gridDim.x, cta = blockIdx.x, warp = threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  const int mine = B > cta ? (B - cta + G - 1) / G : 0;
  if (mine == 0) return;
  int W = 1;
  while (2 * W * mine <= kWarps) W *= 2;
  const int R = kWarps / W;  // rows a round
  for (int base = 0; base < mine; base += R) {
    const int rows = min(R, mine - base);
    for (int i = threadIdx.x; i < rows * H; i += kThreads) {
      const int r = i / H, h = i % H;
      const size_t s = cta + (size_t)G * (base + r);
      dstage[s * H + h] = dctx(h, static_cast<int>(s));
    }
    __syncthreads();
    const int r = warp / W, w = warp % W;
    const size_t b = cta + (size_t)G * (base + r);
    const float* K = keys + b * M * H;
    float* dK = dkeys + b * M * H;
    const float* wr = w_rows + b * M;
    float* dwr = dw_rows + b * M;
    const float* d = dstage + b * H;
    // dw: warp w of the row takes keys in groups of kG from w kG; lane l
    // features kV l + 32 kV i.
    if (r < rows) {
      for (int m0 = w * kG; m0 < M; m0 += W * kG) {
        float p[kG];
#pragma unroll
        for (int j = 0; j < kG; ++j) p[j] = 0.f;
        for (int h = kV * lane; h < H; h += 32 * kV) {
          float dv[kV];
          load_v<kV, false>(d + h, dv);
#pragma unroll
          for (int j = 0; j < kG; ++j) {
            if (m0 + j >= M) continue;
            float kv[kV];
            load_v<kV, true>(K + (size_t)(m0 + j) * H + h, kv);
#pragma unroll
            for (int f = 0; f < kV; ++f) p[j] = fmaf(dv[f], kv[f], p[j]);
          }
        }
#pragma unroll
        for (int offset = 16; offset > 0; offset >>= 1)
#pragma unroll
          for (int j = 0; j < kG; ++j)
            p[j] += __shfl_xor_sync(0xffffffffu, p[j], offset);
        if (lane == 0)
#pragma unroll
          for (int j = 0; j < kG; ++j)
            if (m0 + j < M)
              dwr[m0 + j] = g != nullptr
                                ? p[j] + __ldg(g + b * M + m0 + j) * g_scale
                                : p[j];
      }
    }
    __syncthreads();
    // ds[m] = w[m] (dw[m] - sum_m' w[m'] dw[m']), in place of dw (warp 0
    // of the row).
    if (r < rows && w == 0) {
      float part = 0.f;
      for (int m = lane; m < M; m += 32) part += __ldcg(wr + m) * dwr[m];
      const float inner = gscan::warp_sum(part);
      for (int m = lane; m < M; m += 32)
        dwr[m] = __ldcg(wr + m) * (dwr[m] - inner);
    }
    __syncthreads();
    // The row's features in blocks of 32 kV (lane l: kV l + 0..kV-1), its
    // keys in KC chunks: warp w takes blocks w % F + F j and chunk w / F
    // (F = the blocks, up to W), the loads of kKeys keys issued before
    // their arithmetic. With KC > 1 each chunk's sums of dq and ge go to
    // shared memory, and are added in chunk order below.
    const int blocks = (H + 32 * kV - 1) / (32 * kV);
    const int F = min(blocks, W), KC = W / F;
    const int fb = w % F, kc = w / F;
    const int m_lo = kc < KC ? M * kc / KC : M, m_hi = M * (kc + 1) / KC;
    float* part = smem + (size_t)r * KC * 2 * H;  // [KC][2][H] a row
    if (r < rows && kc < KC) {
      for (int h = kV * (32 * fb + lane); h - kV * lane < H;
           h += 32 * kV * F) {
        if (h >= H) continue;
        float q[kV], e[kV], dd[kV], dq[kV], ge[kV];
#pragma unroll
        for (int f = 0; f < kV; ++f) {
          q[f] = __ldcg(pq + (size_t)(h + f) * ld + b);
          e[f] = __ldg(ew + h + f);
          dq[f] = ge[f] = 0.f;
        }
        load_v<kV, false>(d + h, dd);
        for (int m0 = m_lo; m0 < m_hi; m0 += kKeys) {
          float kv[kKeys][kV], dk[kKeys][kV], wm[kKeys], dsm[kKeys];
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            const int m = m0 + j < m_hi ? m0 + j : m_hi - 1;
            load_v<kV, true>(K + (size_t)m * H + h, kv[j]);
            load_v<kV, false>(dK + (size_t)m * H + h, dk[j]);
            wm[j] = __ldcg(wr + m);
            dsm[j] = dwr[m];
          }
#pragma unroll
          for (int j = 0; j < kKeys; ++j) {
            if (m0 + j >= m_hi) break;
            float out[kV];
#pragma unroll
            for (int f = 0; f < kV; ++f) {
              const float hid = tanhf(q[f] + kv[j][f]);
              ge[f] = fmaf(hid, dsm[j], ge[f]);
              const float dpre = dsm[j] * e[f] * (1.f - hid * hid);
              dq[f] += dpre;
              out[f] = dk[j][f] + (wm[j] * dd[f] + dpre);
            }
            float* at = dK + (size_t)(m0 + j) * H + h;
            if constexpr (kV == 4)
              *reinterpret_cast<float4*>(at) =
                  make_float4(out[0], out[1], out[2], out[3]);
            else
#pragma unroll
              for (int f = 0; f < kV; ++f) at[f] = out[f];
          }
        }
#pragma unroll
        for (int f = 0; f < kV; ++f) {
          if (KC > 1) {
            part[(kc * 2) * H + h + f] = dq[f];
            part[(kc * 2 + 1) * H + h + f] = ge[f];
          } else {
            dpq[(size_t)(h + f) * ld + b] = dq[f];
            stash_dpq[b * width + h + f] = dq[f];
            stash_gew[b * width + h + f] = ge[f];
          }
        }
      }
    }
    __syncthreads();
    if (KC > 1)
      for (int i = threadIdx.x; i < rows * H; i += kThreads) {
        const int rr = i / H, h = i % H;
        const size_t bb = cta + (size_t)G * (base + rr);
        const float* pr = smem + (size_t)rr * KC * 2 * H;
        float dq = pr[h], ge = pr[H + h];
        for (int c = 1; c < KC; ++c)
          dq += pr[c * 2 * H + h], ge += pr[(c * 2 + 1) * H + h];
        dpq[(size_t)h * ld + bb] = dq;
        stash_dpq[bb * width + h] = dq;
        stash_gew[bb * width + h] = ge;
      }
    __syncthreads();
  }
}

// attention_backward with 16-byte loads of the keys and their gradients
// where vec (H % 4 == 0, every base 16-byte aligned), else 4-byte ones.
template <typename Dctx>
__device__ __forceinline__ void attention_backward_any(
    bool vec, int B, size_t ld, int H, int M, const float* pq, Dctx dctx,
    const float* __restrict__ keys, const float* w_rows,
    const float* __restrict__ ew, const float* __restrict__ g, float g_scale,
    float* dkeys, float* dw_rows, float* dstage, float* dpq,
    float* stash_dpq, float* stash_gew, int width, float* smem) {
  if (vec)
    attention_backward<4>(B, ld, H, M, pq, dctx, keys, w_rows, ew, g,
                          g_scale, dkeys, dw_rows, dstage, dpq, stash_dpq,
                          stash_gew, width, smem);
  else
    attention_backward<1>(B, ld, H, M, pq, dctx, keys, w_rows, ew, g,
                          g_scale, dkeys, dw_rows, dstage, dpq, stash_dpq,
                          stash_gew, width, smem);
}

// The teacher token's embedding times the step's dropout mask, [E][ld]
// (one-hot semantics: an out-of-range token embeds to 0).
__device__ __noinline__ void embed(const GridArgs& a, int t, size_t ld,
                                   float* emb) {
  const int E = a.E, B = a.B;
  const size_t total = (size_t)B * E, threads = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += threads) {
    const size_t b = i / E, e = i % E;
    const int tok = __ldg(a.tokens + (size_t)t * B + b);
    emb[e * ld + b] =
        tok >= 0 && tok < a.V
            ? __ldg(a.wt.emb + (size_t)tok * E + e) *
                  __ldg(a.drop + ((size_t)t * B + b) * E + e)
            : 0.f;
  }
}

// rows [R][C] (row-major, row r at r C) into buf [C][ld] (feature-major).
__device__ __noinline__ void to_features(const float* rows, int R, int C,
                                         size_t ld, float* buf) {
  const size_t total = (size_t)R * C, threads = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += threads)
    buf[i % C * ld + i / C] = __ldg(rows + i);
}

// buf [C][ld] into rows [R][stride] from column 0 (row r at r stride).
__device__ __noinline__ void to_rows(const float* buf, int R, int C,
                                     size_t ld, float* rows, size_t stride) {
  const size_t total = (size_t)R * C, threads = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += threads)
    rows[i / C * stride + i % C] = __ldcg(buf + i % C * ld + i / C);
}

// The step's textual attention, visual query, visual attention and gate
// product from h (the textual query's parts in region A), shared by both
// kernels: returns the gate product's parts (region A), its barrier not
// yet passed. pqt / pqv (or null) keep the projected queries. Beside the
// visual query's product runs beside_q2k(its tasks), and beside its tanh
// pass beside_vq() (kernel 4's d_pre, in region B).
template <typename Barrier, typename BesideQ2k, typename BesideVq>
__device__ __forceinline__ Parts step_to_gates(
    const GridArgs& a, const Layout& lay, float* base, const float* h,
    float* smem, Barrier& barrier, float* pqt, float* pqv, Parts txt_query,
    BesideQ2k beside_q2k, BesideVq beside_vq) {
  const Weights& wt = a.wt;
  const int H = a.H, E = a.E, B = a.B;
  const size_t ld = lay.ld;
  float* const part = base + lay.part_a;
  float* const emb = base + lay.emb;
  float* const ctxc = base + lay.ctxc;
  float* const ctxs = base + lay.ctxs;
  float* const vq = base + lay.vq;
  attention_any<kBatch, 1>(B, nullptr, part, txt_query, ld, H, a.proj_txt,
                           a.cmd_mask, wt.txt_ew, a.Mt, ctxc, base + lay.wt,
                           a.vec_keys, smem, base + lay.qstage, pqt);
  barrier.sync();
  // The conditional visual query tanh([h; ctx_cmd] W + b), its projection.
  Parts q = product_any<2>({Segment{h, wt.q2k_w, H},
                            Segment{ctxc, wt.q2k_w + (size_t)H * H, H}},
                           B, H, ld, part, lay.room_a,
                           H % 4 == 0 && aligned16(wt.q2k_w) &&
                               aligned16(wt.q2k_w + (size_t)H * H),
                           smem);
  beside_q2k(q.tasks);
  barrier.sync();
  visual_query(part, q, wt.q2k_b, B, H, ld, vq);
  beside_vq();
  barrier.sync();
  q = product_any<1>({Segment{vq, wt.vis_qw, H}}, B, H, ld, part,
                     lay.room_a, H % 4 == 0 && aligned16(wt.vis_qw), smem);
  barrier.sync();
  attention_any<kBatch, 1>(B, nullptr, part, q, ld, H, a.proj_vis, nullptr,
                           wt.vis_ew, a.Mv, ctxs, base + lay.wv, a.vec_keys,
                           smem, base + lay.qstage, pqv);
  barrier.sync();
  // The gates [emb; ctx_cmd; ctx_sit] W_ih + h W_hh (the bias in the cell).
  const size_t G4 = 4 * (size_t)H;
  return product_any<4>({Segment{emb, wt.w_ih, E},
                         Segment{ctxc, wt.w_ih + G4 * E, H},
                         Segment{ctxs, wt.w_ih + G4 * (E + H), H},
                         Segment{h, wt.w_hh, H}},
                        B, 4 * H, ld, part, lay.room_a,
                        aligned16(wt.w_ih) && aligned16(wt.w_ih + G4 * E) &&
                            aligned16(wt.w_ih + G4 * (E + H)) &&
                            aligned16(wt.w_hh),
                        smem);
}

// The head's hidden layer [emb; h_new; ctx_cmd; ctx_sit] W_out (region A).
__device__ __forceinline__ Parts head_product(const GridArgs& a,
                                              const Layout& lay, float* base,
                                              const float* hn, float* smem) {
  const Weights& wt = a.wt;
  const int H = a.H, E = a.E;
  const size_t HH = (size_t)H * H;
  return product_any<4>(
      {Segment{base + lay.emb, wt.out_w, E},
       Segment{hn, wt.out_w + (size_t)E * H, H},
       Segment{base + lay.ctxc, wt.out_w + (size_t)E * H + HH, H},
       Segment{base + lay.ctxs, wt.out_w + (size_t)E * H + 2 * HH, H}},
      a.B, H, lay.ld, base + lay.part_a, lay.room_a,
      H % 4 == 0 && aligned16(wt.out_w) &&
          aligned16(wt.out_w + (size_t)E * H),
      smem);
}

// ---------------------------------------------------------------------------
// Kernel 3: forward_grid_kernel.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
    forward_grid_kernel(const GridArgs a) {
  extern __shared__ float4 grid_smem4[];
  float* smem = reinterpret_cast<float*>(grid_smem4);
  const int H = a.H, B = a.B, V = a.V;
  const Weights& wt = a.wt;
  const Layout lay(3, B, H, a.E, V, a.Mt, a.Mv);
  const size_t ld = lay.ld;
  float* const base = a.scratch;
  float* h_cur = base + lay.h[0];
  float* h_next = base + lay.h[1];
  float* const c = base + lay.c;
  float* const ph = base + lay.ph;
  float* const part_a = base + lay.part_a;
  float* const part_b = base + lay.part_b;
  Phases barrier(reinterpret_cast<unsigned*>(base + lay.counter), 3);
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gthreads = (size_t)gridDim.x * kThreads;

  to_features(a.h0, B, H, ld, h_cur);
  to_features(a.c0, B, H, ld, c);
  for (size_t i = gtid; i < (size_t)B * a.Mv; i += gthreads) a.asum[i] = 0.f;
  barrier.sync();

  Parts logits_q{};
  const auto logits_pass = [&](int t) {
    sums_pass(part_b, logits_q, V, B, [&](int v, int s, float x) {
      a.logits[((size_t)t * B + s) * V + v] = x;
    });
  };
  for (int t = 0; t < a.T; ++t) {
    barrier.step();
    // Textual query h W_q; the step's embedding; the residuals (the state
    // before the step); the last step's logits.
    const Parts q = product_any<1>({Segment{h_cur, wt.txt_qw, H}}, B, H, ld,
                                   part_a, lay.room_a,
                                   H % 4 == 0 && aligned16(wt.txt_qw), smem);
    embed(a, t, ld, base + lay.emb);
    to_rows(h_cur, B, H, ld, a.h_res + (size_t)t * B * H, H);
    to_rows(c, B, H, ld, a.c_res + (size_t)t * B * H, H);
    if (t > 0) logits_pass(t - 1);
    barrier.sync();
    const Parts g = step_to_gates(a, lay, base, h_cur, smem, barrier,
                                  nullptr, nullptr, q, [](int) {}, [] {});
    // The summed visual attention over t < num_steps.
    if (t < a.num_steps)
      for (size_t i = gtid; i < (size_t)B * a.Mv; i += gthreads)
        a.asum[i] += __ldcg(base + lay.wv + i);
    barrier.sync();
    cell(part_a, g, wt.bias, B, H, ld, c, h_next);
    barrier.sync();
    const Parts p = head_product(a, lay, base, h_next, smem);
    barrier.sync();
    sums_pass(part_a, p, H, B,
              [&](int u, int s, float x) { ph[u * ld + s] = x; });
    barrier.sync();
    logits_q = product_any<1>({Segment{ph, wt.out_proj, H}}, B, V, ld,
                              part_b, lay.room_b,
                              V % 4 == 0 && aligned16(wt.out_proj), smem);
    barrier.sync();
    float* swap = h_cur;
    h_cur = h_next;
    h_next = swap;
  }
  logits_pass(a.T - 1);
}

// ---------------------------------------------------------------------------
// Kernel 4: backward_grid_kernel.
// ---------------------------------------------------------------------------

// dst [N][K] (row n at n dst_ld) = src [K][N] transposed, grid-stride.
__device__ __noinline__ void transpose(const float* src, int K, int N,
                                       float* dst, size_t dst_ld) {
  const size_t total = (size_t)K * N, threads = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += threads) {
    const size_t n = i / K, k = i % K;
    dst[n * dst_ld + k] = __ldg(src + k * N + n);
  }
}

// The cell forward and backward for rows [0, B): gates (i, f, g, o) the
// product's sums [4H][pld] plus b, c the pre-step state: the new h into hn
// and the stash; dh_new = dh + d_pre's h_new segment; the gate
// pre-activations' gradients into dg [4H][ld] and the stash; dc becomes
// the gradient of the pre-step c.
__device__ __noinline__ void cell_backward(const GridArgs& a,
                                           const Layout& lay, float* base,
                                           Parts q, int t) {
  const int H = a.H, B = a.B, E = a.E;
  const size_t ld = lay.ld;
  const float* part = base + lay.part_a;
  const float* c = base + lay.c;
  const float* dh = base + lay.dh;
  const float* dpre = base + lay.dpre + (size_t)E * ld;  // d h_new
  float* hn = base + lay.h[1];
  float* dg = base + lay.dg;
  float* dc = base + lay.dc;
  const Stash st(a.V, E, H);
  float* stash = a.stash + (size_t)t * B * st.width;
  const float* bias = a.wt.bias;
  const size_t total = (size_t)H * B, threads = (size_t)gridDim.x * kThreads;
  const size_t stride = 4 * (size_t)H * q.pld, gate = H * q.pld;
  constexpr int kCells = kBatch / 2;
  for (size_t first = (size_t)blockIdx.x * kThreads + threadIdx.x;
       first < total; first += kCells * threads) {
    size_t at[4 * kCells];
    bool valid[4 * kCells];
    float g[4 * kCells];
#pragma unroll
    for (int b = 0; b < kCells; ++b) {
      const size_t i = first + b * threads;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        valid[4 * b + x] = i < total;
        at[4 * b + x] = x * gate + i / B * q.pld + i % B;
      }
    }
    part_sums(part, q.ks, stride, at, valid, g);
#pragma unroll
    for (int b = 0; b < kCells; ++b) {
      const size_t i = first + b * threads, u = i / B, s = i % B;
      if (!valid[4 * b]) continue;
      const size_t f = u * ld + s;
      const float si = sigmoidf(g[4 * b] + __ldg(bias + u));
      const float sf = sigmoidf(g[4 * b + 1] + __ldg(bias + H + u));
      const float tg = tanhf(g[4 * b + 2] + __ldg(bias + 2 * H + u));
      const float so = sigmoidf(g[4 * b + 3] + __ldg(bias + 3 * H + u));
      const float cp = __ldcg(c + f);
      const float cn = sf * cp + si * tg;
      const float tc = tanhf(cn);
      const float h_new = so * tc;
      hn[f] = h_new;
      float* row = stash + s * st.width;
      row[st.h_new + u] = h_new;
      const float dh_new = __ldcg(dh + f) + __ldcg(dpre + f);
      const float dct = __ldcg(dc + f) + dh_new * so * (1.f - tc * tc);
      const float d_i = dct * tg * si * (1.f - si);
      const float d_f = dct * cp * sf * (1.f - sf);
      const float d_g = dct * si * (1.f - tg * tg);
      const float d_o = dh_new * tc * so * (1.f - so);
      dg[f] = d_i, dg[(size_t)H * ld + f] = d_f;
      dg[2 * (size_t)H * ld + f] = d_g, dg[3 * (size_t)H * ld + f] = d_o;
      row[st.d_gates + u] = d_i, row[st.d_gates + H + u] = d_f;
      row[st.d_gates + 2 * H + u] = d_g, row[st.d_gates + 3 * H + u] = d_o;
      dc[f] = dct * sf;
    }
  }
}

// Step t's one-hot token, embedding, contexts and visual query, and d_emb
// = (d_e1 + d_e2) dropout, into kernel 4's stash (the rows' h_new and the
// products' sums go in by their own passes).
__device__ __noinline__ void stash_forward(const GridArgs& a,
                                           const Layout& lay,
                                           const float* base, int t) {
  const int B = a.B, E = a.E, H = a.H, V = a.V;
  const size_t ld = lay.ld;
  const Stash st(V, E, H);
  float* stash = a.stash + (size_t)t * B * st.width;
  const int P = st.emb;
  const int cols = P + 2 * E + 3 * H;
  const size_t threads = (size_t)gridDim.x * kThreads;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < (size_t)B * cols; i += threads) {
    const size_t s = i / cols;
    const int j = static_cast<int>(i % cols);
    float* row = stash + s * st.width;
    if (j < P) {
      row[j] = j < V && __ldg(a.tokens + (size_t)t * B + s) == j ? 1.f : 0.f;
    } else if (j < P + E) {
      row[j] = __ldcg(base + lay.emb + (size_t)(j - P) * ld + s);
    } else if (j < P + E + 3 * H) {
      const int seg = (j - P - E) / H, u = (j - P - E) % H;
      const size_t from = seg == 0 ? lay.ctxc : seg == 1 ? lay.ctxs : lay.vq;
      const int to = seg == 0 ? st.ctx_cmd : seg == 1 ? st.ctx_sit : st.vq;
      row[to + u] = __ldcg(base + from + (size_t)u * ld + s);
    } else {
      const int e = j - P - E - 3 * H;
      row[st.d_emb + e] = (__ldcg(base + lay.dli + (size_t)e * ld + s) +
                           __ldcg(base + lay.dpre + (size_t)e * ld + s)) *
                          __ldg(a.drop + ((size_t)t * B + s) * E + e);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    backward_grid_kernel(const GridArgs a) {
  extern __shared__ float4 grid_smem4[];
  float* smem = reinterpret_cast<float*>(grid_smem4);
  const int H = a.H, B = a.B, V = a.V, E = a.E, T = a.T;
  const int X = E + 3 * H;
  const Weights& wt = a.wt;
  const Layout lay(4, B, H, E, V, a.Mt, a.Mv);
  const size_t ld = lay.ld;
  const Stash st(V, E, H);
  float* const base = a.scratch;
  float* const h = base + lay.h[0];
  float* const hn = base + lay.h[1];
  float* const part_a = base + lay.part_a;
  float* const part_b = base + lay.part_b;
  float* const dph = base + lay.dph;
  float* const dpre = base + lay.dpre;
  float* const dli = base + lay.dli;
  float* const dpqv = base + lay.dpqv;
  float* const djp = base + lay.djp;
  float* const djh = base + lay.djh;
  float* const dpqt = base + lay.dpqt;
  float* const dh = base + lay.dh;
  const float* const t_proj = base + lay.t_proj;
  const float* const t_out = base + lay.t_out;
  const float* const t_lstm = base + lay.t_lstm;
  const float* const t_vis = base + lay.t_vis;
  const float* const t_q2k = base + lay.t_q2k;
  const float* const t_txt = base + lay.t_txt;
  Phases barrier(reinterpret_cast<unsigned*>(base + lay.counter), 4);
  const size_t gtid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  const size_t gthreads = (size_t)gridDim.x * kThreads;
  const bool vh = H % 4 == 0, vx = X % 4 == 0;

  // The transposed weights of the step's transposed products.
  transpose(wt.out_proj, H, V, base + lay.t_proj, H);
  transpose(wt.out_w, X, H, base + lay.t_out, X);
  transpose(wt.w_ih, E + 2 * H, 4 * H, base + lay.t_lstm, X);
  transpose(wt.w_hh, H, 4 * H, base + lay.t_lstm + E + 2 * H, X);
  transpose(wt.vis_qw, H, H, base + lay.t_vis, H);
  transpose(wt.q2k_w, 2 * H, H, base + lay.t_q2k, 2 * H);
  transpose(wt.txt_qw, H, H, base + lay.t_txt, H);
  for (size_t i = gtid; i < (size_t)H * ld; i += gthreads)
    dh[i] = 0.f, base[lay.dc + i] = 0.f;
  // The last step's state, embedding and logits' cotangent.
  const auto load_step = [&](int t) {
    to_features(a.h_res_in + (size_t)t * B * H, B, H, ld, h);
    to_features(a.c_res_in + (size_t)t * B * H, B, H, ld, base + lay.c);
    to_features(a.dlogits + (size_t)t * B * V, B, V, ld, base + lay.dlog);
  };
  load_step(T - 1);
  embed(a, T - 1, ld, base + lay.emb);
  barrier.sync();

  for (int t = T - 1; t >= 0; --t) {
    barrier.step();
    float* const stash = a.stash + (size_t)t * B * st.width;
    // Textual query h W_q; beside it d_ph = dlogits W_proj^T.
    Parts q = product_any<1>({Segment{h, wt.txt_qw, H}}, B, H, ld, part_a,
                             lay.room_a, vh && aligned16(wt.txt_qw), smem);
    Parts qb = product_any<1>({Segment{base + lay.dlog, t_proj, V}}, B, H,
                              ld, part_b, lay.room_b, vh, smem, q.tasks);
    barrier.sync();
    // d_ph's sums, in the phase of the textual attention (step_to_gates).
    sums_pass(part_b, qb, H, B, [&](int u, int s, float x) {
      dph[u * ld + s] = x;
      stash[s * st.width + st.d_ph + u] = x;
    });
    // The textual attention, the visual query (d_pre = d_ph W_out^T
    // beside its product, d_pre's sums beside its tanh), the visual
    // attention and the gate product.
    q = step_to_gates(
        a, lay, base, h, smem, barrier, base + lay.pqt, base + lay.pqv, q,
        [&](int first) {
          qb = product_any<1>({Segment{dph, t_out, H}}, B, X, ld, part_b,
                              lay.room_b, vx, smem, first);
        },
        [&] {
          sums_pass(part_b, qb, X, B,
                    [&](int j, int s, float x) { dpre[j * ld + s] = x; });
        });
    barrier.sync();
    // The cell, forward and backward.
    cell_backward(a, lay, base, q, t);
    barrier.sync();
    // The head's hidden layer; beside it d_lstm = d_gates [W_ih; W_hh]^T.
    q = head_product(a, lay, base, hn, smem);
    qb = product_any<1>({Segment{base + lay.dg, t_lstm, 4 * H}}, B, X, ld,
                        part_b, lay.room_b, vx, smem, q.tasks);
    barrier.sync();
    sums_pass(part_a, q, H, B, [&](int u, int s, float x) {
      stash[s * st.width + st.ph + u] = x;
    });
    sums_pass(part_b, qb, X, B,
              [&](int j, int s, float x) { dli[j * ld + s] = x; });
    // The visual attention's backward: d ctx_sit = d_cs1 + d_cs2, the
    // summed attention's cotangent on the valid steps.
    {
      const Parts dl = qb;
      attention_backward_any(
          a.vec_keys, B, ld, H, a.Mv, base + lay.pqv,
          [&](int u, int s) {
            const size_t at[1] = {(size_t)(E + H + u) * dl.pld + s};
            const bool valid[1] = {true};
            float v[1];
            part_sums(part_b, dl.ks, (size_t)X * dl.pld, at, valid, v);
            return v[0] + __ldcg(dpre + (size_t)(E + 2 * H + u) * ld + s);
          },
          a.proj_vis, base + lay.wv, wt.vis_ew, a.g_asum,
          t < a.num_steps ? 1.f : 0.f, a.d_proj_vis, base + lay.dw,
          base + lay.dstage, dpqv, stash + st.d_pq_vis, stash + st.g_vis_ew,
          st.width, smem);
    }
    barrier.sync();
    // d_vq = d_pq_vis W_vis^T; the next step's state and cotangent.
    q = product_any<1>({Segment{dpqv, t_vis, H}}, B, H, ld, part_a,
                       lay.room_a, vh, smem);
    if (t > 0) load_step(t - 1);
    barrier.sync();
    // d_joint_pre = d_vq (1 - vq^2); the step's forward values and d_emb
    // into the stash.
    {
      const float* vq = base + lay.vq;
      sums_pass(part_a, q, H, B, [&](int u, int s, float x) {
        const float v = __ldcg(vq + u * ld + s);
        const float d = x * (1.f - v * v);
        djp[u * ld + s] = d;
        stash[s * st.width + st.d_joint + u] = d;
      });
    }
    stash_forward(a, lay, base, t);
    barrier.sync();
    // d_joint = d_joint_pre W_q2k^T ([dh_joint; d ctx_cmd]); the next
    // step's embedding.
    q = product_any<1>({Segment{djp, t_q2k, H}}, B, 2 * H, ld, part_a,
                       lay.room_a, vh, smem);
    if (t > 0) embed(a, t - 1, ld, base + lay.emb);
    barrier.sync();
    // The textual attention's backward: d ctx_cmd = (d_cc1 + d_cc2) +
    // d_joint's second half; its first half into djh.
    {
      const Parts dj = q;
      attention_backward_any(
          a.vec_keys, B, ld, H, a.Mt, base + lay.pqt,
          [&](int u, int s) {
            const size_t at[1] = {(size_t)(H + u) * dj.pld + s};
            const bool valid[1] = {true};
            float v[1];
            part_sums(part_a, dj.ks, (size_t)2 * H * dj.pld, at, valid, v);
            return (__ldcg(dli + (size_t)(E + u) * ld + s) +
                    __ldcg(dpre + (size_t)(E + H + u) * ld + s)) +
                   v[0];
          },
          a.proj_txt, base + lay.wt, wt.txt_ew, nullptr, 0.f, a.d_proj_txt,
          base + lay.dw, base + lay.dstage, dpqt, stash + st.d_pq_txt,
          stash + st.g_txt_ew, st.width, smem);
      const size_t total = (size_t)H * B;
      for (size_t i = gtid; i < total; i += gthreads) {
        const size_t at[1] = {i / B * dj.pld + i % B};
        const bool valid[1] = {true};
        float v[1];
        part_sums(part_a, dj.ks, (size_t)2 * H * dj.pld, at, valid, v);
        djh[i / B * ld + i % B] = v[0];
      }
    }
    barrier.sync();
    // dh_txt = d_pq_txt W_txt^T.
    q = product_any<1>({Segment{dpqt, t_txt, H}}, B, H, ld, part_a,
                       lay.room_a, vh, smem);
    barrier.sync();
    // dh of the pre-step state: dh_lstm + dh_joint + dh_txt.
    sums_pass(part_a, q, H, B, [&](int u, int s, float x) {
      const size_t f = (size_t)u * ld + s;
      dh[f] = (__ldcg(dli + (size_t)(E + 2 * H + u) * ld + s) +
               __ldcg(djh + f)) +
              x;
    });
    barrier.sync();
  }
  to_rows(dh, B, H, ld, a.dh0, H);
  to_rows(base + lay.dc, B, H, ld, a.dc0, H);
}

}  // namespace

// The phase timing's counters (kTfGridPhaseTiming) of kernel `kernel` (3
// or 4): copies the cycles of each phase summed over launches, the
// barriers' waits and the steps into out[kTfPhases + 2], then zeroes them.
extern "C" int gscan_teacher_forced_grid_phase_cycles(
    int kernel, unsigned long long* out) {
  const size_t bytes = sizeof(gscan_tf_grid_cycles[0]);
  const size_t offset = (kernel == 3 ? 0 : 1) * bytes;
  cudaError_t err = cudaMemcpyFromSymbol(out, gscan_tf_grid_cycles, bytes,
                                         offset);
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[kTfPhases + 2] = {};
  return static_cast<int>(
      cudaMemcpyToSymbol(gscan_tf_grid_cycles, zeros, bytes, offset));
}

// Floats of kernel `kernel`'s (3 or 4) grid-plan scratch.
size_t gscan_teacher_forced_grid_scratch_floats(int kernel, int B, int H,
                                                int E, int V, int Mt,
                                                int Mv) {
  return Layout(kernel, B, H, E, V, Mt, Mv).total;
}

// Bytes of shared memory a CTA of the grid plans takes: the products' ring
// or an attention round, whichever is larger (the ring's 147,456 bytes at
// every H up to 1,024 features a row, and past it).
size_t gscan_teacher_forced_grid_smem_bytes(int H, int Mt, int Mv) {
  const size_t attention = attention_smem_floats(H, Mt > Mv ? Mt : Mv);
  return (attention > core::kSmemFloats ? attention : core::kSmemFloats) *
         sizeof(float);
}

// One launch of kernel 3's grid plan (teacher_forced.cu's entry point
// checks the arguments).
int gscan_teacher_forced_forward_grid(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h0,
    const float* c0, const float* const* weights, float* logits,
    float* h_res, float* c_res, float* asum, float* scratch, int B, int T,
    int num_steps, int Mt, int Mv, int H, int E, int V, void* stream) {
  const float* const* w = weights;
  GridArgs args{};
  args.tokens = tokens, args.drop = drop, args.proj_txt = proj_txt;
  args.cmd_mask = cmd_mask, args.proj_vis = proj_vis, args.h0 = h0;
  args.c0 = c0;
  args.wt = Weights{w[0], w[1], w[2], w[3], w[4],  w[5],
                    w[6], w[7], w[8], w[9], w[10], w[11]};
  args.logits = logits, args.h_res = h_res, args.c_res = c_res;
  args.asum = asum, args.scratch = scratch;
  args.B = B, args.T = T, args.num_steps = num_steps, args.Mt = Mt;
  args.Mv = Mv, args.H = H, args.E = E, args.V = V;
  args.vec_keys = H % 4 == 0 && aligned16(proj_txt) && aligned16(proj_vis);
  const Layout lay(3, B, H, E, V, Mt, Mv);
  return static_cast<int>(launch_grid(
      forward_grid_kernel, gscan_teacher_forced_grid_smem_bytes(H, Mt, Mv),
      args, reinterpret_cast<unsigned*>(scratch + lay.counter), stream));
}

// One launch of kernel 4's grid plan.
int gscan_teacher_forced_backward_grid(
    const int* tokens, const float* drop, const float* proj_txt,
    const float* cmd_mask, const float* proj_vis, const float* h_res,
    const float* c_res, const float* dlogits, const float* g_asum,
    const float* const* weights, float* d_proj_txt, float* d_proj_vis,
    float* dh0, float* dc0, float* stash, float* scratch, int B, int T,
    int num_steps, int Mt, int Mv, int H, int E, int V, void* stream) {
  const float* const* w = weights;
  GridArgs args{};
  args.tokens = tokens, args.drop = drop, args.proj_txt = proj_txt;
  args.cmd_mask = cmd_mask, args.proj_vis = proj_vis;
  args.h_res_in = h_res, args.c_res_in = c_res, args.dlogits = dlogits;
  args.g_asum = g_asum;
  args.wt = Weights{w[0], w[1], w[2], w[3], w[4],  w[5],
                    w[6], w[7], w[8], w[9], w[10], w[11]};
  args.d_proj_txt = d_proj_txt, args.d_proj_vis = d_proj_vis;
  args.dh0 = dh0, args.dc0 = dc0, args.stash = stash;
  args.scratch = scratch;
  args.B = B, args.T = T, args.num_steps = num_steps, args.Mt = Mt;
  args.Mv = Mv, args.H = H, args.E = E, args.V = V;
  args.vec_keys = H % 4 == 0 && aligned16(proj_txt) &&
                  aligned16(proj_vis) && aligned16(d_proj_txt) &&
                  aligned16(d_proj_vis);
  const Layout lay(4, B, H, E, V, Mt, Mv);
  return static_cast<int>(launch_grid(
      backward_grid_kernel, gscan_teacher_forced_grid_smem_bytes(H, Mt, Mv),
      args, reinterpret_cast<unsigned*>(scratch + lay.counter), stream));
}
