// Kernel 2's grid plan: K greedy decoder steps per launch, for the widths
// past the ring plans of decode_block.cu (H > 256), with each of a step's
// products spread over the whole grid.
//
// Replaces, with decode_block.cu, the TPU kernel
// multimodal_seq2seq_gscan_tpu/ops/pallas_decoder.py (fused_decode_block):
// the same step as decode_block.cu's note describes, and the same done-row
// rule (a done row takes the attention part of one step, its first done
// step, whose two rows are copied to the rest of the block; the EOS freeze;
// the argmax's first maximum wins).
//
// Bound on the H100: operations. A step's products are 24 H^2 weights
// against every emitting row (M rows): 48 H^2 M flops, 51.5 GFLOP at H =
// 1024 and M = 1024. The ring plans read all of a step's weights in every
// CTA of 8 to 32 rows, so past H = 256 each float loaded fed only 8 rows
// and the weights (100.7 MB a step at H = 1024, more than L2) streamed from
// device memory 128 times a step at B = 1024. Here each product of a step
// is one grid-wide product, C = X^T W over the step's rows, on
// product_core.cuh's 128 x 256 register tiles: every weight is read once a
// step for every 128 rows (and, the tasks that share a weight block being
// adjacent, mostly once a step from device memory), and a thread's 24
// staged floats a k feed 128 FMAs.
//
// Layout: a persistent kernel of one CTA per SM (a cooperative launch, so
// that every CTA is resident), 256 threads, the step as phases separated by
// grid barriers (an arrival counter in the scratch, acquire loads, a trap
// after a minute instead of a hang; grid_core.cuh, with the products, the
// attention rows and the visual query's and the cell's passes, shared with
// kernels 3 and 4's grid plans):
//   textual query | textual attention | visual query (its k-split sums,
//   then tanh in a pass) | visual query projection | visual attention |
//   gates | the cell | logits | argmax | the compaction and the retiring
//   rows' copies.
// The activations live feature-major in a global scratch the wrapper
// allocates ([feature][slot], slots padded to 4): h and c twice (the
// compaction writes the other copy), the new h, the embedding, both
// contexts, the visual query and the products' k-split sums, 9 H + P
// floats a slot (P = 16 H, or the parts the chain cap needs; 100 MB at B =
// H = 1024; L2 holds the phase's working set of 4-16 MB of activations,
// not the whole scratch), and the folded head. Rows keep slots
// ordered emitting first, then done this step, compacted every step; so a
// product's M is the count of rows it needs (the emitting rows, or also
// the rows done this step for the attention part), and the products and
// passes read only those slots.
// - A product has ceil(M / 128) x ceil(N / 256) tiles. Its K (the
//   segments of its inputs, H rows each, in stages of 32) is split into ks
//   parts: enough that no sum runs over more than 1,024 terms (longer
//   float32 chains left c further from float64 than the plain version's,
//   PERF.md), more where the tiles are too few for the grid (the ks of
//   least rounds x stages a part, at most 16, in the room of P floats a
//   slot; P holds the parts the cap needs at every H and V). Each part's
//   sums are stored apart ([N][M rounded up to 4]) and added in part order
//   by whoever reads them. Tasks run in the order tile row, tile column,
//   part: CTAs that run together read the same weight block.
// - Each attention row runs on one warp (attend.cuh: attend_row, one pass
//   over its keys, or attend_row_wide past H = 1024, its query staged in
//   the visual query's buffer, which no phase reads then), or on up to 8
//   warps of its CTA that split its keys when the grid has few rows. So
//   shared memory is the ring's at every H: the plan takes any H, M and V.
// - The head: the logits are [emb; h; ctx_cmd; ctx_sit] W_out W_proj,
//   and only their argmax leaves the step, so the kernel folds W_out W_proj
//   ([4H][V], each sum over H in order, in runs of at most 1,024 terms
//   added in order) at entry and runs one product of N = V a step: 4H V
//   multiply-adds a row for 4H^2 + HV (the 4H^2 head product took 12% of
//   a launch at H = 1024). The logits' rounding moves
//   (a float32 product of the weights first), not their function; the
//   argmax is a thread's per row (any V).
// Every sum has one order, fixed by the shapes and the card; no atomics
// but the barrier's counter. f32 on the CUDA cores only (TF32 would move
// the numbers off the JAX bars).
#include <climits>
#include <cstdint>

#include "grid_core.cuh"

namespace {

namespace core = gscan::core;
using namespace gscan::grid;

constexpr int kPartColumns = 16;  // room for the parts: at least 16 H a slot
constexpr int kChunk = 1024;      // slots a CTA places at a time
// Phase timing (scripts/torch_kernel_phases.py --kernel grid builds a copy
// with 1): thread 0 of CTA 0 adds the clock cycles of each phase (from the
// barrier before it to the barrier after it) to gscan_decode_grid_cycles,
// its cycles waiting in the barriers to [kPhases] and the steps to
// [kPhases + 1]; off, it compiles to nothing.
constexpr int kGridPhaseTiming = 0;
constexpr int kPhases = 12;
__device__ unsigned long long gscan_decode_grid_cycles[kPhases + 2];

struct Weights {
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

struct GridArgs {
  const float* proj_txt;
  const float* cmd_mask;
  const float* proj_vis;
  const float* h_in;
  const float* c_in;
  const int* tok_in;
  const unsigned char* done_in;
  Weights wt;
  float* h_out;
  float* c_out;
  int* tok_out;
  unsigned char* done_out;
  int* step_tokens;
  float* step_emitted;
  float* step_attn_cmd;
  float* step_attn_sit;
  float* scratch;
  int B, Mt, Mv, H, V, K, eos;
  bool vec;
};

// The scratch, in floats: [H][ld] buffers, the parts' [P][ld], the folded
// head [4H][V], then [ld] int arrays and the barrier's counter. P, the
// parts' columns: 16 H, or more where the widest product (N = 4H gates, or
// N = V logits, four segments) needs more at the chain cap.
struct Layout {
  size_t ld, h[2], c[2], hn, emb, ctxc, ctxs, vq, part, head, row[2],
      tok[2], newtok, cls, counter, total;
  __host__ __device__ Layout(int B, int H, int V) {
    ld = ((size_t)B + 3) / 4 * 4;
    const size_t f = (size_t)H * ld;
    h[0] = 0, h[1] = f, c[0] = 2 * f, c[1] = 3 * f;
    hn = 4 * f, emb = 5 * f, ctxc = 6 * f, ctxs = 7 * f, vq = 8 * f;
    part = 9 * f;
    const size_t widest = 4 * (size_t)H > (size_t)V ? 4 * (size_t)H : V;
    const size_t chain = chain_parts(4, H) * widest;
    const size_t columns = (size_t)kPartColumns * H;
    head = part + (chain > columns ? chain : columns) * ld;  // [4H][V]
    row[0] = head + ((size_t)4 * H * V + 3) / 4 * 4;
    row[1] = row[0] + ld, tok[0] = row[1] + ld, tok[1] = tok[0] + ld;
    newtok = tok[1] + ld, cls = newtok + ld, counter = cls + ld;
    total = counter + 4;
  }
};

// Thread 0 of CTA 0 adds the cycles since the last mark to phase p (timing
// builds).
struct PhaseClock {
  long long last = 0;
  __device__ void mark(int p) {
    if constexpr (kGridPhaseTiming != 0)
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        const long long now = clock64();
        if (p >= 0) gscan_decode_grid_cycles[p] += now - last;
        last = now;
      }
  }
};

// The step's passes over the products' sums (grid_core.cuh: visual_query,
// cell; here the argmax), each a function of its own.

// The argmax (first maximum wins) of the emitting slots [0, n), their
// logits the product's sums [V][pld]: a thread per slot; the step's
// token, emitted flag, next token and class (1: EOS) written.
__device__ __noinline__ void argmax(const float* part, Parts q, int n, int V,
                                    int eos, int t, int B, const int* row,
                                    int* step_tokens, float* step_emitted,
                                    int* newtok, int* cls) {
  const size_t threads = (size_t)gridDim.x * kThreads;
  for (size_t s = (size_t)blockIdx.x * kThreads + threadIdx.x; s < (size_t)n;
       s += threads) {
    float best = 0.f;
    int best_v = 0;
    for (int v = 0; v < V; v += kBatch) {
      size_t at[kBatch];
      bool valid[kBatch];
      float logit[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        valid[b] = v + b < V;
        at[b] = (v + b) * q.pld + s;
      }
      part_sums(part, q.ks, V * q.pld, at, valid, logit);
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (valid[b] && (v + b == 0 || logit[b] > best))
          best = logit[b], best_v = v + b;
    }
    const size_t o = (size_t)t * B + __ldcg(row + s);
    step_tokens[o] = best_v;
    step_emitted[o] = 1.f;
    newtok[s] = best_v;
    cls[s] = best_v == eos ? 1 : 0;
  }
}

// Thread 0 of every CTA ends with the CTA's four sums of v (all threads
// hold them after the call).
__device__ __forceinline__ void block_sums(int (&v)[4], int* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int offset = 16; offset > 0; offset >>= 1)
      v[q] += __shfl_xor_sync(0xffffffffu, v[q], offset);
  if (lane == 0)
#pragma unroll
    for (int q = 0; q < 4; ++q) s_red[warp * 4 + q] = v[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = 0;
    for (int w = 0; w < kWarps; ++w) v[q] += s_red[w * 4 + q];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    decode_grid_kernel(const GridArgs a) {
  extern __shared__ float4 grid_smem4[];
  float* smem = reinterpret_cast<float*>(grid_smem4);
  const int tid = threadIdx.x, G = gridDim.x, cta = blockIdx.x;
  const int H = a.H, B = a.B, K = a.K;
  const Weights& wt = a.wt;
  const Layout lay(B, H, a.V);
  const size_t ld = lay.ld;
  float* const base = a.scratch;
  float* h_cur = base + lay.h[0];
  float* h_next = base + lay.h[1];
  float* c_cur = base + lay.c[0];
  float* c_next = base + lay.c[1];
  float* const hn = base + lay.hn;
  float* const emb = base + lay.emb;
  float* const ctxc = base + lay.ctxc;
  float* const ctxs = base + lay.ctxs;
  float* const vq = base + lay.vq;
  float* const part = base + lay.part;
  float* const head = base + lay.head;
  int* row = reinterpret_cast<int*>(base + lay.row[0]);
  int* row_next = reinterpret_cast<int*>(base + lay.row[1]);
  int* tok = reinterpret_cast<int*>(base + lay.tok[0]);
  int* tok_next = reinterpret_cast<int*>(base + lay.tok[1]);
  int* const newtok = reinterpret_cast<int*>(base + lay.newtok);
  int* const cls = reinterpret_cast<int*>(base + lay.cls);
  GridBarrier<kGridPhaseTiming != 0> barrier{
      reinterpret_cast<unsigned*>(base + lay.counter), 0u,
      gscan_decode_grid_cycles + kPhases};
  PhaseClock clock;
  clock.mark(-1);
  // Shared memory of the placing phases (the products' ring otherwise).
  int* s_pos = reinterpret_cast<int*>(smem);  // [kChunk] new slot, or -1
  int* s_row = s_pos + kChunk;                // [kChunk] batch row
  int* s_tok = s_row + kChunk;                // [kChunk] token
  int* s_cls = s_tok + kChunk;                // [kChunk]
  int* s_red = s_cls + kChunk;                // [kWarps * 4]
  const size_t gtid = (size_t)cta * kThreads + tid;
  const size_t gthreads = (size_t)G * kThreads;

  // Slots: emitting rows first, then the rows done at entry, each in batch
  // order; CTA c places batch rows [c per, (c + 1) per).
  int n_emit, n_done;
  {
    const int per = (B + G - 1) / G;
    const int b0 = min(B, cta * per), b1 = min(B, b0 + per);
    int v[4] = {0, 0, 0, 0};
    for (int b = tid; b < B; b += kThreads) {
      const int e = a.done_in[b] == 0;
      v[0] += e;
      if (b < b0) v[1] += e;
    }
    block_sums(v, s_red);
    n_emit = v[0], n_done = B - v[0];
    int before = v[1];  // emitting rows before b (thread 0)
    for (int c0 = b0; c0 < b1; c0 += kChunk) {
      const int cnt = min(kChunk, b1 - c0);
      if (tid == 0)
        for (int j = 0; j < cnt; ++j) {
          const int b = c0 + j, e = a.done_in[b] == 0;
          s_pos[j] = e ? before : n_emit + (b - before);
          s_cls[j] = e;
          s_tok[j] = a.tok_in[b];
          before += e;
        }
      __syncthreads();
      for (size_t i = tid; i < (size_t)cnt * H; i += kThreads) {
        const int j = static_cast<int>(i / H), u = static_cast<int>(i % H);
        const size_t b = c0 + j, p = s_pos[j];
        h_cur[u * ld + p] = __ldg(a.h_in + b * H + u);
        c_cur[u * ld + p] = __ldg(a.c_in + b * H + u);
        if (s_cls[j])
          emb[u * ld + p] = __ldg(wt.emb + (size_t)s_tok[j] * H + u);
      }
      for (int j = tid; j < cnt; j += kThreads) {
        row[s_pos[j]] = c0 + j;
        tok[s_pos[j]] = s_tok[j];
      }
      __syncthreads();
    }
    // The folded head W_out W_proj ([4H][V]), each sum over H in order, in
    // runs of at most kMaxChain terms added in order.
    const size_t heads = (size_t)4 * H * a.V;
    for (size_t i = gtid; i < heads; i += gthreads) {
      const size_t k = i / a.V, v = i % a.V;
      float sum = 0.f;
      for (int h0 = 0; h0 < H; h0 += core::kMaxChain) {
        float run = 0.f;
        for (int h = h0; h < min(H, h0 + core::kMaxChain); ++h)
          run = fmaf(__ldg(wt.out_w + k * H + h),
                     __ldg(wt.out_proj + (size_t)h * a.V + v), run);
        sum += run;
      }
      head[i] = sum;
    }
  }
  barrier.sync();
  clock.mark(0);

  for (int t = 0; t < K; ++t) {
    const int n_attn = n_emit + n_done;
    if (n_attn == 0) break;  // every row retired: the block is written
    if constexpr (kGridPhaseTiming != 0)
      if (cta == 0 && tid == 0) gscan_decode_grid_cycles[kPhases + 1] += 1;

    // Textual query h W_q, and the textual attention.
    const size_t room = lay.head - lay.part;
    Parts q = product<1>({Segment{h_cur, wt.txt_qw, H}}, n_attn, H, ld,
                         part, room, a.vec, smem);
    barrier.sync();
    clock.mark(1);
    attention_any(n_attn, row, part, q, ld, H, a.proj_txt, a.cmd_mask,
                  wt.txt_ew, a.Mt, ctxc, a.step_attn_cmd + (size_t)t * B * a.Mt,
                  a.vec, smem, vq);
    barrier.sync();
    clock.mark(2);
    // Conditional visual query tanh([h; ctx_cmd] W + b), its projection,
    // and the visual attention.
    q = product<2>({Segment{h_cur, wt.q2k_w, H},
                    Segment{ctxc, wt.q2k_w + (size_t)H * H, H}},
                   n_attn, H, ld, part, room, a.vec, smem);
    barrier.sync();
    clock.mark(3);
    visual_query(part, q, wt.q2k_b, n_attn, H, ld, vq);
    barrier.sync();
    clock.mark(4);
    q = product<1>({Segment{vq, wt.vis_qw, H}}, n_attn, H, ld, part, room,
                   a.vec, smem);
    barrier.sync();
    clock.mark(5);
    attention_any(n_attn, row, part, q, ld, H, a.proj_vis, nullptr,
                  wt.vis_ew, a.Mv, ctxs,
                  a.step_attn_sit + (size_t)t * B * a.Mv, a.vec, smem, vq);
    barrier.sync();
    clock.mark(6);

    if (n_emit > 0) {
      // LSTM gates [emb; ctx_cmd; ctx_sit] W_ih + h W_hh + b, then the
      // cell: c in place, the new h apart.
      const size_t G4 = 4 * (size_t)H;
      q = product<4>({Segment{emb, wt.w_ih, H},
                      Segment{ctxc, wt.w_ih + G4 * H, H},
                      Segment{ctxs, wt.w_ih + 2 * G4 * H, H},
                      Segment{h_cur, wt.w_hh, H}},
                     n_emit, 4 * H, ld, part, room, a.vec, smem);
      barrier.sync();
      clock.mark(7);
      cell(part, q, wt.bias, n_emit, H, ld, c_cur, hn);
      barrier.sync();
      clock.mark(8);
      // The logits [emb; h_new; ctx_cmd; ctx_sit] (W_out W_proj), the head
      // folded at entry.
      const size_t HV = (size_t)H * a.V;
      q = product<4>({Segment{emb, head, H}, Segment{hn, head + HV, H},
                      Segment{ctxc, head + 2 * HV, H},
                      Segment{ctxs, head + 3 * HV, H}},
                     n_emit, a.V, ld, part, room, a.V % 4 == 0, smem);
      barrier.sync();
      clock.mark(9);
      argmax(part, q, n_emit, a.V, a.eos, t, B, row, a.step_tokens,
             a.step_emitted, newtok, cls);
      barrier.sync();
      clock.mark(10);
    }

    // The compaction. Classes: 0 emitting on, 1 EOS now (attention only at
    // the next step), 2 done this step (retiring: its h, c, token and done
    // flag written, its attention rows copied to the rest of the block,
    // zero tokens and emitted flags). New slots: class 0, then class 1,
    // each in slot order; CTA c places slots [c per, (c + 1) per).
    {
      const int per = (n_attn + G - 1) / G;
      const int s0 = min(n_attn, cta * per), s1 = min(n_attn, s0 + per);
      int v[4] = {0, 0, 0, 0};
      for (int s = tid; s < n_emit; s += kThreads) {
        const int c = __ldcg(cls + s);
        v[0] += c == 0, v[1] += c == 1;
        if (s < s0) v[2] += c == 0, v[3] += c == 1;
      }
      block_sums(v, s_red);
      const int total0 = v[0], total1 = v[1];
      int before0 = v[2], before1 = v[3];  // thread 0's running counts
      const int rest = K - 1 - t, Mw = a.Mt + a.Mv;
      for (int c0 = s0; c0 < s1; c0 += kChunk) {
        const int cnt = min(kChunk, s1 - c0);
        for (int j = tid; j < cnt; j += kThreads) {
          const int s = c0 + j;
          const int c = s < n_emit ? __ldcg(cls + s) : 2;
          s_cls[j] = c;
          s_row[j] = __ldcg(row + s);
          s_tok[j] = c == 2 ? __ldcg(tok + s) : __ldcg(newtok + s);
        }
        __syncthreads();
        if (tid == 0)
          for (int j = 0; j < cnt; ++j) {
            const int c = s_cls[j];
            s_pos[j] = c == 0 ? before0++ : c == 1 ? total0 + before1++ : -1;
          }
        __syncthreads();
        for (size_t i = tid; i < (size_t)cnt * H; i += kThreads) {
          const int j = static_cast<int>(i % cnt);
          const size_t u = i / cnt, s = c0 + j, p = s_pos[j];
          if (s_pos[j] >= 0) {
            h_next[u * ld + p] = __ldcg(hn + u * ld + s);
            c_next[u * ld + p] = __ldcg(c_cur + u * ld + s);
            if (s_cls[j] == 0)
              emb[u * ld + p] = __ldg(wt.emb + (size_t)s_tok[j] * H + u);
          } else {
            const size_t b = s_row[j];
            a.h_out[b * H + u] = __ldcg(h_cur + u * ld + s);
            a.c_out[b * H + u] = __ldcg(c_cur + u * ld + s);
          }
        }
        for (int j = tid; j < cnt; j += kThreads) {
          const int b = s_row[j];
          if (s_pos[j] >= 0) {
            row_next[s_pos[j]] = b;
            tok_next[s_pos[j]] = s_tok[j];
            continue;
          }
          a.tok_out[b] = s_tok[j];
          a.done_out[b] = 1;
          for (int u = t; u < K; ++u) {
            a.step_tokens[(size_t)u * B + b] = 0;
            a.step_emitted[(size_t)u * B + b] = 0.f;
          }
        }
        if (rest > 0)
          for (int i = tid; i < cnt * Mw; i += kThreads) {
            const int j = i / Mw, m = i % Mw;
            if (s_pos[j] >= 0) continue;
            const size_t b = s_row[j];
            float* out = m < a.Mt ? a.step_attn_cmd + b * a.Mt + m
                                  : a.step_attn_sit + b * a.Mv + (m - a.Mt);
            const size_t stride = (size_t)B * (m < a.Mt ? a.Mt : a.Mv);
            const float value = __ldcg(out + t * stride);
            for (int u = t + 1; u < K; ++u) out[u * stride] = value;
          }
        __syncthreads();
      }
      n_emit = total0, n_done = total1;
    }
    barrier.sync();
    clock.mark(11);
    float* f;
    f = h_cur, h_cur = h_next, h_next = f;
    f = c_cur, c_cur = c_next, c_next = f;
    int* p;
    p = row, row = row_next, row_next = p;
    p = tok, tok = tok_next, tok_next = p;
  }

  // Slots [0, n_emit) are still emitting; the rest are done.
  const int n = n_emit + n_done;
  for (size_t i = gtid; i < (size_t)n * H; i += gthreads) {
    const size_t s = i / H, u = i % H, b = __ldcg(row + s);
    a.h_out[b * H + u] = __ldcg(h_cur + u * ld + s);
    a.c_out[b * H + u] = __ldcg(c_cur + u * ld + s);
  }
  for (size_t s = gtid; s < (size_t)n; s += gthreads) {
    const size_t b = __ldcg(row + s);
    a.tok_out[b] = __ldcg(tok + s);
    a.done_out[b] = s >= (size_t)n_emit;
  }
}


}  // namespace

// Bytes of shared memory a CTA of the grid plan takes: the largest of the
// products' ring, an attention round (up to H = 1,024 8 rows' queries and
// the chunks' states; the staged scores) and the placing arrays. So at most
// the ring's 147,456 bytes at every H and M.
size_t gscan_decode_grid_smem_bytes(int H, int Mt, int Mv) {
  const size_t attention = attention_smem_floats(H, Mt > Mv ? Mt : Mv);
  size_t floats = core::kSmemFloats;
  floats = attention > floats ? attention : floats;
  const size_t placing = 4 * kChunk + 4 * kWarps;
  floats = placing > floats ? placing : floats;
  return floats * sizeof(float);
}

// The phase timing's counters (kGridPhaseTiming): copies the cycles of each
// phase summed over launches, the barriers' waits and the steps into
// out[kPhases + 2], then zeroes them.
extern "C" int gscan_decode_grid_phase_cycles(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, gscan_decode_grid_cycles,
                                         sizeof(gscan_decode_grid_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[kPhases + 2] = {};
  return static_cast<int>(cudaMemcpyToSymbol(gscan_decode_grid_cycles,
                                             zeros, sizeof(zeros)));
}

// Floats of the grid plan's scratch at batch B.
size_t gscan_decode_grid_scratch_floats(int B, int H, int V) {
  return Layout(B, H, V).total;
}

// One launch of the grid plan (decode_block.cu's gscan_decode_block checks
// the arguments): a cooperative launch of one CTA per SM (as many as the
// device holds at this shared memory), the barrier's counter zeroed first.
int gscan_decode_grid(
    const float* proj_txt, const float* cmd_mask, const float* proj_vis,
    const float* h_in, const float* c_in, const int* tok_in,
    const unsigned char* done_in, const float* txt_qw, const float* txt_ew,
    const float* q2k_w, const float* q2k_b, const float* vis_qw,
    const float* vis_ew, const float* emb, const float* w_ih,
    const float* w_hh, const float* bias, const float* out_w,
    const float* out_proj, float* h_out, float* c_out, int* tok_out,
    unsigned char* done_out, int* step_tokens, float* step_emitted,
    float* step_attn_cmd, float* step_attn_sit, float* scratch, int B,
    int Mt, int Mv, int H, int V, int K, int eos, int vec, void* stream) {
  const Layout lay(B, H, V);
  const GridArgs args{
      proj_txt, cmd_mask, proj_vis, h_in, c_in, tok_in, done_in,
      Weights{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew, emb, w_ih, w_hh,
              bias, out_w, out_proj},
      h_out, c_out, tok_out, done_out, step_tokens, step_emitted,
      step_attn_cmd, step_attn_sit, scratch, B, Mt, Mv, H, V, K, eos,
      vec != 0};
  return static_cast<int>(launch_grid(
      decode_grid_kernel, gscan_decode_grid_smem_bytes(H, Mt, Mv), args,
      reinterpret_cast<unsigned*>(scratch + lay.counter), stream));
}
