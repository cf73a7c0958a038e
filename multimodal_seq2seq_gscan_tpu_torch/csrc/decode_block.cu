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
// Bound on the H100: operations. An emitting row-step is ~0.5 MFLOP of f32
// products with the ~1 MB of decoder weights plus 52 x 100 attention terms,
// against ~21 KB of keys; and only the emitting row-steps need that work.
// Three things held the first design (one thread per output column walking
// its weights from L2, every row computed at every step) at 18x its bound;
// this design answers each:
// - Done rows. A row that is done has fixed outputs: token and emitted 0,
//   h and c frozen, and both attention rows a function of the frozen h and
//   the keys alone, so the same at every step from its first done step on.
//   The done-row rule: a done row takes the attention part of one step (its
//   first done step, or step 0 if it is done at entry), whose two rows are
//   then copied to the rest of the block; it never runs the LSTM, the head
//   or the argmax, and a CTA whose rows are all done stops. The copies are
//   the rows the kernel would compute at every step, bit for bit. Each CTA
//   keeps its rows in slots ordered emitting first, then done-this-step,
//   then retired (a stable partition after every step, by one warp), so the
//   products run over a prefix of the slots, in tiles of 8 rows.
// - Rows per CTA. Rows are dealt out in the order emitting-first (every CTA
//   ranks the done flags itself), CTA i taking ranks i, i + G, i + 2G, ...
//   So a block that starts with most rows done (the second launch of a
//   decode) spreads its few emitting rows over every SM instead of leaving
//   them on the CTAs they happened to fall in. R = 32 rows per CTA (128 CTAs
//   for the decode's 4096, one wave), 16 or 8 where H needs it.
// - The products as tiles. The step's weights stream from L2 through a
//   ring of kStages slots of 32 KB (16 KB where shared memory is short),
//   filled by every thread's cp.async (16 bytes, or 4 where H % 4 != 0 or
//   a weight is not 16-byte aligned) kStages - 1 tiles ahead of the
//   consumer, across product boundaries and into the next step (the copies
//   overlap the attentions). A work item is an 8-row x
//   4-column register tile: per weight row it reads 4 staged weights (a
//   float4, or for the gates the columns u + gH of unit u) and the 8 rows'
//   activations (two float4 from the feature-major [feature][R + 4]
//   buffers, the 4 spreading rows over the banks). The gate item holds a
//   unit's four gates, so the cell runs in registers. Each item's weight
//   rows are split over up to 16 adjacent threads (a power of two, as many
//   as the CTA's 512 threads hold at the product's active rows) and their
//   partial sums added by shuffles: a product over 2 rows runs on as many
//   threads as one over 32.
// - Keys. Each attention row is one warp's one pass over the keys
//   (attend.cuh, shared with kernel 1), and only rows in the attention set
//   read them. The keys of 4096 rows (85 MB) exceed L2, so they come from
//   device memory every step; as rows finish, fewer are read.
// - Any H. The plans above keep a product's items one per thread and the
//   [H][R + 4] buffers in shared memory, and a gate item's slices sum up to
//   4H / S terms, too many past H = 256 (kMaxRingSum). Past them the grid
//   plan (decode_grid.cu) runs every product of a step grid-wide on
//   product_core.cuh's 128 x 256 register tiles, so that each weight is
//   read once a step for every 128 rows instead of once for every 8: one
//   CTA per SM, the phases of a step separated by grid barriers, the
//   activations in a global scratch (sized by the host). Its shared memory
//   is the ring's at every H, M and V, so it takes every shape.
// f32 on the CUDA cores only (TF32 would move the numbers off the JAX bars).
#include "attend.cuh"

// The grid plan (decode_grid.cu).
size_t gscan_decode_grid_smem_bytes(int H, int Mt, int Mv);
size_t gscan_decode_grid_scratch_floats(int B, int H, int V);
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
    int Mt, int Mv, int H, int V, int K, int eos, int vec, void* stream);

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRT = 8;             // rows per register tile
// Columns per register tile (8 spilled at 512 threads' 128 registers and
// took 1.11x as long on the fixture's first block; PERF.md).
constexpr int kCT = 4;
constexpr int kStages = 3;         // ring slots
// Plans, in order of preference: rows per CTA and floats per ring slot
// (32 KB slots measured faster than 16 KB ones: half the tiles per step),
// or the grid plan (decode_grid.cu: the rows of the whole batch in every
// product, one CTA per SM, its activations in a global scratch), which
// takes every shape.
struct Plan {
  int rows, slot_floats;
  bool grid;
};
constexpr Plan kPlans[] = {
    {32, 8192, false}, {32, 4096, false}, {16, 8192, false},
    {16, 4096, false}, {8, 8192, false},  {8, 4096, false},
    {0, 0, true}};
// The longest sum of one slice of a ring plan's gate item (4H / S terms at
// the plan's rows). Longer ones left the kernel's c further from float64
// than the plain version's (twice that distance, PERF.md: H = 449 at 1796
// terms); at W3's 1024 (H = 256) it is as close. Past it the grid plan,
// whose sums run over at most 1,024 terms, takes H.
constexpr int kMaxRingSum = 1024;
constexpr int kNumPlans = sizeof(kPlans) / sizeof(kPlans[0]);
constexpr int kBuffers = 7;        // [H][R + kPad] shared buffers
constexpr int kPad = 4;  // rows of a buffer 16 bytes apart in the banks
constexpr int kMaxSlices = 16;     // threads summing one product item
constexpr int kStagedKeys = 256;   // scores in shared memory up to M keys
// Phase timing (scripts/torch_kernel_phases.py --kernel 2 builds a copy
// with 1): thread 0 of every CTA adds each phase's clock cycles to
// gscan_decode_phase_cycles; off, it compiles to nothing.
constexpr int kPhaseTiming = 0;
constexpr int kPhases = 8;
// [kPhases]: CTA-steps; [kPhases + 1, + 2, + 3]: thread 0's cycles waiting
// for weight tiles to land, in the ring's barriers, and issuing copies
// (inside the products).
constexpr int kCounters = kPhases + 4;
__device__ unsigned long long gscan_decode_phase_cycles[kCounters];

// Adds the cycles since `since` to counter i (thread 0, timing builds).
__device__ __forceinline__ void count_cycles(int i, long long since) {
  if constexpr (kPhaseTiming != 0)
    if (threadIdx.x == 0)
      atomicAdd(&gscan_decode_phase_cycles[i],
                static_cast<unsigned long long>(clock64() - since));
}

struct PhaseClock {
  long long last = 0;
  // Adds the cycles since the last mark to phase p (kPhases: the steps).
  __device__ void mark(int p) {
    if constexpr (kPhaseTiming != 0) {
      __syncthreads();
      if (threadIdx.x == 0) {
        const long long now = clock64();
        if (p < kPhases)
          atomicAdd(&gscan_decode_phase_cycles[p],
                    static_cast<unsigned long long>(now - last));
        else
          atomicAdd(&gscan_decode_phase_cycles[kPhases], 1ull);
        last = now;
      }
    }
  }
};

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

// cp.async copies into shared memory: 16 bytes (.cg, past L1: the weights
// stream from L2) or 4; a commit group per ring tile.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// Segment seg of a step's weights (see Ring): its first row.
__device__ __forceinline__ const float* segment_base(const DecoderWeights& wt,
                                                    int seg, int H) {
  const size_t HH = (size_t)H * H;
  switch (seg) {
    case 0: return wt.txt_qw;
    case 1: return wt.q2k_w;
    case 2: return wt.q2k_w + HH;
    case 3: return wt.vis_qw;
    case 7: return wt.w_hh;
    default:
      return seg < 8 ? wt.w_ih + (size_t)(seg - 4) * 4 * HH
                     : wt.out_w + (size_t)(seg - 8) * HH;
  }
}

// The weights of one step as a stream of tiles through the ring. A step
// reads 12 segments of H weight rows, in the order of the products:
// 0 txt_qw; 1, 2 q2k_w; 3 vis_qw; 4, 5, 6 w_ih; 7 w_hh (N = 4H columns);
// 8 .. 11 out_w (the others N = H). A tile is kt rows of one segment, a
// divisor of H (kt_h for N = H, kt_4h for N = 4H; host-chosen to fill a
// slot), so it is one contiguous run of the weights and never straddles two
// segments. A step whose rows are all done reads segments 0-3 alone (full
// is false). The producer runs kStages - 1 tiles ahead of the consumer,
// across products and into the next step, whose first segments are always
// 0-3.
struct Ring {
  float* base;
  int slot_floats, H, kt_h, kt_4h;
  bool vec;
  bool full = true;    // this step reads segments 4-11 too
  int seg = 0, k0 = 0;  // the next tile to issue
  int put = 0, take = 0;  // the slots of the next tile to issue, to consume

  // The next tile's copy, and the cursor moved on (every thread): every
  // thread's cp.async of 16 bytes where the tiles are 16-byte aligned (vec),
  // else of 4; one commit group per tile, so that cp.async.wait_group counts
  // tiles.
  __device__ void issue(const DecoderWeights& wt) {
    const bool wide = seg >= 4 && seg < 8;
    const int N = wide ? 4 * H : H, kt = wide ? kt_4h : kt_h;
    const float* src = segment_base(wt, seg, H) + (size_t)k0 * N;
    float* dst = base + put * slot_floats;
    const int floats = kt * N;
    if (vec)
      for (int i = 4 * threadIdx.x; i < floats; i += 4 * kThreads)
        cp_async16(dst + i, src + i);
    else
      for (int i = threadIdx.x; i < floats; i += kThreads)
        cp_async4(dst + i, src + i);
    cp_async_commit();
    k0 += kt;
    if (k0 == H) {
      k0 = 0;
      ++seg;
      if (seg == 12 || (seg == 4 && !full)) seg = 0;
    }
    put = put + 1 == kStages ? 0 : put + 1;
  }

  __device__ void prologue(const DecoderWeights& wt) {
    for (int g = 0; g < kStages - 1; ++g) issue(wt);
  }

  // Before the CTA ends: every issued copy has landed.
  __device__ void drain() { cp_async_wait<0>(); }

  // The next tile, landed and visible to every thread; the slot freed by
  // the tile before it (every thread is past it at the barrier) is refilled
  // with the tile kStages - 1 ahead.
  __device__ const float* acquire(const DecoderWeights& wt) {
    long long start = kPhaseTiming ? clock64() : 0;
    cp_async_wait<kStages - 2>();
    count_cycles(kPhases + 1, start);
    start = kPhaseTiming ? clock64() : 0;
    __syncthreads();
    count_cycles(kPhases + 2, start);
    start = kPhaseTiming ? clock64() : 0;
    issue(wt);
    count_cycles(kPhases + 3, start);
    const float* tile = base + take * slot_floats;
    take = take + 1 == kStages ? 0 : take + 1;
    return tile;
  }
};

// acc[j][i] += sum_kk x[kk][i] * w[kk][cols[j]] over kk = k0, k0 + step,
// ... < kt: 8 rows of x (feature-major, leading dim ldx: two float4 a row)
// by kCT columns of w (leading dim ldw; kQuad: cols[0] .. cols[0] + kCT - 1
// read as float4, else one at a time). kHalf: only the first 4 rows (a
// product over at most 4 rows).
template <bool kQuad, bool kHalf>
__device__ __forceinline__ void mac_tile(float (&acc)[kCT][kRT],
                                         const float* w, int ldw, int kt,
                                         const float* x, int ldx,
                                         const int (&cols)[kCT], int k0,
                                         int step) {
  const int w_step = step * ldw, x_step = step * ldx;
  const float* wp = w + k0 * ldw;
  const float* xp = x + k0 * ldx;
#pragma unroll 2
  for (int kk = k0; kk < kt; kk += step, wp += w_step, xp += x_step) {
    float wv[kCT];
    if (kQuad) {
#pragma unroll
      for (int q = 0; q < kCT / 4; ++q) {
        const float4 t =
            *reinterpret_cast<const float4*>(wp + cols[0] + 4 * q);
        wv[4 * q] = t.x, wv[4 * q + 1] = t.y, wv[4 * q + 2] = t.z;
        wv[4 * q + 3] = t.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kCT; ++j) wv[j] = wp[cols[j]];
    }
    constexpr int kRows = kHalf ? 4 : kRT;
    const float4 xa = *reinterpret_cast<const float4*>(xp);
    const float4 xb =
        kHalf ? xa : *reinterpret_cast<const float4*>(xp + 4);
    const float xv[kRT] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
    for (int j = 0; j < kCT; ++j)
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        acc[j][i] = fmaf(xv[i], wv[j], acc[j][i]);
  }
}

// One work item of a product: an 8-row tile (rt) and kCT columns,
// summed over the weight rows by S threads (S adjacent lanes, slice s taking
// rows s, s + S, ... of every tile), S the largest power of two up to
// kMaxSlices that keeps every item's threads within the CTA: so a product
// over few rows still runs on most of the CTA's threads. The S partial sums
// are added by a butterfly of shuffles, every thread of a group then holding
// the sum. kGate: hidden unit u = c, columns u + gH of the 4H gate
// columns for gates g = 0..3 (cols[g]); else columns 4c .. 4c + 3 of H.
// Columns past the last are clamped to it (or, read as a float4, read past
// it) and never stored.
template <bool kGate>
struct Item {
  bool busy, half;  // half: at most 4 rows (mac_tile's kHalf)
  int rt, s, S, c;
  int cols[kCT];
  float acc[kCT][kRT];

  // The product's items n and the threads S summing each.
  __host__ __device__ static void shape(int rows, int H, int& n, int& S) {
    const int per_tile = kGate ? H : (H + kCT - 1) / kCT;
    n = (rows + kRT - 1) / kRT * per_tile;
    S = 1;
    while (S < kMaxSlices && 2 * S * n <= kThreads) S *= 2;
  }

  __device__ Item(int rows, int H) {
    const int per_tile = kGate ? H : (H + kCT - 1) / kCT;
    int n;
    shape(rows, H, n, S);
    half = rows <= 4;
    const int item = threadIdx.x / S;
    s = threadIdx.x % S;
    busy = item < n;
    rt = item / per_tile;
    c = item % per_tile;
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      cols[j] = kGate ? c + j * H : min(kCT * c + j, H - 1);
      for (int i = 0; i < kRT; ++i) acc[j][i] = 0.f;
    }
  }

  // The item's sums over kt weight rows w (N columns) against the inputs
  // xs (leading dim ld); quad: the columns read as a float4.
  __device__ void mac(const float* w, int N, int kt, const float* xs,
                      int ld, bool quad) {
    if (quad && half)
      mac_tile<true, true>(acc, w, N, kt, xs, ld, cols, s, S);
    else if (quad)
      mac_tile<true, false>(acc, w, N, kt, xs, ld, cols, s, S);
    else if (half)
      mac_tile<false, true>(acc, w, N, kt, xs, ld, cols, s, S);
    else
      mac_tile<false, false>(acc, w, N, kt, xs, ld, cols, s, S);
  }

  // Consume the `tiles` tiles of one segment, whose inputs are x [H][ld].
  __device__ void segment(Ring& ring, const DecoderWeights& wt,
                          const float* x, int ld, int kt, int tiles) {
    const int N = kGate ? 4 * ring.H : ring.H;
    for (int i = 0; i < tiles; ++i) {
      const float* w = ring.acquire(wt);
      if (busy)
        mac(w, N, kt, x + (size_t)i * kt * ld + rt * kRT, ld,
            !kGate && ring.vec);
    }
  }

  // Adds the slices' partial sums (every thread of the CTA calls this).
  __device__ void reduce() {
    for (int offset = 1; offset < S; offset <<= 1)
#pragma unroll
      for (int j = 0; j < kCT; ++j)
#pragma unroll
        for (int i = 0; i < kRT; ++i)
          acc[j][i] += __shfl_xor_sync(0xffffffffu, acc[j][i], offset);
  }

  // Whether this thread writes the item's results (its slice 0).
  __device__ bool owner() const { return busy && s == 0; }

  // Column j of a (non-gate) item, or -1 past the last column.
  __device__ int column(int j, int H) const {
    return kCT * c + j < H ? kCT * c + j : -1;
  }

  // out[col][rt * 8 + i] = f(col, acc) for the item's columns.
  template <typename F>
  __device__ void store(float* out, int ld, int H, F f) const {
    if (!owner()) return;
#pragma unroll
    for (int j = 0; j < kCT; ++j) {
      const int col = column(j, H);
      if (col < 0) continue;
      float* o = out + (size_t)col * ld + rt * kRT;
      float v[kRT];
#pragma unroll
      for (int i = 0; i < kRT; ++i) v[i] = f(col, acc[j][i]);
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
};

// One product over `rows` rows: feed(item) consumes its segments, the
// slices' sums are added, finish(item) stores them (the ring's tiles'
// barriers order the product after the writes it reads). Every thread of
// the CTA calls this.
template <bool kGate, typename Feed, typename Finish>
__device__ __forceinline__ void product(int rows, int H, Feed&& feed,
                                        Finish&& finish) {
  Item<kGate> item(rows, H);
  feed(item);
  item.reduce();
  finish(item);
}

// Keys per warp of the scores' shared-memory rows (0: staged in the
// weights output).
__host__ __device__ int staged_keys(int Mt, int Mv) {
  const int m = Mt > Mv ? Mt : Mv;
  return m <= kStagedKeys ? m : 0;
}

// The rows this CTA takes, into s_row[slot]: every CTA ranks all rows,
// emitting (not done) first, each class in batch order, and takes ranks
// blockIdx.x, blockIdx.x + G, ... Returns the count of rows and, through
// n_emit, how many of them (the first slots) are emitting.
__device__ int select_rows(const unsigned char* __restrict__ done_in, int B,
                           int* s_row, int* s_scan, int& n_emit) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x, cta = blockIdx.x;
  int count = 0;
  for (int b = tid; b < B; b += kThreads) count += done_in[b] == 0;
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    count += __shfl_xor_sync(0xffffffffu, count, offset);
  if (lane == 0) s_scan[warp] = count;
  __syncthreads();
  int emitting = 0;
  for (int w = 0; w < kWarps; ++w) emitting += s_scan[w];
  __syncthreads();

  int emit_before = 0, done_before = 0;
  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < B; base += kThreads) {
    const int b = base + tid;
    const bool emit = b < B && done_in[b] == 0;
    const bool done = b < B && !emit;
    const unsigned be = __ballot_sync(0xffffffffu, emit);
    const unsigned bd = __ballot_sync(0xffffffffu, done);
    if (lane == 0) {
      s_scan[warp] = __popc(be);
      s_scan[kWarps + warp] = __popc(bd);
    }
    __syncthreads();
    int pe = 0, pd = 0, te = 0, td = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int e = s_scan[w], d = s_scan[kWarps + w];
      if (w < warp) pe += e, pd += d;
      te += e, td += d;
    }
    if (emit || done) {
      const int rank = emit ? emit_before + pe + __popc(be & below)
                            : emitting + done_before + pd + __popc(bd & below);
      if (rank % G == cta) s_row[rank / G] = b;
    }
    emit_before += te;
    done_before += td;
    __syncthreads();
  }
  n_emit = emitting > cta ? (emitting - cta + G - 1) / G : 0;
  return (B - cta + G - 1) / G;
}

// One of a step's two attentions, for the n rows of the attention set
// (slots [0, n)): W warps a row, W the largest power of two that the CTA's
// warps hold at n rows; with W > 1 each warp takes a chunk of the row's
// keys (attend.cuh, AttendPass) and the chunks are combined through shared
// memory (parts, [kWarps][H + 2]), so that few rows still keep many loads
// in flight. ctx and pq are [H][ld] buffers; scores: [kWarps][m_s] (m_s = 0:
// the weights output). Every thread of the CTA calls this.
template <int NC>
__device__ void attend_rows(int n, const int* s_row, const float* pq,
                            int ld, const float* __restrict__ keys,
                            const float* __restrict__ mask,
                            const float* __restrict__ ew, int M, int H,
                            float* ctx, float* weights, float* scores,
                            int m_s, float* parts, bool vec) {
  const int warp = threadIdx.x >> 5;
  int W = 1;
  while (2 * W * n <= kWarps) W *= 2;
  for (int task = warp; task < n * W; task += kWarps) {
    const int s = task / W, w = task % W;
    const size_t b = s_row[s];
    float* row_weights = weights + b * M;
    float* row_scores =
        m_s ? scores + (W == 1 ? warp : s * W) * m_s : row_weights;
    const float* row_mask = mask != nullptr ? mask + b * M : nullptr;
    if (W == 1) {
      gscan::attend_row<NC>(pq + s, ld, keys + b * M * H, row_mask, ew, M,
                            H, ctx + s, ld, row_weights, row_scores, vec);
      continue;
    }
    const int chunk = (M + W - 1) / W;
    const int m_begin = min(M, w * chunk);
    const gscan::AttendPass<NC> pass(pq + s, ld, keys + b * M * H, row_mask,
                                     ew, m_begin, min(M, m_begin + chunk), M,
                                     H, row_scores, vec);
    pass.save(parts + task * (H + 2), H);
  }
  if (W == 1) return;
  __syncthreads();
  if (warp < n) {
    const size_t b = s_row[warp];
    gscan::attend_combine(parts + warp * W * (H + 2), W, M, H, ctx + warp,
                          ld, weights + b * M,
                          m_s ? scores + warp * W * m_s : weights + b * M);
  }
}

// NC: attend.cuh's chunks of 128 features (chosen by the host from H).
template <int NC>
__global__ void __launch_bounds__(kThreads, 1) decode_block_kernel(
    const float* __restrict__ proj_txt, const float* __restrict__ cmd_mask,
    const float* __restrict__ proj_vis, const float* __restrict__ h_in,
    const float* __restrict__ c_in, const int* __restrict__ tok_in,
    const unsigned char* __restrict__ done_in, DecoderWeights wt,
    float* __restrict__ h_out, float* __restrict__ c_out,
    int* __restrict__ tok_out, unsigned char* __restrict__ done_out,
    int* __restrict__ step_tokens, float* __restrict__ step_emitted,
    float* step_attn_cmd, float* step_attn_sit, int B, int Mt, int Mv, int H,
    int V, int K, int eos, int R, int slot_floats, int kt_h, int kt_4h,
    bool vec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int LD = R + kPad;  // the buffers' leading dim: [feature][LD]
  const int HR = H * LD;
  float* ring_base = smem;
  float* buf = ring_base + kStages * slot_floats;
  float* tail = buf + kBuffers * HR;  // what follows the buffers
  // The carried state (h, c) and the two scratch buffers (A: a projected
  // query, then the head's hidden layer; B: the visual query, then the new
  // hidden state) trade places at every step's compaction.
  float* s_h = buf;
  float* s_c = buf + HR;
  float* s_emb = buf + 2 * HR;   // embedded previous token
  float* s_ctxc = buf + 3 * HR;  // textual context
  float* s_ctxs = buf + 4 * HR;  // visual context
  float* s_a = buf + 5 * HR;
  float* s_b = buf + 6 * HR;
  float* s_logits = tail;  // [R][V]
  int* s_row = reinterpret_cast<int*>(s_logits + R * V);  // batch row
  int* s_tok = s_row + R;                                 // last token
  int* s_row_next = s_tok + R;  // the same two after the compaction
  int* s_tok_next = s_row_next + R;
  int* s_perm = s_tok_next + R;  // new slot of each slot
  int* s_scan = s_perm + R;      // [2 kWarps] (also the new counts)
  // Each warp's attention scores, [kWarps][m_s] (m_s = 0: in the output),
  // and the chunks' softmax states, [kWarps][H + 2].
  const int m_s = staged_keys(Mt, Mv);
  float* s_scores = reinterpret_cast<float*>(s_scan + 2 * kWarps);
  float* s_parts = s_scores + kWarps * m_s;

  Ring ring{ring_base, slot_floats, H, kt_h, kt_4h, vec};
  ring.prologue(wt);

  for (int i = tid; i < kBuffers * HR; i += kThreads) buf[i] = 0.f;
  int n_emit;
  const int rows = select_rows(done_in, B, s_row, s_scan, n_emit);
  int n_done = rows - n_emit;  // done at step t, before retiring: slots
                               // [n_emit, n_emit + n_done)
  for (int i = tid; i < rows * H; i += kThreads) {
    const int s = i / H, u = i % H;
    const size_t row = s_row[s];
    s_h[u * LD + s] = h_in[row * H + u];
    s_c[u * LD + s] = c_in[row * H + u];
  }
  if (tid < rows) s_tok[tid] = tok_in[s_row[tid]];
  __syncthreads();

  const int th = H / kt_h, t4 = H / kt_4h;  // tiles per segment
  // Segment seg of a step's weights (see Ring) into an item's sums, against
  // the inputs x, through the ring.
  auto feed = [&](auto& item, int seg, const float* x) {
    const bool gate = seg >= 4 && seg < 8;
    item.segment(ring, wt, x, LD, gate ? kt_4h : kt_h, gate ? t4 : th);
  };
  const auto same = [](int, float v) { return v; };
  PhaseClock clock;
  for (int t = 0; t < K; ++t) {
    const int n_attn = n_emit + n_done;
    if (n_attn == 0) break;  // every row retired: the block is written
    ring.full = n_emit > 0;
    clock.mark(kPhases);

    // Embedding of the previous token (emitting rows).
    for (int i = tid; i < n_emit * H; i += kThreads) {
      const int s = i / H, u = i % H;
      s_emb[u * LD + s] = __ldg(wt.emb + (size_t)s_tok[s] * H + u);
    }

    // Textual query h W_q.
    product<false>(
        n_attn, H, [&](auto& item) { feed(item, 0, s_h); },
        [&](auto& item) { item.store(s_a, LD, H, same); });
    __syncthreads();
    clock.mark(0);
    attend_rows<NC>(n_attn, s_row, s_a, LD, proj_txt, cmd_mask, wt.txt_ew,
                    Mt, H, s_ctxc, step_attn_cmd + (size_t)t * B * Mt,
                    s_scores, m_s, s_parts, vec);
    clock.mark(1);
    // Conditional visual query tanh([h; ctx_cmd] W + b).
    product<false>(
        n_attn, H,
        [&](auto& item) {
          feed(item, 1, s_h);
          feed(item, 2, s_ctxc);
        },
        [&](auto& item) {
          item.store(s_b, LD, H, [&](int col, float v) {
            return tanhf(v + __ldg(wt.q2k_b + col));
          });
        });
    // Projected visual query.
    product<false>(
        n_attn, H, [&](auto& item) { feed(item, 3, s_b); },
        [&](auto& item) { item.store(s_a, LD, H, same); });
    __syncthreads();
    clock.mark(2);
    attend_rows<NC>(n_attn, s_row, s_a, LD, proj_vis, nullptr, wt.vis_ew,
                    Mv, H, s_ctxs, step_attn_sit + (size_t)t * B * Mv,
                    s_scores, m_s, s_parts, vec);
    clock.mark(3);

    if (n_emit > 0) {
      // LSTM gates [emb; ctx_cmd; ctx_sit] W_ih + h W_hh + b, and the cell;
      // c and the new h for the emitting rows only.
      product<true>(
          n_emit, H,
          [&](auto& item) {
            feed(item, 4, s_emb);
            feed(item, 5, s_ctxc);
            feed(item, 6, s_ctxs);
            feed(item, 7, s_h);
          },
          [&](auto& item) {
            if (!item.owner()) return;
            const int u = item.c;  // acc[g]: gate g of unit u
            const float bi = __ldg(wt.bias + u), bf = __ldg(wt.bias + H + u);
            const float bg = __ldg(wt.bias + 2 * H + u);
            const float bo = __ldg(wt.bias + 3 * H + u);
            const auto& a = item.acc;
#pragma unroll
            for (int i = 0; i < kRT; ++i) {
              const int s = item.rt * kRT + i;
              if (s >= n_emit) break;
              const float c_new =
                  sigmoidf(a[1][i] + bf) * s_c[u * LD + s] +
                  sigmoidf(a[0][i] + bi) * tanhf(a[2][i] + bg);
              s_b[u * LD + s] = sigmoidf(a[3][i] + bo) * tanhf(c_new);
              s_c[u * LD + s] = c_new;
            }
          });
      clock.mark(4);
      // Head's hidden layer [emb; h_new; ctx_cmd; ctx_sit] W_out, and the
      // carried h. Nothing here reads s_h.
      product<false>(
          n_emit, H,
          [&](auto& item) {
            feed(item, 8, s_emb);
            feed(item, 9, s_b);
            feed(item, 10, s_ctxc);
            feed(item, 11, s_ctxs);
          },
          [&](auto& item) {
            item.store(s_a, LD, H, same);
            if (!item.owner()) return;
            for (int j = 0; j < kCT; ++j) {
              const int col = item.column(j, H);
              for (int i = 0; col >= 0 && i < kRT; ++i) {
                const int s = item.rt * kRT + i;
                if (s < n_emit) s_h[col * LD + s] = s_b[col * LD + s];
              }
            }
          });
      __syncthreads();
      clock.mark(5);
      // Logits, one (row, token) pair per thread.
      for (int i = tid; i < n_emit * V; i += kThreads) {
        const int s = i / V, v = i % V;
        float a = 0.f;
        for (int k = 0; k < H; ++k)
          a = fmaf(s_a[k * LD + s],
                   __ldg(wt.out_proj + (size_t)k * V + v), a);
        s_logits[i] = a;
      }
      clock.mark(6);
    }
    __syncthreads();

    // Argmax (first maximum wins), the step's tokens and flags, and the
    // compaction: slots go emitting, then newly done (EOS now), then those
    // done this step (retiring), then retired, each in order.
    if (warp == 0) {
      const int s = lane;
      int best = 0, cls = 3;
      if (s < n_attn) {
        const size_t o = (size_t)t * B + s_row[s];
        if (s < n_emit) {
          const float* lg = s_logits + s * V;
          float best_value = lg[0];
          for (int v = 1; v < V; ++v)
            if (lg[v] > best_value) {
              best_value = lg[v];
              best = v;
            }
          step_tokens[o] = best;
          step_emitted[o] = 1.f;
          cls = best == eos ? 1 : 0;
        } else {
          step_tokens[o] = 0;
          step_emitted[o] = 0.f;
          cls = 2;
        }
      }
      const bool slot = s < R;
      const unsigned b0 = __ballot_sync(0xffffffffu, slot && cls == 0);
      const unsigned b1 = __ballot_sync(0xffffffffu, slot && cls == 1);
      const unsigned b2 = __ballot_sync(0xffffffffu, slot && cls == 2);
      const unsigned b3 = __ballot_sync(0xffffffffu, slot && cls == 3);
      const unsigned below = (1u << lane) - 1u;
      const unsigned mine = cls == 0 ? b0 : cls == 1 ? b1 : cls == 2 ? b2 : b3;
      int pos = __popc(mine & below);
      if (cls > 0) pos += __popc(b0);
      if (cls > 1) pos += __popc(b1);
      if (cls > 2) pos += __popc(b2);
      if (slot) {
        s_perm[s] = pos;
        s_row_next[pos] = s_row[s];
        s_tok_next[pos] = s < n_emit ? best : s_tok[s];
      }
      if (lane == 0) {
        s_scan[0] = __popc(b0);
        s_scan[1] = __popc(b1);
      }
    }
    __syncthreads();

    // The retiring rows' attention rows and zeros for the rest of the block.
    const int rest = K - 1 - t;
    if (n_done > 0 && rest > 0) {
      const int Mw = Mt + Mv;
      for (int i = tid; i < n_done * Mw; i += kThreads) {
        const int f = i / Mw, m = i % Mw;
        const size_t b = s_row[n_emit + f];
        float* out = m < Mt ? step_attn_cmd + b * Mt + m
                            : step_attn_sit + b * Mv + (m - Mt);
        const size_t stride = (size_t)B * (m < Mt ? Mt : Mv);
        const float v = out[t * stride];
        for (int u = t + 1; u < K; ++u) out[u * stride] = v;
      }
      for (int i = tid; i < n_done * rest; i += kThreads) {
        const size_t o = (size_t)(t + 1 + i % rest) * B +
                         s_row[n_emit + i / rest];
        step_tokens[o] = 0;
        step_emitted[o] = 0.f;
      }
    }
    // The carried state, moved to the new slots (into the free buffers).
    for (int i = tid; i < H * R; i += kThreads) {
      const int row = (i / R) * LD;
      s_a[row + s_perm[i % R]] = s_h[row + i % R];
      s_b[row + s_perm[i % R]] = s_c[row + i % R];
    }
    n_emit = s_scan[0];
    n_done = s_scan[1];
    __syncthreads();
    clock.mark(7);
    float* f;
    f = s_h, s_h = s_a, s_a = f;
    f = s_c, s_c = s_b, s_b = f;
    int* p;
    p = s_row, s_row = s_row_next, s_row_next = p;
    p = s_tok, s_tok = s_tok_next, s_tok_next = p;
  }
  ring.drain();

  // Slots [0, n_emit) are still emitting; the rest are done.
  for (int i = tid; i < rows * H; i += kThreads) {
    const int s = i / H, u = i % H;
    const size_t row = s_row[s];
    h_out[row * H + u] = s_h[u * LD + s];
    c_out[row * H + u] = s_c[u * LD + s];
  }
  if (tid < rows) {
    tok_out[s_row[tid]] = s_tok[tid];
    done_out[s_row[tid]] = tid >= n_emit;
  }
}

size_t decode_block_smem_bytes(int H, int V, int Mt, int Mv, Plan plan) {
  if (plan.grid) return gscan_decode_grid_smem_bytes(H, Mt, Mv);
  const size_t R = plan.rows;
  return ((size_t)kStages * plan.slot_floats +
          (size_t)kBuffers * H * (R + kPad) + (size_t)R * V +
          (size_t)kWarps * staged_keys(Mt, Mv) + (size_t)kWarps * (H + 2)) *
             sizeof(float) +
         (5 * R + 2 * kWarps) * sizeof(int);
}

// The largest divisor of H whose tile of that many rows of N columns fills
// at most a ring slot.
int tile_rows(int H, int N, int slot_floats) {
  int best = 1;
  for (int k = 1; k <= H && k * N <= slot_floats; ++k)
    if (H % k == 0) best = k;
  return best;
}

// Whether a plan takes these shapes. A ring plan: every product's items one
// per thread (ceil(R / 8) x H <= 512 for the gates), a gate slice's sum of
// at most kMaxRingSum terms, a gate tile row in a slot, attend_row's
// registers (H <= 512). The grid plan: any H.
bool plan_takes(Plan plan, int H) {
  if (plan.grid) return true;
  int n, S;
  Item<true>::shape(plan.rows, H, n, S);
  const int attend = gscan::attend_chunks(H);
  return attend > 0 && attend <= 4 && n <= kThreads &&
         4 * H <= kMaxRingSum * S && 4 * H <= plan.slot_floats;
}

}  // namespace

// The phase timing's counters (kPhaseTiming): copies the per-phase cycles
// summed over CTAs, the count of CTA-steps and the ring's wait, barrier and
// issue cycles into out[kPhases + 4], then zeroes them.
extern "C" int gscan_decode_block_phase_cycles(unsigned long long* out) {
  static_assert(sizeof(gscan_decode_phase_cycles) ==
                kCounters * sizeof(unsigned long long), "counters");
  cudaError_t err = cudaMemcpyFromSymbol(out, gscan_decode_phase_cycles,
                                         sizeof(gscan_decode_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zeros[kCounters] = {};
  return static_cast<int>(cudaMemcpyToSymbol(gscan_decode_phase_cycles,
                                             zeros, sizeof(zeros)));
}

// The first plan (kPlans) that takes these shapes within the shared memory
// a CTA may have, or -1. *needed receives the bytes of the plan taken, or
// of the last plan tried when none fits.
extern "C" int gscan_decode_block_plan(int H, int V, int Mt, int Mv,
                                       long long available,
                                       long long* needed) {
  for (int i = 0; i < kNumPlans; ++i) {
    const long long need = static_cast<long long>(
        decode_block_smem_bytes(H, V, Mt, Mv, kPlans[i]));
    *needed = need;
    if (plan_takes(kPlans[i], H) && need <= available) return i;
  }
  return -1;
}

// Rows per CTA and floats per ring slot (0 for the grid plan), and whether
// it is the grid plan, of a plan.
extern "C" int gscan_decode_block_plan_rows(int plan) {
  return plan >= 0 && plan < kNumPlans ? kPlans[plan].rows : 0;
}
extern "C" int gscan_decode_block_plan_slot_floats(int plan) {
  return plan >= 0 && plan < kNumPlans ? kPlans[plan].slot_floats : 0;
}
extern "C" int gscan_decode_block_plan_grid(int plan) {
  return plan >= 0 && plan < kNumPlans && kPlans[plan].grid;
}

// Floats of the scratch gscan_decode_block needs at batch B (0: none; the
// grid plan's activations).
extern "C" long long gscan_decode_block_scratch_floats(int plan, int B,
                                                       int H, int V) {
  if (plan < 0 || plan >= kNumPlans || !kPlans[plan].grid || B <= 0 ||
      H <= 0 || V <= 0)
    return 0;
  return static_cast<long long>(gscan_decode_grid_scratch_floats(B, H, V));
}

// plan from gscan_decode_block_plan; vec: H % 4 == 0 and the keys and
// weights 16-byte aligned (checked by the wrapper); scratch: the plan's
// gscan_decode_block_scratch_floats, or null where that is 0.
extern "C" int gscan_decode_block(
    const float* proj_txt, const float* cmd_mask, const float* proj_vis,
    const float* h_in, const float* c_in, const int* tok_in,
    const unsigned char* done_in, const float* txt_qw, const float* txt_ew,
    const float* q2k_w, const float* q2k_b, const float* vis_qw,
    const float* vis_ew, const float* emb, const float* w_ih,
    const float* w_hh, const float* bias, const float* out_w,
    const float* out_proj, float* h_out, float* c_out, int* tok_out,
    unsigned char* done_out, int* step_tokens, float* step_emitted,
    float* step_attn_cmd, float* step_attn_sit, float* scratch, int B,
    int Mt, int Mv, int H, int V, int K, int eos, int plan_index, int vec,
    void* stream) {
  if (B <= 0 || K <= 0 || V <= 0 || H <= 0 || Mt <= 0 || Mv <= 0 ||
      plan_index < 0 || plan_index >= kNumPlans ||
      !plan_takes(kPlans[plan_index], H) ||
      (kPlans[plan_index].grid != (scratch != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan plan = kPlans[plan_index];
  if (plan.grid)
    return gscan_decode_grid(
        proj_txt, cmd_mask, proj_vis, h_in, c_in, tok_in, done_in, txt_qw,
        txt_ew, q2k_w, q2k_b, vis_qw, vis_ew, emb, w_ih, w_hh, bias, out_w,
        out_proj, h_out, c_out, tok_out, done_out, step_tokens, step_emitted,
        step_attn_cmd, step_attn_sit, scratch, B, Mt, Mv, H, V, K, eos, vec,
        stream);
  const int attend = gscan::attend_chunks(H);
  auto kernel = attend == 1   ? decode_block_kernel<1>
                : attend == 2 ? decode_block_kernel<2>
                              : decode_block_kernel<4>;
  const size_t smem = decode_block_smem_bytes(H, V, Mt, Mv, plan);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const DecoderWeights wt{txt_qw, txt_ew, q2k_w, q2k_b, vis_qw, vis_ew,
                          emb,    w_ih,   w_hh,  bias,  out_w,  out_proj};
  const dim3 grid((B + plan.rows - 1) / plan.rows);
  const int kt_h = tile_rows(H, H, plan.slot_floats);
  const int kt_4h = tile_rows(H, 4 * H, plan.slot_floats);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      proj_txt, cmd_mask, proj_vis, h_in, c_in, tok_in, done_in, wt, h_out,
      c_out, tok_out, done_out, step_tokens, step_emitted, step_attn_cmd,
      step_attn_sit, B, Mt, Mv, H, V, K, eos, plan.rows, plan.slot_floats,
      kt_h, kt_4h, vec != 0);
  return static_cast<int>(cudaGetLastError());
}
