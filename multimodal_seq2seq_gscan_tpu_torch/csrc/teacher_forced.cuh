// The decoder weights and kernel 4's stash layout, shared by kernels 3 and
// 4's cluster plans (teacher_forced.cu) and grid plans
// (teacher_forced_grid.cu).
#pragma once

#include <cuda_runtime.h>

namespace gscan {
namespace tf {

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

// Column offsets of a row-step in the stash (ops/teacher_forced.py). The
// one-hot segment is padded with zeros to P = V rounded up to 4 columns.
struct Stash {
  int onehot, emb, h_new, ctx_cmd, ctx_sit, ph, vq, d_ph, d_gates, d_pq_vis,
      d_joint, d_pq_txt, d_emb, g_vis_ew, g_txt_ew, width;
  __host__ __device__ Stash(int V, int E, int H)
      : onehot(0), emb(pad(V)), h_new(pad(V) + E), ctx_cmd(pad(V) + E + H),
        ctx_sit(pad(V) + E + 2 * H), ph(pad(V) + E + 3 * H),
        vq(pad(V) + E + 4 * H), d_ph(pad(V) + E + 5 * H),
        d_gates(pad(V) + E + 6 * H), d_pq_vis(pad(V) + E + 10 * H),
        d_joint(pad(V) + E + 11 * H), d_pq_txt(pad(V) + E + 12 * H),
        d_emb(pad(V) + E + 13 * H), g_vis_ew(pad(V) + 2 * E + 13 * H),
        g_txt_ew(pad(V) + 2 * E + 14 * H), width(pad(V) + 2 * E + 15 * H) {}
  __host__ __device__ static int pad(int V) { return (V + 3) / 4 * 4; }
};

}  // namespace tf
}  // namespace gscan
