// The tile kernels (K1, K2), the pose solver (K3), the keyframe tracker
// (K4) and the match-and-depth stage (K5) built for the host under tests/cuda_host_emu.h, with their
// own launchers, plus an export of one block's reciprocal tables. Built and driven by tests/tile_host.py.

#include "detect_candidates.cu"
#include "build_scale_space.cu"
#include "pose_lm.cu"
#include "kf_correct.cu"
#include "match_depth.cu"

// The row then column reciprocal tables that load_tile builds for block
// (bx, by) under the plan given as the launchers take it; entries of
// passes the plan lacks stay NaN. Returns 1 if the plan is refused.
extern "C" int tile_reciprocals(int H, int W, int bx, int by, int halo,
                                int win_s, int e0, int e1, const int* r0,
                                int n0, const int* r1, int n1, float* out) {
  tp::Plan pl;
  if (!tp::plan_from_args(&pl, halo, win_s, e0, e1, r0, n0, r1, n1))
    return 1;
  for (int i = 0; i < tp::N_INV; ++i) {
    out[i] = std::numeric_limits<float>::quiet_NaN();
    tp::recip_entry(pl, i, by * tp::OH, bx * tp::OW, H, W, out + i);
  }
  return 0;
}

extern "C" int tile_table_shape(int* n_inv_rows, int* br, int* nx, int* hp) {
  *n_inv_rows = tp::N_INV_ROWS;
  *br = tp::BR;
  *nx = tp::NX;
  *hp = tp::HP;
  return tp::MAX_BOXES;
}
