// The whole 2D fluid step as one kernel per direction, for Hopper (sm_90a).
//
// Replaces the TPU kernels pde_control_tpu/ops/pallas_fluid.py ::
// _make_fused_step._forward (body _fwd_kernel) and ._backward (body
// _bwd_kernel), and computes what they compute for each batch sample, on
// one thread-block cluster of C blocks per sample:
//
//   fused_fwd_kernel (K2): shift advection of the density and of both MAC
//     velocity components (the clipped, edge-clamped (2k+2)^2 hat window of
//     _advect_window), inflow, force, buoyancy, the wall and obstacle
//     masks, the divergence, the warm or cold PCG pressure solve
//     (pcg_cluster.cuh), and the closed-wall pressure-gradient correction;
//   fused_bwd_kernel (K3): the hand-written VJP: a cold transpose solve on
//     the pressure cotangent (pcg_cluster.cuh), the stencil and face/centre
//     adjoints, and the three window adjoints with JAX's tie rules (d|x|/dx
//     = +1 at x = 0, the hat's and the clip's derivatives 0.5 at their
//     kinks). The displacements are recomputed from the step's inputs;
//     nothing else is saved between the directions.
//
// Design for the card. Rank c of C owns a band of rows (pcg_cluster.cuh ::
// Band) and keeps everything in shared memory: the basis, three whole-field
// copies for the solve (the residual, the scaled spectrum, A d) and its
// band's iterates; K2 also its band's advected velocities, the density one
// row beyond the band each side and the row of the pressure above it
// (fwd_layout below; 99,360 bytes at 64^2 and C = 8, the plan at batch 8;
// ops/cuda_fluid.py :: fwd_shared_bytes); K3 for the window adjoints its
// band widened by k + 1 rows (bwd_layout; 94,208 bytes at 64^2 and C = 8;
// ops/cuda_fluid.py :: bwd_shared_bytes). On a grid where that fits a
// block under no cluster size (K2 from 109^2, K3 from 112^2), every plan
// of the kernel takes the core's large layout, as K1 does (pcg_cluster.cuh's
// header): the basis read from L2 and the residual exchanged by bands, no
// basis and no copy of A d in shared memory (fused_fwd_kernel<512, 1>,
// 209,728 bytes at 128^2 and C = 8; fused_bwd_kernel<512, 0, 1>, 191,232
// bytes). Where the large layout fits no cluster size either (K2 from
// 146^2 on squares, K3 from 152^2, to the JAX package's fused gate's edge:
// 236^2, 8 x 994, 431 x 8), every plan takes the banded layout
// (fused_fwd_kernel<512, 2>, fused_bwd_kernel<512, 0, 2>): no whole field
// in shared memory; the solve's residual and scaled spectrum whole in a
// scratch in global memory that the wrapper allocates, as K1's banded
// kernel holds them. K3's window phase, whose twelve arrays on the band
// widened by k + 1 rows fit a block under no cluster size at 236^2
// (231,920 bytes at C = 16 beside the persistent 14,928), moves into the
// same scratch, each rank's part its own (bwd_layout). 138,048 bytes of
// shared memory for K2 at 236^2 and C = 16, 105,888 for K3. The layouts
// share every line of the windows and their adjoints; in the small and
// large ones K3's window phase reuses the space the solve leaves.
//
// The step's inputs are read-only for the whole launch and are read from
// global memory through L1 (__ldg), with clamped indices standing in for
// the edge padding; everything the kernels compute themselves (the
// divergence, the masked velocity, the pressure, the cotangents) is read
// with plain loads after a barrier, never through the read-only path.
// The window adjoint's field cotangent is a gather: each thread owns its
// target cells and sums, in a fixed order, every window term whose clamped
// source is that cell, which folds the edge padding in as well. Each
// source cell's taps (the floor offsets of its clipped displacement and
// the hat weights there) are computed once, so a candidate is an integer
// compare; the displacement cotangents run over the four offsets per axis
// where the hat or its derivative can be nonzero. No atomics, so the
// result is deterministic. Window terms whose weight is exactly zero are
// skipped: for finite fields they add exact zeros in the plain version.
//
// Non-finite values. The plain version multiplies every tap, so a NaN or
// an infinity anywhere in a window (0 * inf is NaN) makes the window's
// result NaN. A sample whose inputs or window cotangents hold a non-finite
// value therefore sums every tap (`dense`, one vote over the cluster), and
// the clip and the hat pass NaN through as torch.clamp does. The
// non-finite cells of the outputs are then the plain version's, so a
// diverged state still gives non-finite gradients and the training step
// skips its update.
//
// What bounds them: latency. A sample spreads over C SMs (C up to 16,
// chosen by ops/cuda_fluid.py :: fwd_plan and bwd_plan to fill the card):
// a CG trip's products and stencil are 1/C of the work, around three
// cluster barriers (four in the large and banded layouts), and the windows
// and their adjoints run on C SMs with no exchange but one push of the
// pressure's edge row (K2) or one pull of the solution's neighbouring rows
// (K3). In the banded layout the solve's products and K3's window phase
// also read L2.
// Each kernel is one launch per direction with no host round trip. The
// launch bounds allow one block per SM, which leaves each thread of a
// 512-thread block up to 128 registers; K3's solve is a function of its
// own (not inlined), so that its registers and the window adjoints' are
// allocated apart.
//
// Floating-point contraction. nvcc contracts a*b+c into an FMA by default,
// which rounds once instead of twice. A displacement that moved by one
// rounding could cross a tie of the hat or the clip (0, +-1, +-k) that the
// plain version sits on, so every displacement is formed with __fmul_rn,
// which is never contracted: s * v, s * 0.5 (a + b) and
// s * 0.5 (0.5 (a + b) + 0.5 (c + d)) are the plain version's values bit
// for bit, and so are the hat weights and the tie tests. FMAs do form in
// the sums that follow; they move results by rounding only.

#include "pcg_cluster.cuh"

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// clip(d, -k, k) and max(0, 1-|d|); both return NaN for NaN (fminf and
// fmaxf would return the other operand).
__device__ __forceinline__ float clip(float d, float k) {
  return d > k ? k : (d < -k ? -k : d);
}

__device__ __forceinline__ float hat(float d) {
  const float v = 1.f - fabsf(d);
  return v < 0.f ? 0.f : v;
}

// d/dd max(0, 1-|d|) with JAX's subgradients: sign(0) = +1 (also for -0.0),
// and the max's tie at |d| = 1 splits 0.5. Like the plain version it gives
// 0 for NaN; the NaN reaches the result through hat() and the cotangent.
__device__ __forceinline__ float hat_grad(float d) {
  const float a = fabsf(d);
  const float mag = a < 1.f ? 1.f : (a == 1.f ? 0.5f : 0.f);
  return d >= 0.f ? -mag : mag;
}

// d clip(d, -k, k)/dd with JAX's tie rule (0.5 at the bound).
__device__ __forceinline__ float clip_grad(float d, float k) {
  const float a = fabsf(d);
  return a < k ? 1.f : (a == k ? 0.5f : 0.f);
}

// One sample's inputs and the step's constants.
struct Step {
  const float* vy;   // (H+1, W), this block's sample
  const float* vx;   // (H, W+1)
  const float* rho;  // (H, W)
  int h, w;
  float s;        // -dt/dx: displacement per unit velocity
  float dt, dx;
  float dt_buoy;  // dt * buoyancy
  bool buoy;      // buoyancy != 0
  int k;          // max_shift

  // Velocity at cell centres and at the other component's faces, exactly
  // as _centers_y/_centers_x and _to_y_faces/_to_x_faces compute them.
  __device__ float vy_c(int i, int j) const {
    return __fmul_rn(0.5f, __ldg(vy + i * w + j) + __ldg(vy + (i + 1) * w + j));
  }
  __device__ float vx_c(int i, int j) const {
    return __fmul_rn(0.5f, __ldg(vx + i * (w + 1) + j) + __ldg(vx + i * (w + 1) + j + 1));
  }

  // The displacements (s times the velocity) of the three windows at one
  // output cell: the density's at cell (i, j), vy's at y-face (i, j) with
  // i in [0, H], vx's at x-face (i, j) with j in [0, W].
  __device__ void disp_rho(int i, int j, float& dy, float& dx) const {
    dy = __fmul_rn(s, vy_c(i, j));
    dx = __fmul_rn(s, vx_c(i, j));
  }
  __device__ void disp_vy(int i, int j, float& dy, float& dx) const {
    dy = __fmul_rn(s, __ldg(vy + i * w + j));
    dx = __fmul_rn(s, __fmul_rn(0.5f, vx_c(max(i - 1, 0), j) + vx_c(min(i, h - 1), j)));
  }
  __device__ void disp_vx(int i, int j, float& dy, float& dx) const {
    dy = __fmul_rn(s, __fmul_rn(0.5f, vy_c(i, max(j - 1, 0)) + vy_c(i, min(j, w - 1))));
    dx = __fmul_rn(s, __ldg(vx + i * (w + 1) + j));
  }
};

// _advect_window at one output cell (i, j) of an m x n field f (global,
// read-only): sum over oy, ox in [-k, k+1] of
// f[clamp(i+oy), clamp(j+ox)] * hat(dyc - oy) * hat(dxc - ox), factored as
// sum_oy wy * (sum_ox f * wx), with the displacement clipped to +-k.
// Zero-weight taps are skipped unless `dense`.
__device__ float window(const float* f, int m, int n, int i, int j, float dy,
                        float dx, int k, bool dense) {
  const float kf = static_cast<float>(k);
  const float dyc = clip(dy, kf), dxc = clip(dx, kf);
  float out = 0.f;
  for (int oy = -k; oy <= k + 1; ++oy) {
    const float wy = hat(dyc - oy);
    if (wy == 0.f && !dense) continue;
    const float* row = f + clampi(i + oy, 0, m - 1) * n;
    float inner = 0.f;
    for (int ox = -k; ox <= k + 1; ++ox) {
      const float wx = hat(dxc - ox);
      if (wx == 0.f && !dense) continue;
      inner += __ldg(row + clampi(j + ox, 0, n - 1)) * wx;
    }
    out += inner * wy;
  }
  return out;
}

// The displacement cotangents of _advect_window_T at one cell, for output
// cotangent g: hat-derivative windows chained through the clip. For a
// finite clipped displacement dc with f = floor(dc), the hat is nonzero only
// at offsets f and f + 1, and its derivative only at f - 1 .. f + 2 (three
// of them where fl(dc - oy) is +-1, as at an integer dc), so the sums run
// over those four offsets per axis, in the plain version's order and with
// its weights; taps where both weights are zero add exact zeros and are
// skipped. `dense` sums every tap of the (2k+2)^2 window.
__device__ void window_disp_T(const float* f, int m, int n, int i, int j,
                              float g, float dy, float dx, int k, bool dense,
                              float& g_dy, float& g_dx) {
  const float kf = static_cast<float>(k);
  const float dyc = clip(dy, kf), dxc = clip(dx, kf);
  float s_dy = 0.f, s_dx = 0.f;
  if (dense) {
    for (int oy = -k; oy <= k + 1; ++oy) {
      const float wy = hat(dyc - oy), wyp = hat_grad(dyc - oy);
      const float* row = f + clampi(i + oy, 0, m - 1) * n;
      float ady = 0.f, adx = 0.f;
      for (int ox = -k; ox <= k + 1; ++ox) {
        const float wx = hat(dxc - ox), wxp = hat_grad(dxc - ox);
        const float val = __ldg(row + clampi(j + ox, 0, n - 1));
        ady += val * (g * wx);
        adx += val * (g * wxp);
      }
      s_dy += ady * wyp;
      s_dx += adx * wy;
    }
  } else {
    const int fy = static_cast<int>(floorf(dyc)) - 1;
    const int fx = static_cast<int>(floorf(dxc)) - 1;
    float wx[4], wxp[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ox = fx + t;
      const bool in_x = ox >= -k && ox <= k + 1;
      wx[t] = in_x ? hat(dxc - ox) : 0.f;
      wxp[t] = in_x ? hat_grad(dxc - ox) : 0.f;
    }
    for (int oy = fy; oy < fy + 4; ++oy) {
      const bool in_y = oy >= -k && oy <= k + 1;
      const float wy = in_y ? hat(dyc - oy) : 0.f;
      const float wyp = in_y ? hat_grad(dyc - oy) : 0.f;
      if (wy == 0.f && wyp == 0.f) continue;
      const float* row = f + clampi(i + oy, 0, m - 1) * n;
      float ady = 0.f, adx = 0.f;
#pragma unroll
      for (int tx = 0; tx < 4; ++tx) {
        if (wx[tx] == 0.f && wxp[tx] == 0.f) continue;
        const float val = __ldg(row + clampi(j + fx + tx, 0, n - 1));
        ady += val * (g * wx[tx]);
        adx += val * (g * wxp[tx]);
      }
      s_dy += ady * wyp;
      s_dx += adx * wy;
    }
  }
  g_dy = s_dy * clip_grad(dy, kf);
  g_dx = s_dx * clip_grad(dx, kf);
}

// The taps of one cell's window for the field cotangent: the offsets
// f = floor(dc) per axis, packed as (fy << 16) | (fx & 0xffff), and the hat
// weights at f and f + 1, computed as the plain version computes
// hat(dc - oy). `dense` keeps the clipped displacements instead (in w0).
struct Taps {
  int* off;
  float *wy0, *wy1, *wx0, *wx1;

  __device__ void store(int idx, float dy, float dx, int k, bool dense) const {
    const float kf = static_cast<float>(k);
    const float dyc = clip(dy, kf), dxc = clip(dx, kf);
    if (dense) {
      wy0[idx] = dyc;
      wx0[idx] = dxc;
      return;
    }
    const float fy = floorf(dyc), fx = floorf(dxc);
    off[idx] = (static_cast<int>(fy) << 16) | (static_cast<int>(fx) & 0xffff);
    wy0[idx] = hat(dyc - fy);
    wy1[idx] = hat(dyc - (fy + 1.f));
    wx0[idx] = hat(dxc - fx);
    wx1[idx] = hat(dxc - (fx + 1.f));
  }
};

// The field cotangent of _advect_window_T at source cell (r, c) of an
// m x n field: every window term (cell (i, j), offset (oy, ox)) whose
// clamped source clamp(i+oy), clamp(j+ox) is (r, c) contributes
// g * hat(dxc - ox) * hat(dyc - oy). g and the taps are per-cell shared
// arrays, complete before the call; `base` is the row the arrays start at.
// For an interior row the only source row is r - oy; the edge rows also
// collect the rows that the edge padding clamps onto them (the fold of
// _edge_pad2_T). A candidate is tested by an integer compare of its offset
// with the stored one and weighed by the stored weights; `dense` evaluates
// the hat at every offset from the clipped displacements.
__device__ float window_field_T(const float* g, const Taps& tp, int base,
                                int m, int n, int r, int c, int k, bool dense) {
  float acc = 0.f;
  for (int oy = -k; oy <= k + 1; ++oy) {
    const int ilo = max(r == 0 ? 0 : r - oy, 0);
    const int ihi = min(r == m - 1 ? m - 1 : r - oy, m - 1);
    for (int i = ilo; i <= ihi; ++i) {
      for (int ox = -k; ox <= k + 1; ++ox) {
        const int jlo = max(c == 0 ? 0 : c - ox, 0);
        const int jhi = min(c == n - 1 ? n - 1 : c - ox, n - 1);
        for (int j = jlo; j <= jhi; ++j) {
          const int idx = (i - base) * n + j;
          float wy, wx;
          if (dense) {
            wy = hat(tp.wy0[idx] - oy);
            wx = hat(tp.wx0[idx] - ox);
          } else {
            const int o = tp.off[idx];
            const int ey = oy - (o >> 16), ex = ox - static_cast<short>(o);
            if (static_cast<unsigned>(ey) > 1u || static_cast<unsigned>(ex) > 1u)
              continue;
            wy = ey ? tp.wy1[idx] : tp.wy0[idx];
            if (wy == 0.f) continue;
            wx = ex ? tp.wx1[idx] : tp.wx0[idx];
            if (wx == 0.f) continue;
          }
          acc += (g[idx] * wx) * wy;
        }
      }
    }
  }
  return acc;
}

// Adjoints of _to_y_faces / _to_x_faces at cell (i, j): a (H+1, W) or
// (H, W+1) face field g (shared, complete) back onto the (H, W) cells. The
// arrays start at face row `base`.
__device__ __forceinline__ float to_y_faces_T(const float* g, int base, int i,
                                              int j, int h, int w) {
  const float* row = g + (i - base) * w + j;
  float v = 0.5f * (row[0] + row[w]);
  if (i == 0) v += 0.5f * row[0];
  if (i == h - 1) v += 0.5f * row[w];
  return v;
}

__device__ __forceinline__ float to_x_faces_T(const float* g, int base, int i,
                                              int j, int w) {
  const float* row = g + (i - base) * (w + 1);
  float v = 0.5f * (row[j] + row[j + 1]);
  if (j == 0) v += 0.5f * row[0];
  if (j == w - 1) v += 0.5f * row[w];
  return v;
}

// v, which the compiler must treat as unknown: a value derived from it is
// computed anew rather than kept live from an earlier equal one. The banded
// K2 finds its cluster size and grid after the solve through it, so that
// no register holds them (or the band and the layout they give) across the
// solve: kept live, they made its inlined solve spill (36 bytes).
__device__ __forceinline__ int opaque(int v) {
  asm volatile("" : "+r"(v));
  return v;
}

__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

// Offsets (floats) into one rank's shared memory in K3, for H x W cells,
// cluster size C, kT threads and max_shift k, in the core's `layout`. A
// band has at most R = ceil(H / C) rows; the window adjoints read E = k + 1
// rows beyond it. The reduction area and the best iterate persist; in the
// small and large layouts the solve's buffers and, once the solve is done,
// the window phase's share the rest (the larger of the two sets the
// total). In the banded layout the window phase's arrays, which grow with
// W (R + 2E) and fit a block under no cluster size at 236^2, lie in the
// rank's own part of a scratch in global memory instead (the offsets
// gdiv .. tmp then count from its start; `window` floats a rank, after the
// solve's two whole fields: bwd_scratch_floats). ops/cuda_fluid.py ::
// bwd_shared_bytes and bwd_scratch_floats count the same.
struct BwdLayout {
  int red, best;  // persistent
  CgOffsets cg;   // the solve
  int gdiv, gvy2, gvx2, grho, off, wy0, wy1, wx0, wx1, gvyc, gvxc, tmp;
  int window;  // floats of the window phase
  int total;   // floats of shared memory
};

__host__ __device__ inline BwdLayout bwd_layout(int h, int w, int C, int T,
                                                int k, int layout) {
  BwdLayout l;
  const int R = (h + C - 1) / C, E = k + 1;
  int o = 0;
  auto take = [&o](int n) { const int at = o; o += align4(n); return at; };
  l.red = take(kRedFloats);
  l.best = take(R * w);
  const int shared = o;
  l.cg = take_cg(o, h, w, R, T, layout);
  const int solve_end = o;
  const bool banded = layout == kLayoutBanded;
  o = banded ? 0 : shared;
  const int window0 = o;
  l.gdiv = take(imin(R + 2 * E + 2, h) * w);
  l.gvy2 = take(imin(R + 2 * E + 1, h + 1) * w);
  l.gvx2 = take(imin(R + 2 * E, h) * (w + 1));
  l.grho = take(imin(R + 2 * E, h) * w);
  const int taps = imin(R + 2 * E + 1, h + 1) * (w + 1);
  l.off = take(taps);
  l.wy0 = take(taps);
  l.wy1 = take(taps);
  l.wx0 = take(taps);
  l.wx1 = take(taps);
  l.gvyc = take(imin(R + 1, h) * w);
  l.gvxc = take(imin(R + 1, h) * w);
  l.tmp = take(imin(R + 1, h + 1) * (w + 1));
  l.window = o - window0;
  l.total = banded ? solve_end : imax(o, solve_end);
  return l;
}

// Floats of K3's scratch a sample in the banded layout: the solve's two
// whole fields (r and the scaled spectrum), then each rank's window phase.
__host__ __device__ inline int bwd_scratch_floats(int h, int w, int C, int T,
                                                  int k) {
  return align4(2 * h * w) +
         C * bwd_layout(h, w, C, T, k, kLayoutBanded).window;
}

// Offsets (floats) into one rank's shared memory in K2, for H x W cells,
// cluster size C and T threads, in the core's `layout`: the reduction
// area, the solve's buffers (take_cg), then the
// step's fields on the band: vy3 on y-faces [a, b + 1), vx3 on rows
// [a, b), rho1 on rows [a - 1, b + 1) clipped to the grid, and the row of
// p above the band. A band has at most R = ceil(H / C) rows.
// ops/cuda_fluid.py :: fwd_shared_bytes counts the same.
struct FwdLayout {
  CgOffsets cg;
  int vy3, vx3, rho1, ph;
  int total;
};

__host__ __device__ inline FwdLayout fwd_layout(int h, int w, int C, int T,
                                                int layout) {
  FwdLayout l;
  const int R = (h + C - 1) / C;
  int o = align4(kRedFloats);
  l.cg = take_cg(o, h, w, R, T, layout);
  auto take = [&o](int n) { const int at = o; o += align4(n); return at; };
  l.vy3 = take((R + 1) * w);
  l.vx3 = take(R * (w + 1));
  l.rho1 = take(imin(R + 2, h) * w);
  l.ph = take(w);
  l.total = o;
  return l;
}

// The layout in which K2 / K3 run an H x W grid, by the rule K1 follows
// (pcg_cluster.cuh :: layout_where_fits), each on its own bytes: the two
// kernels cross over at different sides (K2 large from 109^2 and banded
// from 146^2, K3 from 112^2 and 152^2 at max_shift 2). ops/cuda_fluid.py ::
// fwd_layout and bwd_layout mirror these.
inline int fwd_grid_layout(int h, int w, int T) {
  return layout_where_fits(h, [=](int C, int layout) {
    return static_cast<size_t>(fwd_layout(h, w, C, T, layout).total) *
           sizeof(float);
  });
}

inline int bwd_grid_layout(int h, int w, int T, int k) {
  return layout_where_fits(h, [=](int C, int layout) {
    return static_cast<size_t>(bwd_layout(h, w, C, T, k, layout).total) *
           sizeof(float);
  });
}

// K2's warm solve on this rank's band, the divergence in its band of the
// residual: returns the trip count, leaves the best iterate's band in p
// (global, the sample's (H, W) field) and the reducer's parity in
// `parity`. kLayout large and banded: the basis (q_y, q_x, q_xt = Qx^T)
// read from global memory; banded: the two whole fields in `scratch` (2 H
// W floats a sample), as K1's banded kernel holds them.
template <int kT, int kLayout>
__device__ __forceinline__ int fwd_solve(const Geometry g, const float* q_y,
                                      const float* q_x, const float* q_xt,
                                      float* scratch, const float* x0,
                                      float* p, float tol, int maxiter,
                                      int& parity) {
  extern __shared__ __align__(16) float smem_fwd[];
  float* smem = smem_fwd;
  auto cluster = cgrp::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const Band bd(static_cast<int>(cluster.block_rank()), C, g.h, g.w);
  ClusterReducer<kT> red{reinterpret_cast<float4*>(smem),
                         reinterpret_cast<float4*>(smem + 8 * kMaxCluster),
                         parity};
  ClusterCg cg =
      cluster_cg(smem, fwd_layout(g.h, g.w, C, kT, kLayout).cg, g.h, g.w);
  if constexpr (kLayout != kLayoutSmall) {
    cg.gqy = q_y;
    cg.gqx = q_x;
    cg.gqxt = q_xt;
  }
  if constexpr (kLayout == kLayoutBanded) {
    cg.g1 = scratch + static_cast<size_t>(blockIdx.x / C) * 2 * g.h * g.w;
    cg.g2 = cg.g1 + g.h * g.w;
  }
  const int trips = pcg_cluster<kT, false, kLayout>(
      cg, g, bd, x0, p + bd.a * g.w, tol, maxiter, true, red);
  parity = red.parity;
  return trips;
}

// K2's pressure correction on this rank's band, after the solve left the
// best iterate's band in p_out: the rank pushes the last row of its p to
// the rank below, whose first y-face needs it, and after one cluster
// barrier corrects its own faces (_pgrad_closed: v4 = v3 - acc * grad p,
// zero on the walls). It finds its band again from the launch (the banded
// layout through `opaque`), so that nothing of the windows stays live
// across the solve: with those values kept live the kernel spilled.
template <int kT, int kLayout>
__device__ __forceinline__ void fwd_correct(const Geometry g, float dx,
                                         float* vy4, float* vx4,
                                         float* p_out) {
  extern __shared__ __align__(16) float smem_fwd[];
  float* smem = smem_fwd;
  auto cluster = cgrp::this_cluster();
  int C = static_cast<int>(cluster.num_blocks());
  int h = g.h, w = g.w;
  if constexpr (kLayout == kLayoutBanded) {
    C = opaque(C);
    h = opaque(h);
    w = opaque(w);
  }
  const int ny = (h + 1) * w, nx = h * (w + 1);
  const Band bd(static_cast<int>(cluster.block_rank()), C, h, w);
  const int a = bd.a, b1 = bd.b, R = bd.rows(), yb = bd.yb();
  const size_t b = blockIdx.x / C;
  const FwdLayout L = fwd_layout(h, w, C, kT, kLayout);
  const float* vy3 = smem + L.vy3;  // y-faces [a, b1 + 1)
  const float* vx3 = smem + L.vx3;  // rows [a, b1)
  const float* p = p_out + b * h * w;
  float* ph = smem + L.ph;  // the row of p above the band
  __syncthreads();  // the best iterate's band complete in p
  if (bd.rank < C - 1)
    for (int j = threadIdx.x; j < w; j += kT)
      cluster.map_shared_rank(ph, bd.rank + 1)[j] = p[(b1 - 1) * w + j];
  cluster.sync();
  for (int t = threadIdx.x; t < (yb - a) * w; t += kT) {
    const int idx = a * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    float gy = 0.f;
    if (i > 0 && i < h) gy = (p[idx] - (i == a ? ph[j] : p[idx - w])) / dx;
    vy4[b * ny + idx] = vy3[t] - gy * __ldg(g.acc_y + idx);
  }
  for (int t = threadIdx.x; t < R * (w + 1); t += kT) {
    const int idx = a * (w + 1) + t;
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    const float gx =
        (j > 0 && j < w) ? (p[i * w + j] - p[i * w + j - 1]) / dx : 0.f;
    vx4[b * nx + idx] = vx3[t] - gx * __ldg(g.acc_x + idx);
  }
}

// K2 for one sample on a cluster of C blocks (the launch's cluster size);
// rank c owns the rows of Band. The windows read only the step's inputs,
// so each rank computes what its band needs without exchange: rho1 on its
// rows and one more each side (buoyancy on y-face i reads rho1 at rows
// i - 1 and i), vy3 on y-faces [a, b + 1) (the divergence of row b - 1
// reads face b), vx3 on its rows; a row outside the band comes out as the
// same bits its owner computes. After the solve each rank pushes the last
// row of its p to the rank below, whose first y-face needs it, and after
// one cluster barrier corrects its own faces. Each rank writes its own rows
// of the outputs. The solve and the correction are inlined: with either as
// a function of its own, as K3's solve is, the kernel spilled. kLayout: the
// cluster core's layout (large: no basis in shared memory, q_xt, Qx^T, is
// read by it only; banded: no whole field in shared memory either, the
// solve's two in `scratch`, which the other layouts do not read).
template <int kT, int kLayout>
__global__ void __launch_bounds__(kT, 1)
fused_fwd_kernel(Step st, Geometry g, const float* __restrict__ q_y,
                 const float* __restrict__ q_x,
                 const float* __restrict__ q_xt, float* scratch,
                 const float* __restrict__ fy,
                 const float* __restrict__ fx,
                 const float* __restrict__ inflow,
                 const float* __restrict__ x0, float* vy4, float* vx4,
                 float* rho1_out, float* p_out, int* iters, float tol,
                 int maxiter) {
  extern __shared__ __align__(16) float smem_fwd[];
  float* smem = smem_fwd;
  auto cluster = cgrp::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int h = g.h, w = g.w, hw = h * w;
  const int ny = (h + 1) * w, nx = h * (w + 1);
  const Band bd(static_cast<int>(cluster.block_rank()), C, h, w);
  const int a = bd.a, b1 = bd.b, R = bd.rows(), yb = bd.yb();
  const size_t b = blockIdx.x / C;
  st.vy += b * ny;
  st.vx += b * nx;
  st.rho += b * hw;
  const FwdLayout L = fwd_layout(h, w, C, kT, kLayout);
  if constexpr (kLayout == kLayoutSmall)
    load_basis_t<kT>(cluster_cg(smem, L.cg, h, w), q_y, q_x, h, w);
  ClusterReducer<kT> red{reinterpret_cast<float4*>(smem),
                         reinterpret_cast<float4*>(smem + 8 * kMaxCluster)};
  // A non-finite input anywhere in the sample makes every window sum all
  // its taps: one vote over the cluster.
  bool bad = false;
  for (int t = threadIdx.x; t < (yb - a) * w; t += kT)
    bad |= !isfinite(__ldg(st.vy + a * w + t));
  for (int t = threadIdx.x; t < R * (w + 1); t += kT)
    bad |= !isfinite(__ldg(st.vx + a * (w + 1) + t));
  for (int t = threadIdx.x; t < R * w; t += kT)
    bad |= !isfinite(__ldg(st.rho + a * w + t));
  const bool dense = red.sum(bd, bad ? 1.f : 0.f) > 0.f;

  // Phase A (_phase_a): density advected by the centred velocity, on cell
  // rows [r0, r1).
  float* rho1 = smem + L.rho1;
  const int r0 = imax(a - 1, 0), r1 = imin(b1 + 1, h);
  for (int t = threadIdx.x; t < (r1 - r0) * w; t += kT) {
    const int idx = r0 * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx;
    st.disp_rho(i, j, dy, dx);
    float v = window(st.rho, h, w, i, j, dy, dx, st.k, dense);
    if (inflow != nullptr) v += st.dt * __ldg(inflow + b * hw + idx);
    rho1[t] = v;
    if (i >= a && i < b1) rho1_out[b * hw + idx] = v;
  }
  __syncthreads();
  // Self-advection of each velocity component, force, buoyancy, masks.
  float* vy3 = smem + L.vy3;  // y-faces [a, b1 + 1)
  for (int t = threadIdx.x; t < (R + 1) * w; t += kT) {
    const int idx = a * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx;
    st.disp_vy(i, j, dy, dx);
    float v = window(st.vy, h + 1, w, i, j, dy, dx, st.k, dense);
    if (fy != nullptr) v += st.dt * __ldg(fy + b * ny + idx);
    if (st.buoy)
      v += st.dt_buoy * (0.5f * (rho1[(imax(i - 1, 0) - r0) * w + j] +
                                 rho1[(imin(i, h - 1) - r0) * w + j]));
    vy3[t] = v * __ldg(g.acc_y + idx);
  }
  float* vx3 = smem + L.vx3;  // rows [a, b1)
  for (int t = threadIdx.x; t < R * (w + 1); t += kT) {
    const int idx = a * (w + 1) + t;
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    float dy, dx;
    st.disp_vx(i, j, dy, dx);
    float v = window(st.vx, h, w + 1, i, j, dy, dx, st.k, dense);
    if (fx != nullptr) v += st.dt * __ldg(fx + b * nx + idx);
    vx3[t] = v * __ldg(g.acc_x + idx);
  }
  __syncthreads();
  // The divergence is the solve's `div`, in the band of its residual
  // (r_band); the solve reads each entry in the thread that wrote it.
  float* div =
      kLayout == kLayoutBanded ? smem + L.cg.rb : smem + L.cg.g1 + a * w;
  for (int t = threadIdx.x; t < R * w; t += kT) {
    const float* row = vx3 + (t / w) * (w + 1) + (t - (t / w) * w);
    div[t] = ((vy3[t + w] - vy3[t]) + (row[1] - row[0])) / st.dx;
  }
  int parity = red.parity;
  const int trips = fwd_solve<kT, kLayout>(
      g, q_y, q_x, q_xt, scratch, x0 == nullptr ? nullptr : x0 + b * hw,
      p_out + b * hw, tol, maxiter, parity);
  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    if constexpr (kLayout == kLayoutBanded)
      iters[blockIdx.x / opaque(static_cast<int>(cluster.num_blocks()))] =
          trips;
    else
      iters[blockIdx.x / C] = trips;
  }
  fwd_correct<kT, kLayout>(g, st.dx, vy4, vx4, p_out);
}

// K3's rhs and transpose solve on this rank's band: returns the trip count
// and leaves the best iterate's band at bwd_layout's `best`, the reducer's
// parity in `parity`. A function of its own (not inlined), so that the
// registers of the solve and of the window phase are allocated apart.
// kLayout large and banded: the basis (q_y, q_x, q_xt = Qx^T) read from
// global memory; banded: the two whole fields at the start of the sample's
// `scratch` (bwd_scratch_floats a sample).
template <int kT, bool kTrace, int kLayout>
__device__ __noinline__ int bwd_solve(const Geometry g, const float* q_y,
                                      const float* q_x, const float* q_xt,
                                      float* scratch, const float* g_vy4,
                                      const float* g_vx4, const float* g_p,
                                      float dx, int k, float tol, int maxiter,
                                      int& parity) {
  extern __shared__ __align__(16) float smem_bwd[];
  float* smem = smem_bwd;
  auto cluster = cgrp::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int h = g.h, w = g.w;
  const Band bd(static_cast<int>(cluster.block_rank()), C, h, w);
  const size_t b = blockIdx.x / C;
  g_vy4 += b * (h + 1) * w;
  g_vx4 += b * h * (w + 1);
  g_p += b * h * w;
  ClusterReducer<kT> red{reinterpret_cast<float4*>(smem),
                         reinterpret_cast<float4*>(smem + 8 * kMaxCluster)};
  const BwdLayout L = bwd_layout(h, w, C, kT, k, kLayout);
  ClusterCg cgb = cluster_cg(smem, L.cg, h, w);
  if constexpr (kLayout != kLayoutSmall) {
    cgb.gqy = q_y;
    cgb.gqx = q_x;
    cgb.gqxt = q_xt;
  } else {
    load_basis_t<kT>(cgb, q_y, q_x, h, w);
  }
  if constexpr (kLayout == kLayoutBanded) {
    cgb.g1 = scratch + b * bwd_scratch_floats(h, w, C, kT, k);
    cgb.g2 = cgb.g1 + h * w;
  }
  // Projection backward: cot_p = g_p + div(acc * g_v4); the transpose solve
  // runs cold on -cot_p, so its `div` (in r's band) is -cot_p.
  float* rhs = r_band<kLayout>(cgb, bd, w);
  for (int t = threadIdx.x; t < bd.rows() * w; t += kT) {
    const int idx = bd.a * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    const int fx_ = i * (w + 1) + j;
    const float dvy = g_vy4[idx + w] * __ldg(g.acc_y + idx + w) -
                      g_vy4[idx] * __ldg(g.acc_y + idx);
    const float dvx = g_vx4[fx_ + 1] * __ldg(g.acc_x + fx_ + 1) -
                      g_vx4[fx_] * __ldg(g.acc_x + fx_);
    rhs[t] = -(g_p[idx] + (dvy + dvx) / dx);
  }
  const int trips = pcg_cluster<kT, kTrace, kLayout>(
      cgb, g, bd, nullptr, smem + L.best, tol, maxiter, true, red);
  parity = red.parity;
  return trips;
}

// K3 for one sample on a cluster of C blocks (the launch's cluster size);
// rank c owns the rows of Band. After the solve (pcg_cluster.cuh) each rank
// pulls the rows of g_div around its band that the window adjoints reach
// (E + 1 = k + 2 rows each side, from whichever ranks own them) and then
// computes the face cotangents, the density cotangent and each window's
// taps on its band widened by E rows, and the displacement cotangents on
// its band and one more row, without further exchange: a row outside the
// band comes out as the same bits its owner computes. Each rank writes its
// own rows of the outputs. kTrace: with the CG trip's profile
// (pcg_cluster.cuh :: TripClock), for fused_bwd_trace only. kLayout: the
// cluster core's layout for the solve (large: q_xt, Qx^T, is read by it
// only; banded: its two whole fields in `scratch`, which the other layouts
// do not read). The window phase is the same in all three, on arrays in
// shared memory, or in the banded layout in the rank's part of `scratch`
// (bwd_layout): written and read by the rank's own threads around its
// block barriers, through L1, but g_div's rows of the other ranks, which
// the cluster barrier publishes (release/acquire at cluster scope orders
// global memory too) and which are read through L2 (__ldcg: L1 is not
// coherent across the cluster's SMs) where the other layouts read them
// from the owner's shared memory.
template <int kT, bool kTrace, int kLayout>
__global__ void __launch_bounds__(kT, 1)
fused_bwd_kernel(Step st, Geometry g, const float* __restrict__ q_y,
                 const float* __restrict__ q_x,
                 const float* __restrict__ q_xt, float* scratch,
                 const float* __restrict__ g_vy4,
                 const float* __restrict__ g_vx4,
                 const float* __restrict__ g_rho1,
                 const float* __restrict__ g_p, float* g_vy, float* g_vx,
                 float* g_rho, float* g_fy, float* g_fx, float* g_inflow,
                 int* iters, float tol, int maxiter) {
  extern __shared__ __align__(16) float smem_bwd[];
  float* smem = smem_bwd;
  int parity = 0;
  const int trips = bwd_solve<kT, kTrace, kLayout>(
      g, q_y, q_x, q_xt, scratch, g_vy4, g_vx4, g_p, st.dx, st.k, tol, maxiter,
      parity);
  auto cluster = cgrp::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int h = g.h, w = g.w, hw = h * w;
  const int ny = (h + 1) * w, nx = h * (w + 1);
  const Band bd(static_cast<int>(cluster.block_rank()), C, h, w);
  const int a = bd.a, b1 = bd.b, R = bd.rows(), yb = bd.yb();
  const int k = st.k, E = k + 1;
  const size_t b = blockIdx.x / C;
  st.vy += b * ny;
  st.vx += b * nx;
  st.rho += b * hw;
  g_vy4 += b * ny;
  g_vx4 += b * nx;
  g_rho1 += b * hw;
  g_vy += b * ny;
  g_vx += b * nx;
  g_rho += b * hw;
  ClusterReducer<kT> red{reinterpret_cast<float4*>(smem),
                         reinterpret_cast<float4*>(smem + 8 * kMaxCluster),
                         parity};
  const BwdLayout L = bwd_layout(h, w, C, kT, k, kLayout);
  const float* best = smem + L.best;
  // Where the window phase's arrays lie (bwd_layout).
  float* win = smem;
  if constexpr (kLayout == kLayoutBanded)
    win = scratch + b * bwd_scratch_floats(h, w, C, kT, k) + align4(2 * hw) +
          bd.rank * L.window;
  // A non-finite input or window cotangent anywhere in the sample makes
  // every window sum all its taps (one vote over the cluster, below).
  bool bad = false;
  for (int t = threadIdx.x; t < (yb - a) * w; t += kT)
    bad |= !isfinite(__ldg(st.vy + a * w + t));
  for (int t = threadIdx.x; t < R * (w + 1); t += kT)
    bad |= !isfinite(__ldg(st.vx + a * (w + 1) + t));
  for (int t = threadIdx.x; t < R * w; t += kT)
    bad |= !isfinite(__ldg(st.rho + a * w + t));
  // The closed domain's mean projection of the solution, then
  // g_div = -M(P(xt)) on the band. No rank pushes into the solve's buffers
  // after the loop's last barrier, so the window phase may take them (the
  // small and large layouts).
  float mean = 0.f;
  if (g.closed) {
    float part_x = 0.f, part_f = 0.f;
    for (int t = threadIdx.x; t < R * w; t += kT) {
      const float f = __ldg(g.fluid + a * w + t);
      part_x += best[t] * f;
      part_f += f;
    }
    float sum_x, sum_f;
    red.sum2(bd, part_x, part_f, sum_x, sum_f);
    mean = sum_x / fmaxf(sum_f, 1.f);
  }
  float* gdiv = win + L.gdiv;  // cell rows [gd0, gd1)
  const int gd0 = imax(a - E - 1, 0), gd1 = imin(b1 + E + 1, h);
  for (int t = threadIdx.x; t < R * w; t += kT) {
    const bool fluid = __ldg(g.fluid + a * w + t) > 0.f;
    const float v = g.closed && fluid ? best[t] - mean : best[t];
    gdiv[(a - gd0) * w + t] = fluid ? -v : 0.f;
  }
  cluster.sync();  // every rank's g_div rows
  {
    const int above = a - gd0, rows = above + (gd1 - b1);
    for (int t = threadIdx.x; t < rows * w; t += kT) {
      const int rr = t / w, j = t - (t / w) * w;
      const int i = rr < above ? gd0 + rr : b1 + (rr - above);
      const int o = bd.owner(i);
      const int o0 = imax(bd.row0(o) - E - 1, 0);
      float v;
      if constexpr (kLayout == kLayoutBanded)
        v = __ldcg(gdiv + (o - bd.rank) * L.window + (i - o0) * w + j);
      else
        v = cluster.map_shared_rank(gdiv, o)[(i - o0) * w + j];
      gdiv[(i - gd0) * w + j] = v;
    }
  }
  __syncthreads();
  // _divergence_T, the masks and the force cotangents: y-faces [Y0, Y1),
  // x-faces [X0, X1); the outputs on the band's rows.
  const int Y0 = imax(a - E, 0), Y1 = imin(b1 + E + 1, h + 1);
  const int X0 = imax(a - E, 0), X1 = imin(b1 + E, h);
  float* gvy2 = win + L.gvy2;  // cotangent of the forced, unmasked velocity
  float* gvx2 = win + L.gvx2;
  for (int t = threadIdx.x; t < (Y1 - Y0) * w; t += kT) {
    const int idx = Y0 * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    const float lo = i > 0 ? gdiv[(i - 1 - gd0) * w + j] : 0.f;
    const float hi = i < h ? gdiv[(i - gd0) * w + j] : 0.f;
    const float v = (g_vy4[idx] + (lo - hi) / st.dx) * __ldg(g.acc_y + idx);
    gvy2[t] = v;
    if (i >= a && i < yb) {
      bad |= !isfinite(v);
      if (g_fy != nullptr) g_fy[b * ny + idx] = st.dt * v;
    }
  }
  for (int t = threadIdx.x; t < (X1 - X0) * (w + 1); t += kT) {
    const int idx = X0 * (w + 1) + t;
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    const float lo = j > 0 ? gdiv[(i - gd0) * w + j - 1] : 0.f;
    const float hi = j < w ? gdiv[(i - gd0) * w + j] : 0.f;
    const float v = (g_vx4[idx] + (lo - hi) / st.dx) * __ldg(g.acc_x + idx);
    gvx2[t] = v;
    if (i >= a && i < b1) {
      bad |= !isfinite(v);
      if (g_fx != nullptr) g_fx[b * nx + idx] = st.dt * v;
    }
  }
  __syncthreads();
  // Buoyancy backward onto the advected density, and the inflow cotangent:
  // cell rows [X0, X1).
  float* grho = win + L.grho;  // total cotangent of the advected density
  for (int t = threadIdx.x; t < (X1 - X0) * w; t += kT) {
    const int idx = X0 * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    float v = g_rho1[idx];
    if (st.buoy) v += st.dt_buoy * to_y_faces_T(gvy2, Y0, i, j, h, w);
    grho[t] = v;
    if (i >= a && i < b1) {
      bad |= !isfinite(v);
      if (g_inflow != nullptr) g_inflow[b * hw + idx] = st.dt * v;
    }
  }
  const bool dense = red.sum(bd, bad ? 1.f : 0.f) > 0.f;

  const Taps taps{reinterpret_cast<int*>(win + L.off), win + L.wy0,
                  win + L.wy1, win + L.wx0, win + L.wx1};
  const int C0 = imax(a - 1, 0);  // the centred cotangents' first row
  float* gvyc = win + L.gvyc;     // cotangents of the centred velocity
  float* gvxc = win + L.gvxc;
  float* tmp = win + L.tmp;  // s * the cross-component displacement cotangent
  // Density window: taps on [X0, X1); displacement cotangents on [C0, b1),
  // which start the centred-velocity cotangents; the field cotangent.
  for (int t = threadIdx.x; t < (X1 - X0) * w; t += kT) {
    const int idx = X0 * w + t;
    float dy, dx;
    st.disp_rho(idx / w, idx - (idx / w) * w, dy, dx);
    taps.store(t, dy, dx, k, dense);
  }
  for (int t = threadIdx.x; t < (b1 - C0) * w; t += kT) {
    const int idx = C0 * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx, gdy, gdx;
    st.disp_rho(i, j, dy, dx);
    window_disp_T(st.rho, h, w, i, j, grho[(i - X0) * w + j], dy, dx, k, dense,
                  gdy, gdx);
    gvyc[t] = st.s * gdy;
    gvxc[t] = st.s * gdx;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * w; t += kT) {
    const int idx = a * w + t;
    g_rho[idx] = window_field_T(grho, taps, X0, h, w, idx / w,
                                idx - (idx / w) * w, k, dense);
  }
  __syncthreads();
  // vy self-advection, vy1 = W(vy; s vy, s Y(vx_c)): taps on [Y0, VY1),
  // displacement cotangents on [a, b1 + 1).
  const int VY1 = imin(yb + E, h + 1);
  for (int t = threadIdx.x; t < (VY1 - Y0) * w; t += kT) {
    const int idx = Y0 * w + t;
    float dy, dx;
    st.disp_vy(idx / w, idx - (idx / w) * w, dy, dx);
    taps.store(t, dy, dx, k, dense);
  }
  for (int t = threadIdx.x; t < (b1 + 1 - a) * w; t += kT) {
    const int idx = a * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx, gdy, gdx;
    st.disp_vy(i, j, dy, dx);
    window_disp_T(st.vy, h + 1, w, i, j, gvy2[(i - Y0) * w + j], dy, dx, k,
                  dense, gdy, gdx);
    if (i < yb) g_vy[idx] = st.s * gdy;
    tmp[t] = st.s * gdx;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < R * w; t += kT) {
    const int idx = a * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    gvxc[(i - C0) * w + j] += to_y_faces_T(tmp, a, i, j, h, w);
  }
  for (int t = threadIdx.x; t < (yb - a) * w; t += kT) {
    const int idx = a * w + t;
    g_vy[idx] = window_field_T(gvy2, taps, Y0, h + 1, w, idx / w,
                               idx - (idx / w) * w, k, dense) + g_vy[idx];
  }
  __syncthreads();
  // vx self-advection, vx1 = W(vx; s X(vy_c), s vx): taps on [X0, X1),
  // displacement cotangents on [C0, b1).
  for (int t = threadIdx.x; t < (X1 - X0) * (w + 1); t += kT) {
    const int idx = X0 * (w + 1) + t;
    float dy, dx;
    st.disp_vx(idx / (w + 1), idx - (idx / (w + 1)) * (w + 1), dy, dx);
    taps.store(t, dy, dx, k, dense);
  }
  for (int t = threadIdx.x; t < (b1 - C0) * (w + 1); t += kT) {
    const int idx = C0 * (w + 1) + t;
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    float dy, dx, gdy, gdx;
    st.disp_vx(i, j, dy, dx);
    window_disp_T(st.vx, h, w + 1, i, j, gvx2[(i - X0) * (w + 1) + j], dy, dx,
                  k, dense, gdy, gdx);
    if (i >= a) g_vx[idx] = st.s * gdx;
    tmp[t] = st.s * gdy;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < (b1 - C0) * w; t += kT) {
    const int idx = C0 * w + t;
    gvyc[t] += to_x_faces_T(tmp, C0, idx / w, idx - (idx / w) * w, w);
  }
  for (int t = threadIdx.x; t < R * (w + 1); t += kT) {
    const int idx = a * (w + 1) + t;
    g_vx[idx] = window_field_T(gvx2, taps, X0, h, w + 1, idx / (w + 1),
                               idx - (idx / (w + 1)) * (w + 1), k, dense) +
                g_vx[idx];
  }
  __syncthreads();
  // Centres backward (_centers_y_T, _centers_x_T).
  for (int t = threadIdx.x; t < (yb - a) * w; t += kT) {
    const int idx = a * w + t;
    const int i = idx / w, j = idx - (idx / w) * w;
    g_vy[idx] += 0.5f * ((i > 0 ? gvyc[(i - 1 - C0) * w + j] : 0.f) +
                         (i < h ? gvyc[(i - C0) * w + j] : 0.f));
  }
  for (int t = threadIdx.x; t < R * (w + 1); t += kT) {
    const int idx = a * (w + 1) + t;
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    const float* row = gvxc + (i - C0) * w;
    g_vx[idx] += 0.5f * ((j > 0 ? row[j - 1] : 0.f) + (j < w ? row[j] : 0.f));
  }
  if (bd.rank == 0 && threadIdx.x == 0) iters[b] = trips;
  cluster.sync();  // no rank leaves while a peer may still read its rows
}

Step make_step(const float* vy, const float* vx, const float* rho, int h,
               int w, float dx, float s, float dt, float dt_buoy, int buoy,
               int k) {
  return Step{vy, vx, rho, h, w, s, dt, dx, dt_buoy, buoy != 0, k};
}

// Whether K3 launches run the instantiation with the CG trip's profile
// (fused_bwd_trace).
bool bwd_traced = false;

using BwdKernel = void (*)(Step, Geometry, const float*, const float*,
                           const float*, float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           float*, float*, float*, int*, float, int);

// K3's kernel at H x W: 512 threads a block, the grid's layout; with the
// trip's profile on, its instantiation with clock marks, which exists for
// the small layout only (null on a large or banded grid: the launch is
// refused).
BwdKernel bwd_kernel(int h, int w, int threads, int k) {
  switch (bwd_grid_layout(h, w, threads, k)) {
    case kLayoutSmall:
      return bwd_traced
                 ? fused_bwd_kernel<kClusterThreads, true, kLayoutSmall>
                 : fused_bwd_kernel<kClusterThreads, false, kLayoutSmall>;
    case kLayoutLarge:
      return bwd_traced
                 ? nullptr
                 : fused_bwd_kernel<kClusterThreads, false, kLayoutLarge>;
    default:
      return bwd_traced
                 ? nullptr
                 : fused_bwd_kernel<kClusterThreads, false, kLayoutBanded>;
  }
}

using FwdKernel = void (*)(Step, Geometry, const float*, const float*,
                           const float*, float*, const float*, const float*,
                           const float*, const float*, float*, float*, float*,
                           float*, int*, float, int);

// K2's kernel at H x W: 512 threads a block, the grid's layout.
FwdKernel fwd_kernel(int h, int w, int threads) {
  switch (fwd_grid_layout(h, w, threads)) {
    case kLayoutSmall:
      return fused_fwd_kernel<kClusterThreads, kLayoutSmall>;
    case kLayoutLarge:
      return fused_fwd_kernel<kClusterThreads, kLayoutLarge>;
    default:
      return fused_fwd_kernel<kClusterThreads, kLayoutBanded>;
  }
}

size_t fwd_bytes(int h, int w, int cluster, int threads) {
  return static_cast<size_t>(fwd_layout(h, w, cluster, threads,
                                        fwd_grid_layout(h, w, threads))
                                 .total) *
         sizeof(float);
}

size_t bwd_bytes(int h, int w, int cluster, int threads, int k) {
  return static_cast<size_t>(bwd_layout(h, w, cluster, threads, k,
                                        bwd_grid_layout(h, w, threads, k))
                                 .total) *
         sizeof(float);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one rank of K2 needs (fwd_layout, in the
// grid's layout). ops/cuda_fluid.py :: fwd_shared_bytes mirrors this count.
size_t fused_fwd_shared_bytes(int h, int w, int cluster, int threads) {
  return fwd_bytes(h, w, cluster, threads);
}

// The layout in which K2 runs an H x W grid: 0 small, 1 large, 2 banded
// (fwd_grid_layout; ops/cuda_fluid.py :: fwd_layout mirrors this).
int fused_fwd_layout(int h, int w, int threads) {
  return fwd_grid_layout(h, w, threads);
}

// How many clusters of K2 under this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of the query
// or of a plan the launcher would refuse.
int fused_fwd_max_clusters(int h, int w, int cluster, int threads) {
  return max_active_clusters(fwd_kernel(h, w, threads), h, cluster, threads,
                             fwd_bytes(h, w, cluster, threads));
}

// K2 for `batch` samples on `stream`, one cluster of `cluster` blocks of
// `threads` threads per sample. fy/fx, inflow and x0 may be null (no
// force, no inflow, cold solve). q_y, q_x and q_xt are Qy, Qx and Qx^T,
// unpadded (q_xt is read only on a grid of the large or banded layout).
// `scratch` holds batch x 2 x H x W floats for the banded layout
// (fused_fwd_layout 2; it may be null in the others). Returns the
// cudaError_t of the launch: cudaErrorInvalidValue, with nothing launched,
// for a plan the kernel cannot run (a cluster size other than 1, 2, 4, 8,
// 16 or above H, a thread count other than 512, or more shared memory than
// a block may have) or a banded grid without a scratch.
int fused_step_fwd_f32(const float* vy, const float* vx, const float* rho,
                       const float* fy, const float* fx, const float* inflow,
                       const float* x0, const float* acc_y, const float* acc_x,
                       const float* fluid, const float* q_y, const float* q_x,
                       const float* q_xt, const float* inv_lam, float* scratch,
                       float* vy4, float* vx4, float* rho1, float* p,
                       int* iters, int batch, int h, int w, float dx, float s,
                       float dt, float dt_buoy, int buoy, int k, int closed,
                       float tol, int maxiter, int cluster, int threads,
                       void* stream) {
  if (k < 0 ||
      (scratch == nullptr && fwd_grid_layout(h, w, threads) == kLayoutBanded))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const FwdKernel kernel = fwd_kernel(h, w, threads);
  cudaError_t err = cluster_config(kernel, batch, h, cluster, threads,
                                   fwd_bytes(h, w, cluster, threads), stream,
                                   cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{acc_y, acc_x, fluid, inv_lam, h, w, 1.f / (dx * dx), closed != 0};
  err = cudaLaunchKernelEx(
      &cfg, kernel, make_step(vy, vx, rho, h, w, dx, s, dt, dt_buoy, buoy, k),
      g, q_y, q_x, q_xt, scratch, fy, fx, inflow, x0, vy4, vx4, rho1, p, iters,
      tol, maxiter);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// Turns the profile of K3's CG trip on (clocks: kTripPhases counters in
// device memory, which the next launches add their cycles to; they run the
// kernel instantiated with the profile, on grids of the small layout only:
// a grid of the large or banded layout refuses the launch)
// or off (null: the main path's kernel again); see pcg_cluster.cuh ::
// TripClock. Returns the cudaError_t.
int fused_bwd_trace(unsigned long long* clocks) {
  bwd_traced = clocks != nullptr;
  return static_cast<int>(
      cudaMemcpyToSymbol(trip_clocks, &clocks, sizeof(clocks)));
}

// Bytes of dynamic shared memory one rank of K3 needs (bwd_layout, in the
// grid's layout). ops/cuda_fluid.py :: bwd_shared_bytes mirrors this count.
size_t fused_bwd_shared_bytes(int h, int w, int cluster, int threads, int k) {
  return bwd_bytes(h, w, cluster, threads, k);
}

// The layout in which K3 runs an H x W grid at max_shift k: 0 small, 1
// large, 2 banded (bwd_grid_layout; ops/cuda_fluid.py :: bwd_layout
// mirrors this).
int fused_bwd_layout(int h, int w, int threads, int k) {
  return bwd_grid_layout(h, w, threads, k);
}

// Floats of K3's scratch a sample in the banded layout under a plan
// (bwd_scratch_floats; ops/cuda_fluid.py :: bwd_scratch_floats mirrors
// this).
size_t fused_bwd_scratch_floats(int h, int w, int cluster, int threads,
                                int k) {
  return static_cast<size_t>(bwd_scratch_floats(h, w, cluster, threads, k));
}

// How many clusters of K3 under this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of the query
// or of a plan the launcher would refuse.
int fused_bwd_max_clusters(int h, int w, int cluster, int threads, int k) {
  if (k < 0) return -static_cast<int>(cudaErrorInvalidValue);
  const BwdKernel kernel = bwd_kernel(h, w, threads, k);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return max_active_clusters(kernel, h, cluster, threads,
                             bwd_bytes(h, w, cluster, threads, k));
}

// K3 for `batch` samples on `stream`, one cluster of `cluster` blocks of
// `threads` threads per sample. g_fy/g_fx and g_inflow may be null (not
// wanted). q_y, q_x and q_xt are Qy, Qx and Qx^T, unpadded (q_xt is read
// only on a grid of the large or banded layout). `scratch` holds batch x
// fused_bwd_scratch_floats floats for the banded layout (fused_bwd_layout
// 2; it may be null in the others). Returns the cudaError_t of the
// launch: cudaErrorInvalidValue, with nothing launched, for a plan the
// kernel cannot run (a cluster size other than 1, 2, 4, 8, 16 or above H,
// a thread count other than 512, more shared memory than a block may have,
// the trip's profile on a grid of the large or banded layout, or a banded
// grid without a scratch).
int fused_step_bwd_f32(const float* vy, const float* vx, const float* rho,
                       const float* g_vy4, const float* g_vx4,
                       const float* g_rho1, const float* g_p,
                       const float* acc_y, const float* acc_x,
                       const float* fluid, const float* q_y, const float* q_x,
                       const float* q_xt, const float* inv_lam, float* scratch,
                       float* g_vy, float* g_vx, float* g_rho, float* g_fy,
                       float* g_fx, float* g_inflow, int* iters, int batch,
                       int h, int w, float dx, float s, float dt,
                       float dt_buoy, int buoy, int k, int closed, float tol,
                       int maxiter, int cluster, int threads, void* stream) {
  if (k < 0 || (scratch == nullptr &&
                bwd_grid_layout(h, w, threads, k) == kLayoutBanded))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const BwdKernel kernel = bwd_kernel(h, w, threads, k);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cluster_config(kernel, batch, h, cluster, threads,
                                   bwd_bytes(h, w, cluster, threads, k),
                                   stream, cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{acc_y, acc_x, fluid, inv_lam, h, w, 1.f / (dx * dx), closed != 0};
  err = cudaLaunchKernelEx(
      &cfg, kernel, make_step(vy, vx, rho, h, w, dx, s, dt, dt_buoy, buoy, k),
      g, q_y, q_x, q_xt, scratch, g_vy4, g_vx4, g_rho1, g_p, g_vy, g_vx, g_rho,
      g_fy, g_fx, g_inflow, iters, tol, maxiter);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
