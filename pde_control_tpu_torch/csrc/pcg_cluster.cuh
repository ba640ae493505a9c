// The masked, spectrally preconditioned CG loop of pcg_core.cuh, for one
// system split over the C blocks (CTAs) of a thread-block cluster. K3
// (fused_step.cu) runs its transpose solve on it; K1 and K2 still run
// pcg_core.cuh, one block per system.
//
// It computes what pcg_core computes for a cold start (see that header):
// the same operator, preconditioner, projection, per-system exit and best
// iterate. The work is split by rows:
//
//   Bands. Rank c owns cell rows [c*H/C, (c+1)*H/C) of every field; every
//   rank owns at least one row (C <= H). Elementwise passes, the stencil
//   and the products along rows (. Qx^T, . Qx) touch the band only.
//
//   Exchanges are pushes. A rank writes what its peers need into their
//   shared memory through distributed shared memory (map_shared_rank) and
//   a cluster barrier (release/acquire) publishes it: its band of A d into
//   every rank's whole-field copy ga, from which every rank updates the
//   whole residual r the same way (so r is whole on every rank for the
//   product Qy r); its band of the scaled spectrum into g2, for the product
//   Qy^T .; the first and last row of the preconditioned residual z into
//   the neighbours' halo rows zh; its partial sums into every rank's
//   reduction slots. The solve reads nothing remotely, so a rank may reuse
//   its memory as soon as its own pushes are published.
//
//   Reductions. A block reduces its band to one partial (warp shuffles,
//   then the warps' sums in order), pushes it into slot [rank] of every
//   rank, and after one cluster barrier every thread of every rank adds
//   the C partials in rank order. So all ranks hold the same bits of every
//   scalar and the loop's exit is uniform: a rank that left the loop alone
//   would deadlock the next barrier. Two alternating slot sets make one
//   barrier per reduction enough.
//
//   The search direction's halo. d = z + beta d is formed with __fmaf_rn
//   by the owner of a row and by the neighbour that keeps it as a halo row,
//   from the same operands (the projection of z applied to both alike), so
//   both hold the same bits and the stencil needs no barrier of its own.
//
// A trip has three cluster barriers: d.Ad with the push of A d, the push of
// the scaled spectrum, and r.z, r.r with the sums the projection of z
// needs (r.z' = r.z - mu fluid.r, mu the fluid mean of z). Around them sit
// the block barriers of the four band products and the elementwise passes.
// The products are fp32 on the CUDA cores (no TF32): each CTA holds the
// whole basis and computes its band's rows, with K split over the threads
// when the band is short and the slices added in order.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "pcg_core.cuh"

namespace {

namespace cgrp = cooperative_groups;

constexpr int kMaxCluster = 16;
// Floats of the reduction area at the start of a block's shared memory:
// two slot sets of kMaxCluster float4 and a float4 per warp (16 warps).
constexpr int kRedFloats = 2 * 4 * kMaxCluster + 4 * 16;

__host__ __device__ inline int align4(int n) { return (n + 3) & ~3; }

// This rank's rows. Every field is split by the cell rows: y-faces, which
// have H + 1 rows, give the last rank their row H as well.
struct Band {
  int rank, C, h, w;
  int a, b;  // cell rows [a, b)
  __device__ Band(int rank_, int C_, int h_, int w_)
      : rank(rank_), C(C_), h(h_), w(w_), a(row0(rank_)), b(row0(rank_ + 1)) {}
  __device__ int row0(int c) const { return c * h / C; }
  __device__ int owner(int r) const { return min(((r + 1) * C - 1) / h, C - 1); }
  __device__ int rows() const { return b - a; }
  __device__ int yb() const { return rank == C - 1 ? h + 1 : b; }  // y-faces [a, yb)
};

// A profile of the CG trip, compiled only into the kernel instantiated with
// kOn (fused_step.cu :: fused_bwd_trace selects it; the main path's kernel
// has no marks). Thread 0 of the launch's first block adds the SM clock
// cycles of each phase of every trip to trip_clocks[phase]. Phases: 0 A d
// and the d.Ad sum with A d's push; 1 the residual's update; 2-3 the
// products Qy r and (.) Qx^T; 4 the scaled spectrum's push; 5-6 the
// products Qy^T (.) and (.) Qx; 7 the r.z, r.r sum with the projection and
// the update of d.
constexpr int kTripPhases = 8;
__device__ unsigned long long* trip_clocks = nullptr;
__shared__ long long trip_acc[kTripPhases + 1];  // the phases, the last clock

template <bool kOn>
struct TripClock {
  bool on = false;  // the recording thread
  __device__ static TripClock here() {
    TripClock c;
    if constexpr (kOn)
      c.on = blockIdx.x == 0 && threadIdx.x == 0 && trip_clocks != nullptr;
    return c;
  }
  __device__ void start() const {
    if constexpr (kOn) {
      if (!on) return;
      for (int p = 0; p < kTripPhases; ++p) trip_acc[p] = 0;
      trip_acc[kTripPhases] = clock64();
    }
  }
  __device__ void mark(int phase) const {
    if constexpr (kOn) {
      if (!on) return;
      const long long now = clock64();
      trip_acc[phase] += now - trip_acc[kTripPhases];
      trip_acc[kTripPhases] = now;
    }
  }
  __device__ void finish() const {
    if constexpr (kOn) {
      if (!on) return;
      for (int p = 0; p < kTripPhases; ++p)
        trip_clocks[p] += static_cast<unsigned long long>(trip_acc[p]);
    }
  }
};

struct NoPush {
  __device__ void operator()() const {}
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Sums of up to four values over the cluster. `push` runs after the block
// barrier and before the cluster barrier, so that what it pushes (a band
// the block has just completed) is published by the same barrier.
template <int kT>
struct ClusterReducer {
  static constexpr int kWarps = kT / 32;
  float4* slots;  // 2 x kMaxCluster, written by every rank
  float4* warp;   // kWarps, this block's
  int parity = 0;

  template <class Push = NoPush>
  __device__ float4 sum4(const Band& bd, float4 v, Push push = Push()) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
      v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
      v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
      v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
    }
    if ((threadIdx.x & 31) == 0) warp[threadIdx.x >> 5] = v;
    __syncthreads();
    push();
    float4* set = slots + parity * kMaxCluster;
    if (static_cast<int>(threadIdx.x) < bd.C) {
      float4 s = warp[0];
#pragma unroll
      for (int i = 1; i < kWarps; ++i) s = add4(s, warp[i]);
      cgrp::this_cluster().map_shared_rank(set, threadIdx.x)[bd.rank] = s;
    }
    cgrp::this_cluster().sync();
    float4 t = set[0];
    for (int c = 1; c < bd.C; ++c) t = add4(t, set[c]);
    parity ^= 1;
    return t;
  }
  template <class Push = NoPush>
  __device__ float sum(const Band& bd, float a, Push push = Push()) {
    return sum4(bd, make_float4(a, 0.f, 0.f, 0.f), push).x;
  }
  __device__ void sum2(const Band& bd, float a, float b, float& ta, float& tb) {
    const float4 t = sum4(bd, make_float4(a, b, 0.f, 0.f));
    ta = t.x;
    tb = t.y;
  }
};

// out (R x n, row stride n) = A (R x K) . B (K x n), scaled elementwise by
// `scale` (row stride n) when it is not null. A(i, k) = a[i*a_row + k*a_col],
// B(k, j) = b[k*b_row + j*b_col]. A thread computes 4 rows of columns j and
// j + ceil(n/2) (lanes take neighbouring j: A's reads are broadcasts, B's
// fall in distinct banks) over one of S slices of K, S the largest power of
// two that keeps the threads busy and a slice at least 4 long; with S > 1
// the slices' sums go through `part` (8 kT floats) and are added in slice
// order. Ends with a barrier.
template <int kT>
__device__ void band_matmul(const float* a, int a_row, int a_col, const float* b,
                            int b_row, int b_col, float* out, int R, int K,
                            int n, const float* __restrict__ scale, float* part) {
  const int half = (n + 1) / 2;
  const int groups = (R + 3) / 4;
  const int items = groups * half;
  int S = 1;
  while (items * S * 2 <= kT && K >= 8 * S) S *= 2;
  const int chunk = (K + S - 1) / S;
  const int pr = 2 * half;  // row stride of the partials
  for (int t = threadIdx.x; t < items * S; t += kT) {
    const int item = t % items, sl = t / items;
    const int j0 = item % half;
    const int i0 = (item / half) * 4;
    const int k0 = sl * chunk, k1 = min(K, k0 + chunk);
    int rows[4], cols[2];
#pragma unroll
    for (int m = 0; m < 4; ++m) rows[m] = min(i0 + m, R - 1);
#pragma unroll
    for (int c = 0; c < 2; ++c) cols[c] = min(j0 + c * half, n - 1);
    float acc[4][2] = {};
    for (int k = k0; k < k1; ++k) {
      float av[4], bv[2];
#pragma unroll
      for (int m = 0; m < 4; ++m) av[m] = a[rows[m] * a_row + k * a_col];
#pragma unroll
      for (int c = 0; c < 2; ++c) bv[c] = b[k * b_row + cols[c] * b_col];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int c = 0; c < 2; ++c) acc[m][c] = fmaf(av[m], bv[c], acc[m][c]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = i0 + m, j = j0 + c * half;
        if (i < R && j < n) {
          if (S == 1) {
            out[i * n + j] = scale != nullptr ? acc[m][c] * __ldg(scale + i * n + j)
                                              : acc[m][c];
          } else {
            part[(sl * groups * 4 + i) * pr + j] = acc[m][c];
          }
        }
      }
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < R * n; idx += kT) {
      const int i = idx / n, j = idx - (idx / n) * n;
      float v = 0.f;
      for (int sl = 0; sl < S; ++sl) v += part[(sl * groups * 4 + i) * pr + j];
      out[idx] = scale != nullptr ? v * __ldg(scale + idx) : v;
    }
  }
  __syncthreads();
}

// Pushes this rank's rows [a, b) of a whole-field buffer (row stride w) to
// the same rows of every other rank's copy. The band must be complete
// (barrier); the caller's cluster barrier publishes the copies.
template <int kT>
__device__ void push_band(float* full, const Band& bd) {
  if (bd.C == 1) return;
  auto cluster = cgrp::this_cluster();
  const int n = bd.rows() * bd.w;
  const int first = bd.a * bd.w;
  if ((bd.w & 3) == 0) {
    const int n4 = n / 4;
    const float4* src = reinterpret_cast<const float4*>(full + first);
    for (int t = threadIdx.x; t < n4 * (bd.C - 1); t += kT) {
      const int c = t / n4, e = t - c * n4;
      const int dst = c < bd.rank ? c : c + 1;
      reinterpret_cast<float4*>(cluster.map_shared_rank(full, dst) + first)[e] = src[e];
    }
  } else {
    for (int t = threadIdx.x; t < n * (bd.C - 1); t += kT) {
      const int c = t / n, e = t - c * n;
      const int dst = c < bd.rank ? c : c + 1;
      cluster.map_shared_rank(full, dst)[first + e] = full[first + e];
    }
  }
}

// Shared-memory work space of one rank's solve.
struct ClusterCg {
  float* g1;    // (H, W): the residual r, whole on every rank
  float* g2;    // (H, W): the scaled spectrum, gathered for Qy^T
  float* ga;    // (H, W): A d, gathered for the residual's update
  float* x;     // (R, W) band rows
  float* d;     // (R + 2, W): band rows with one halo row above and below
  float* z;     // (R, W)
  float* t;     // (R, W)
  float* zh;    // (2, W): the neighbours' rows of z above and below the band
  float* part;  // 8 kT floats: the band products' slices
  float* qy;    // the basis, padded rows, as CgBuffers holds it
  float* qx;
};

// Copies the bases into the padded shared layout of load_basis, with this
// block's threads. No barrier: the solve's first reduction provides one.
template <int kT>
__device__ void load_basis_t(const ClusterCg& cg, const float* __restrict__ q_y,
                             const float* __restrict__ q_x, int h, int w) {
  for (int idx = threadIdx.x; idx < h * h; idx += kT)
    cg.qy[(idx / h) * (h + 1) + idx % h] = __ldg(q_y + idx);
  if (h != w)
    for (int idx = threadIdx.x; idx < w * w; idx += kT)
      cg.qx[(idx / w) * (w + 1) + idx % w] = __ldg(q_x + idx);
}

// out = A p on the band's rows; p holds the band with its halo rows (the
// layout of ClusterCg::d).
template <int kT>
__device__ void apply_a_band(const float* p, float* out, const Geometry& g,
                             const Band& bd) {
  const int w = g.w;
  for (int idx = threadIdx.x; idx < bd.rows() * w; idx += kT) {
    const int li = idx / w, j = idx - (idx / w) * w;
    const int i = bd.a + li;
    const float* row = p + (li + 1) * w;
    const float pc = row[j];
    float gy_lo = i > 0 ? pc - row[j - w] : (g.closed ? 0.f : pc);
    float gy_hi = i < g.h - 1 ? row[j + w] - pc : (g.closed ? 0.f : -pc);
    float gx_lo = j > 0 ? pc - row[j - 1] : (g.closed ? 0.f : pc);
    float gx_hi = j < w - 1 ? row[j + 1] - pc : (g.closed ? 0.f : -pc);
    gy_lo *= __ldg(g.acc_y + i * w + j);
    gy_hi *= __ldg(g.acc_y + (i + 1) * w + j);
    gx_lo *= __ldg(g.acc_x + i * (w + 1) + j);
    gx_hi *= __ldg(g.acc_x + i * (w + 1) + j + 1);
    const float lap = (((gy_hi - gy_lo) + gx_hi) - gx_lo) * g.inv_dx2;
    out[idx] = __ldg(g.fluid + i * w + j) > 0.f ? -lap : pc;
  }
}

// z = Q^T ((Q r Q^T) * 1/lam) Q on the band (pcg_core.cuh's apply_m before
// its projection), the residual whole in g1; the band's first and last rows
// of z are pushed to the neighbours' halo rows, for the next cluster
// barrier to publish. Ends with a block barrier.
template <int kT, bool kTrace>
__device__ void apply_m_band(const ClusterCg& cg, const Geometry& g,
                             const Band& bd, TripClock<kTrace> clk) {
  const int h = g.h, w = g.w, a = bd.a, R = bd.rows();
  const int qs = h + 1, qxs = w + 1;
  band_matmul<kT>(cg.qy + a * qs, qs, 1, cg.g1, w, 1, cg.t, R, h, w, nullptr,
                  cg.part);                                    // Qy r
  clk.mark(2);
  band_matmul<kT>(cg.t, w, 1, cg.qx, 1, qxs, cg.g2 + a * w, R, w, w,
                  g.inv_lam + a * w, cg.part);                 // (.) Qx^T * 1/lam
  clk.mark(3);
  push_band<kT>(cg.g2, bd);
  cgrp::this_cluster().sync();
  clk.mark(4);
  band_matmul<kT>(cg.qy + a, 1, qs, cg.g2, w, 1, cg.t, R, h, w, nullptr,
                  cg.part);                                    // Qy^T (.)
  clk.mark(5);
  band_matmul<kT>(cg.t, w, 1, cg.qx, qxs, 1, cg.z, R, w, w, nullptr,
                  cg.part);                                    // (.) Qx
  clk.mark(6);
  auto cluster = cgrp::this_cluster();
  for (int t = threadIdx.x; t < 2 * w; t += kT) {
    const bool up = t < w;
    const int j = up ? t : t - w;
    if (up && bd.rank > 0)
      cluster.map_shared_rank(cg.zh, bd.rank - 1)[w + j] = cg.z[j];
    if (!up && bd.rank < bd.C - 1)
      cluster.map_shared_rank(cg.zh, bd.rank + 1)[j] = cg.z[(R - 1) * w + j];
  }
}

// The projection of z (closed domains: the fluid mean mu removed on fluid
// cells) and the scalars of one CG step, from one cluster reduction of
// r.z, r.r, fluid.z and fluid.r over the bands: r.z' = r.z - mu fluid.r.
// Projects the band and its halo rows in place. Returns (r.z', r.r).
template <int kT>
__device__ float2 project_and_dot(const ClusterCg& cg, const Geometry& g,
                                  const Band& bd, float n_fluid,
                                  ClusterReducer<kT>& red) {
  const int w = g.w, n = bd.rows() * w;
  const float* r = cg.g1 + bd.a * w;
  const float* fluid = g.fluid + bd.a * w;
  float4 part = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int idx = threadIdx.x; idx < n; idx += kT) {
    const float f = __ldg(fluid + idx);
    part.x += r[idx] * cg.z[idx];
    part.y += r[idx] * r[idx];
    part.z += f * cg.z[idx];
    part.w += f * r[idx];
  }
  const float4 s = red.sum4(bd, part);
  if (!g.closed) return make_float2(s.x, s.y);
  const float mu = s.z / n_fluid;
  for (int idx = threadIdx.x; idx < n; idx += kT)
    if (__ldg(fluid + idx) > 0.f) cg.z[idx] -= mu;
  for (int j = threadIdx.x; j < w; j += kT) {
    if (bd.a > 0 && __ldg(g.fluid + (bd.a - 1) * w + j) > 0.f) cg.zh[j] -= mu;
    if (bd.b < g.h && __ldg(g.fluid + bd.b * w + j) > 0.f) cg.zh[w + j] -= mu;
  }
  return make_float2(s.x - mu * s.w, s.y);
}

// The cold CG loop of pcg_core for this cluster's system. On entry the
// band's rows of cg.g1 hold `div` (the rhs is project(where(fluid, -div,
// 0))) and the basis is loading. The best iterate's band is written to
// `best` (R x W) whenever the residual improves. Returns the trip count,
// the same in every thread of every rank.
//
// Every rank keeps the whole residual: each pushes its band of A d, and
// after the barrier of the d.Ad reduction all update every row of r by the
// same operations, so they hold the same bits. The projection of z is
// folded into the reduction of r.z and r.r. A trip has three cluster
// barriers: d.Ad with the push of A d, the push of the scaled spectrum,
// and r.z, r.r with the projection's sums.
template <int kT, bool kTrace>
__device__ int pcg_cluster(const ClusterCg& cg, const Geometry& g,
                           const Band& bd, float* best, float tol, int maxiter,
                           ClusterReducer<kT>& red) {
  const int w = g.w, n = bd.rows() * w, hw = g.h * w;
  const float* fluid = g.fluid + bd.a * w;
  float* r = cg.g1 + bd.a * w;
  float* ad = cg.ga + bd.a * w;
  float* x = cg.x;
  float* d = cg.d + w;  // the band's first row; d[-w..] and d[n..] are halo
  float* z = cg.z;

  float part_f = 0.f, part_b = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += kT) {
    const float f = __ldg(fluid + idx);
    const float v = f > 0.f ? -r[idx] : 0.f;  // b
    r[idx] = v;
    part_f += f;
    part_b += f * v;
    x[idx] = 0.f;
  }
  float sum_f, sum_b;
  red.sum2(bd, part_f, part_b, sum_f, sum_b);
  const float n_fluid = fmaxf(sum_f, 1.f);
  if (g.closed) {
    const float mean = sum_b / n_fluid;
    for (int idx = threadIdx.x; idx < n; idx += kT)
      if (__ldg(fluid + idx) > 0.f) r[idx] -= mean;
  }
  float part = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += kT) part += r[idx] * r[idx];
  const float b2 = fmaxf(red.sum(bd, part, [&] { push_band<kT>(cg.g1, bd); }),
                         1e-30f);
  apply_m_band<kT, kTrace>(cg, g, bd, TripClock<kTrace>{});
  float2 dots = project_and_dot<kT>(cg, g, bd, n_fluid, red);
  float rz = dots.x, rs = dots.y;
  for (int idx = threadIdx.x; idx < n; idx += kT) {
    d[idx] = z[idx];
    best[idx] = x[idx];
  }
  for (int j = threadIdx.x; j < w; j += kT) {
    d[j - w] = cg.zh[j];
    d[n + j] = cg.zh[w + j];
  }
  float rs_best = rs;
  const float tol2 = tol * tol;
  int k = 0;
  const TripClock<kTrace> clk = TripClock<kTrace>::here();
  clk.start();
  while (k < maxiter && rs / b2 > tol2 && rs < 4.f * rs_best) {
    __syncthreads();  // d and its halo rows complete
    apply_a_band<kT>(cg.d, ad, g, bd);
    part = 0.f;
    for (int idx = threadIdx.x; idx < n; idx += kT) part += d[idx] * ad[idx];
    const float dad = red.sum(bd, part, [&] { push_band<kT>(cg.ga, bd); });
    clk.mark(0);
    const bool ok = dad > 0.f;
    const float alpha = ok ? rz / dad : 0.f;
    for (int idx = threadIdx.x; idx < n; idx += kT) x[idx] += alpha * d[idx];
    for (int idx = threadIdx.x; idx < hw; idx += kT)
      cg.g1[idx] = __fmaf_rn(-alpha, cg.ga[idx], cg.g1[idx]);
    __syncthreads();  // r whole
    clk.mark(1);
    apply_m_band<kT, kTrace>(cg, g, bd, clk);
    dots = project_and_dot<kT>(cg, g, bd, n_fluid, red);
    const float rz_new = dots.x, rs_new = dots.y;
    const float beta = ok ? rz_new / (rz != 0.f ? rz : 1.f) : 0.f;
    const bool better = rs_new < rs_best;
    for (int idx = threadIdx.x; idx < n; idx += kT) {
      d[idx] = __fmaf_rn(beta, d[idx], z[idx]);
      if (better) best[idx] = x[idx];
    }
    for (int j = threadIdx.x; j < w; j += kT) {
      d[j - w] = __fmaf_rn(beta, d[j - w], cg.zh[j]);
      d[n + j] = __fmaf_rn(beta, d[n + j], cg.zh[w + j]);
    }
    rs_best = fminf(rs_new, rs_best);
    rz = rz_new;
    rs = rs_new;
    ++k;
    clk.mark(7);
  }
  clk.finish();
  return k;
}

}  // namespace
