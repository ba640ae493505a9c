// The masked, spectrally preconditioned CG loop of ops/pallas_cg.py ::
// pcg_core, for one system split over the C blocks (CTAs) of a
// thread-block cluster. K1 (pcg.cu) runs its solves on it, K2 and K3
// (fused_step.cu) the step's warm solve and the transpose solve.
//
// What it computes, for one (H, W) system per cluster:
//
//   A p = -div(acc * grad p) / dx^2 on fluid cells, p on solid cells;
//   b   = project(where(fluid, -div, 0)), where project() removes the fluid
//         mean on a closed domain (the operator's nullspace) and is the
//         identity on an open one;
//   M r = project(Q^T ((Q r Q^T) * inv_lam) Q), the exact inverse of the
//         obstacle-free operator (DCT-II basis closed, DST-I open), or the
//         identity without the preconditioner;
//   x starts at project(where(fluid, x0, 0)) for a warm start, else 0;
//   per-system exit at |r|^2/|b|^2 <= tol^2, a stop when |r|^2 reaches 4x
//   the best seen, and the best iterate as the result.
//
// The work is split by rows:
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
//   The warm start's halo rows of x are read from x0 in global memory and
//   projected with the same mean by owner and neighbour alike.
//
// A trip has three cluster barriers: d.Ad with the push of A d, the push of
// the scaled spectrum, and r.z, r.r with the sums the projection of z
// needs (r.z' = r.z - mu fluid.r, mu the fluid mean of z). Around them sit
// the block barriers of the four band products and the elementwise passes.
// The products are fp32 on the CUDA cores (no TF32): each CTA holds the
// whole basis and computes its band's rows, with K split over the threads
// when the band is short and the slices added in order.
//
// The large layout (kLayoutLarge; a kernel takes it on a grid where the
// buffers above fit a block under no cluster size, as K1 does at 128^2). Two whole-field
// copies stay (r in g1, the spectrum in g2); the basis and ga go. The basis is read
// from global memory through the read-only path (L2, shared by every
// cluster), with Qx^T passed transposed so that every product's reads are
// coalesced or warp-uniform. Without ga each rank updates only its band of
// r (the same fmaf as the whole-field update, so the same bits) and pushes
// the band into its peers' g1; a fourth cluster barrier per trip publishes
// it before the product Qy r reads r whole. The peers' g1 is free for the
// push: since its last read of other ranks' rows of r (Qy r, or the halo
// rows of z without the preconditioner), every rank has passed at least the
// r.z barrier and the d.Ad barrier. (ga cannot share g2: a rank pushes its
// spectrum into g2 while a slower peer may still be reading ga.)
//
// The banded layout (kLayoutBanded; a kernel takes it on a grid where the
// large layout fits a block under no cluster size, as K1 does at 256^2: its
// two whole fields are 2 H W floats a rank, 524 KB at 256^2; K2 from
// 146^2, K3 from 152^2). No whole field stays in
// shared memory: a rank keeps the band of r (rb) beside its band of x, d,
// z and t. The two whole fields the products need, r for Qy r and the
// scaled spectrum for Qy^T (.), move to a scratch in global memory, one
// (H, W) pair per sample, which the launcher's caller allocates; at 351^2 x
// 8 it is 7.9 MB, well inside the card's 50 MB L2. Each rank writes its band
// of r (where it updates it) and of the spectrum (where the product stores
// it) straight into the scratch, and the cluster barrier that published the
// band in the large layout publishes these writes: its release/acquire at
// cluster scope orders global memory too. The products read the scratch
// through L2 (__ldcg, never __ldg, and never L1, which is not coherent
// between the cluster's SMs). The scratch is free for the next write by
// the argument that frees the peers' g1 in the large layout: since its
// last read of a row, every rank has passed at least two cluster barriers.
// Pulling the peers' bands through distributed shared memory was the other
// design; the scratch was built because it keeps the products' loops and
// their order of summation those of the large layout (the same B operand,
// read from L2 in place of shared memory) and the trip keeps the large
// layout's four cluster barriers.
//
// Read-only loads (__ldg) are used only for what no kernel writes: the
// geometry, the basis and the warm start. Everything the solve computes is
// read with plain loads, or from the banded layout's scratch through L2.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cgrp = cooperative_groups;

// The threads of a block of every cluster kernel (K1, K2, K3), the largest
// cluster, and the shared memory a block may have on the H100.
constexpr int kClusterThreads = 512;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSharedBytes = 232448;

// The layouts of a rank's shared memory (take_cg; the header): the small
// one, the large one and the banded one.
constexpr int kLayoutSmall = 0;
constexpr int kLayoutLarge = 1;
constexpr int kLayoutBanded = 2;

struct Geometry {
  const float* acc_y;    // (H+1, W)
  const float* acc_x;    // (H, W+1)
  const float* fluid;    // (H, W)
  const float* inv_lam;  // (H, W)
  int h, w;
  float inv_dx2;
  bool closed;
};

// Floats of the basis: Q with a row stride of H+1 (Q^T is read by index;
// the pad keeps transposed reads free of bank conflicts) and, when H != W,
// the second basis with a row stride of W+1.
__host__ __device__ inline int basis_floats(int h, int w) {
  return h * (h + 1) + (h == w ? 0 : w * (w + 1));
}

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
//
// kA / kB: where A / B lie (kSmem: shared memory; kReadOnly: global memory
// no kernel writes, read through the read-only path, as the basis of the
// large and banded layouts; kL2: the banded layout's scratch, read through
// L2). With one operand in global memory the loop over K is unrolled
// twice, so that the loads in flight stay within the 128 registers a thread
// of a 512-thread block has; with both (the banded layout's Qy r and Qy^T
// (.)) four times, the unroll at which ptxas keeps that kernel free of
// spills (it spills unrolled once or twice).
constexpr int kSmem = 0;
constexpr int kReadOnly = 1;
constexpr int kL2 = 2;

template <int kSrc>
__device__ __forceinline__ float load_f(const float* p) {
  if constexpr (kSrc == kReadOnly) return __ldg(p);
  else if constexpr (kSrc == kL2) return __ldcg(p);
  else return *p;
}

// One step k of band_matmul's sums for one thread's 4 rows and 2 columns.
template <int kA, int kB>
__device__ __forceinline__ void band_fma(const float* a, int a_row, int a_col,
                                         const float* b, int b_row, int b_col,
                                         const int (&rows)[4],
                                         const int (&cols)[2], int k,
                                         float (&acc)[4][2]) {
  float av[4], bv[2];
#pragma unroll
  for (int m = 0; m < 4; ++m) av[m] = load_f<kA>(a + rows[m] * a_row + k * a_col);
#pragma unroll
  for (int c = 0; c < 2; ++c) bv[c] = load_f<kB>(b + k * b_row + cols[c] * b_col);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[m][c] = fmaf(av[m], bv[c], acc[m][c]);
}

template <int kT, int kA = kSmem, int kB = kSmem>
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
    if constexpr (kA != kSmem && kB != kSmem) {
#pragma unroll 4
      for (int k = k0; k < k1; ++k)
        band_fma<kA, kB>(a, a_row, a_col, b, b_row, b_col, rows, cols, k, acc);
    } else if constexpr (kA != kSmem || kB != kSmem) {
#pragma unroll 2
      for (int k = k0; k < k1; ++k)
        band_fma<kA, kB>(a, a_row, a_col, b, b_row, b_col, rows, cols, k, acc);
    } else {
      for (int k = k0; k < k1; ++k)
        band_fma<kSmem, kSmem>(a, a_row, a_col, b, b_row, b_col, rows, cols, k,
                               acc);
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
  float* g1;    // (H, W): the residual r, whole on every rank (the banded
                // layout: the sample's scratch in global memory)
  float* g2;    // (H, W): the scaled spectrum, gathered for Qy^T (the
                // banded layout: the scratch's second field)
  float* ga;    // (H, W): A d, gathered for the residual's update (null in
                // the large layout, where A d's band is in t)
  float* x;     // (R, W) band rows
  float* d;     // (R + 2, W): band rows with one halo row above and below
  float* z;     // (R, W)
  float* t;     // (R, W)
  float* zh;    // (2, W): the neighbours' rows of z above and below the band
  float* part;  // 8 kT floats: the band products' slices
  float* qy;    // the basis, padded rows (basis_floats); null in the large
  float* qx;    // layout
  // The large layout's basis in global memory, unpadded: Qy (H x H), Qx
  // and Qx^T (W x W each).
  const float* gqy = nullptr;
  const float* gqx = nullptr;
  const float* gqxt = nullptr;
  float* rb = nullptr;  // (R, W): the band of r (the banded layout only)
};

// Offsets (floats) of ClusterCg's buffers in a rank's shared memory; -1 for
// a buffer the layout does not have (the large one: the basis, ga; the
// banded one: those and g1, g2; rb only in the banded one).
struct CgOffsets {
  int qy, g1, g2, ga, x, d, z, t, zh, part, rb;
};

// Takes ClusterCg's buffers from offset o on (o is advanced past them),
// each 16-byte aligned, for H x W cells, bands of at most R rows and T
// threads, in `layout` (kLayoutSmall, kLayoutLarge: without the basis and
// ga; kLayoutBanded: without g1 and g2 either, with rb).
// ops/cuda_cg.py :: _cg_floats counts the same.
__host__ __device__ inline CgOffsets take_cg(int& o, int h, int w, int R,
                                             int T, int layout = kLayoutSmall) {
  auto take = [&o](int n) { const int at = o; o += align4(n); return at; };
  const bool small = layout == kLayoutSmall, banded = layout == kLayoutBanded;
  CgOffsets c;
  c.qy = small ? take(basis_floats(h, w)) : -1;
  c.g1 = banded ? -1 : take(h * w);
  c.g2 = banded ? -1 : take(h * w);
  c.ga = small ? take(h * w) : -1;
  c.x = take(R * w);
  c.d = take((R + 2) * w);
  c.z = take(R * w);
  c.t = take(R * w);
  c.zh = take(2 * w);
  c.part = take(8 * T);
  c.rb = banded ? take(R * w) : -1;
  return c;
}

// The layout in which a cluster kernel runs an H-row grid whose shared
// memory is bytes(C, layout) a block at cluster size C: the small one where
// it fits a block under some cluster size, else the large one where that
// fits, else the banded one; so that every plan of a grid keeps one layout.
// K1 (pcg.cu :: grid_layout), K2 and K3 (fused_step.cu :: fwd_grid_layout,
// bwd_grid_layout) each decide by it on their own bytes.
// ops/cuda_cg.py :: layout_where_fits is the same rule.
template <typename Bytes>
__host__ __device__ inline int layout_where_fits(int h, Bytes bytes) {
  for (int layout = kLayoutSmall; layout < kLayoutBanded; ++layout)
    for (int C = 1; C <= kMaxCluster && C <= h; C *= 2)
      if (bytes(C, layout) <= kMaxSharedBytes) return layout;
  return kLayoutBanded;
}

// The banded layout has no g1 and g2 in shared memory (their offsets are
// -1): its caller points them at its scratch before any use.
__device__ inline ClusterCg cluster_cg(float* smem, const CgOffsets& c, int h,
                                       int w) {
  float* qy = c.qy < 0 ? nullptr : smem + c.qy;
  ClusterCg cg{smem + c.g1, smem + c.g2,
               c.ga < 0 ? nullptr : smem + c.ga,
               smem + c.x,  smem + c.d,  smem + c.z,  smem + c.t,
               smem + c.zh, smem + c.part, qy,
               qy == nullptr || h == w ? qy : qy + h * (h + 1)};
  cg.rb = c.rb < 0 ? nullptr : smem + c.rb;
  return cg;
}

// This rank's band of r: rows [a, b) of the whole-field copy g1 (w
// columns), or the banded layout's own buffer rb.
template <int kLayout>
__device__ __forceinline__ float* r_band(const ClusterCg& cg, const Band& bd,
                                         int w) {
  if constexpr (kLayout == kLayoutBanded) return cg.rb;
  else return cg.g1 + bd.a * w;
}

// Publishes this rank's band of r, complete (block barrier), for the next
// cluster barrier: pushed into the peers' g1, or written into the banded
// layout's scratch.
template <int kT, int kLayout>
__device__ void publish_r_band(const ClusterCg& cg, const Band& bd) {
  if constexpr (kLayout == kLayoutBanded) {
    float* dst = cg.g1 + bd.a * bd.w;
    for (int idx = threadIdx.x; idx < bd.rows() * bd.w; idx += kT)
      dst[idx] = cg.rb[idx];
  } else {
    push_band<kT>(cg.g1, bd);
  }
}

// Copies the bases into the padded shared layout, with this block's
// threads. No barrier: the solve's first reduction provides one.
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

// z = Q^T ((Q r Q^T) * 1/lam) Q on the band (M before its projection), the
// residual whole in g1; the band's first and last rows
// of z are pushed to the neighbours' halo rows, for the next cluster
// barrier to publish. Ends with a block barrier.
//
// kLayout large and banded: the basis from global memory (ClusterCg::gqy,
// gqx, gqxt), the same products in the same order of summation; banded,
// r and the spectrum whole in the scratch, read through L2, and the
// spectrum's band stored there (no push).
template <int kT, bool kTrace, int kLayout = kLayoutSmall>
__device__ void apply_m_band(const ClusterCg& cg, const Geometry& g,
                             const Band& bd, TripClock<kTrace> clk) {
  const int h = g.h, w = g.w, a = bd.a, R = bd.rows();
  // Where the whole r (g1) and the whole spectrum (g2) lie.
  constexpr int kWhole = kLayout == kLayoutBanded ? kL2 : kSmem;
  if constexpr (kLayout != kLayoutSmall) {
    band_matmul<kT, kReadOnly, kWhole>(cg.gqy + a * h, h, 1, cg.g1, w, 1,
                                       cg.t, R, h, w, nullptr,
                                       cg.part);               // Qy r
    clk.mark(2);
    band_matmul<kT, kSmem, kReadOnly>(cg.t, w, 1, cg.gqxt, w, 1, cg.g2 + a * w,
                                      R, w, w, g.inv_lam + a * w,
                                      cg.part);                // (.) Qx^T * 1/lam
  } else {
    const int qs = h + 1, qxs = w + 1;
    band_matmul<kT>(cg.qy + a * qs, qs, 1, cg.g1, w, 1, cg.t, R, h, w, nullptr,
                    cg.part);                                  // Qy r
    clk.mark(2);
    band_matmul<kT>(cg.t, w, 1, cg.qx, 1, qxs, cg.g2 + a * w, R, w, w,
                    g.inv_lam + a * w, cg.part);               // (.) Qx^T * 1/lam
  }
  clk.mark(3);
  if constexpr (kLayout != kLayoutBanded) push_band<kT>(cg.g2, bd);
  cgrp::this_cluster().sync();
  clk.mark(4);
  if constexpr (kLayout != kLayoutSmall) {
    band_matmul<kT, kReadOnly, kWhole>(cg.gqy + a, 1, h, cg.g2, w, 1, cg.t, R,
                                       h, w, nullptr, cg.part);  // Qy^T (.)
    clk.mark(5);
    band_matmul<kT, kSmem, kReadOnly>(cg.t, w, 1, cg.gqx, w, 1, cg.z, R, w, w,
                                      nullptr, cg.part);         // (.) Qx
  } else {
    const int qs = h + 1, qxs = w + 1;
    band_matmul<kT>(cg.qy + a, 1, qs, cg.g2, w, 1, cg.t, R, h, w, nullptr,
                    cg.part);                                  // Qy^T (.)
    clk.mark(5);
    band_matmul<kT>(cg.t, w, 1, cg.qx, qxs, 1, cg.z, R, w, w, nullptr,
                    cg.part);                                  // (.) Qx
  }
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

// z = r without the preconditioner: the band from r's band, and the halo
// rows zh from the whole residual in g1 (every rank holds the same bits of
// r; banded, the scratch, through L2). Each thread writes the entries it
// reads back later, so no barrier.
template <int kT, int kLayout = kLayoutSmall>
__device__ void copy_r_band(const ClusterCg& cg, const Geometry& g,
                            const Band& bd) {
  constexpr int kWhole = kLayout == kLayoutBanded ? kL2 : kSmem;
  const int w = g.w, n = bd.rows() * w;
  const float* r = r_band<kLayout>(cg, bd, w);
  for (int idx = threadIdx.x; idx < n; idx += kT) cg.z[idx] = r[idx];
  for (int j = threadIdx.x; j < w; j += kT) {
    if (bd.a > 0) cg.zh[j] = load_f<kWhole>(cg.g1 + (bd.a - 1) * w + j);
    if (bd.b < g.h) cg.zh[w + j] = load_f<kWhole>(cg.g1 + bd.b * w + j);
  }
}

// The projection of z (closed domains with the preconditioner: the fluid
// mean mu removed on fluid cells) and the scalars of one CG step, from one
// cluster reduction of r.z, r.r, fluid.z and fluid.r over the bands:
// r.z' = r.z - mu fluid.r. Projects the band and its halo rows in place.
// Returns (r.z', r.r).
template <int kT, int kLayout = kLayoutSmall>
__device__ float2 project_and_dot(const ClusterCg& cg, const Geometry& g,
                                  const Band& bd, float n_fluid, bool precond,
                                  ClusterReducer<kT>& red) {
  const int w = g.w, n = bd.rows() * w;
  const float* r = r_band<kLayout>(cg, bd, w);
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
  if (!g.closed || !precond) return make_float2(s.x, s.y);
  const float mu = s.z / n_fluid;
  for (int idx = threadIdx.x; idx < n; idx += kT)
    if (__ldg(fluid + idx) > 0.f) cg.z[idx] -= mu;
  for (int j = threadIdx.x; j < w; j += kT) {
    if (bd.a > 0 && __ldg(g.fluid + (bd.a - 1) * w + j) > 0.f) cg.zh[j] -= mu;
    if (bd.b < g.h && __ldg(g.fluid + bd.b * w + j) > 0.f) cg.zh[w + j] -= mu;
  }
  return make_float2(s.x - mu * s.w, s.y);
}

// The warm start at one cell: where(fluid, x0, 0), less the fluid mean mx
// on a closed domain (mx = 0 on an open one). Owner and neighbour compute a
// halo row's entries by this same expression.
__device__ __forceinline__ float warm_x(const float* __restrict__ x0,
                                        const Geometry& g, int idx, float mx) {
  const bool fl = __ldg(g.fluid + idx) > 0.f;
  const float v = fl ? __ldg(x0 + idx) : 0.f;
  return g.closed && fl ? v - mx : v;
}

// The CG loop of ops/pallas_cg.py :: pcg_core for this cluster's system.
// On entry r's band (r_band) holds `div` (the rhs is
// project(where(fluid, -div, 0))) and, with the preconditioner, the basis
// is loading. x0 (global, read-only, the system's (H, W) field) is the
// warm start, or null for a cold start, which reads nothing. The best
// iterate's band is written to `best` (R x W, shared or global memory)
// whenever the residual improves. Returns the trip count, the same in
// every thread of every rank.
//
// Every rank keeps the whole residual: each pushes its band of A d, and
// after the barrier of the d.Ad reduction all update every row of r by the
// same operations, so they hold the same bits. The projection of z is
// folded into the reduction of r.z and r.r. A trip has three cluster
// barriers: d.Ad with the push of A d, the push of the scaled spectrum,
// and r.z, r.r with the projection's sums. A warm start adds no barrier:
// the fluid sum of x0 rides on the first reduction, and A x0 is taken from
// the band and halo rows of x before the reduction of |b|^2, whose barrier
// publishes the residual's band.
//
// kLayout large (the header): A d in t, each rank updates its band of r and
// pushes it, a fourth cluster barrier per trip. Banded (the header): the
// same, the band of r in rb and written into the scratch, not pushed.
template <int kT, bool kTrace, int kLayout = kLayoutSmall>
__device__ int pcg_cluster(const ClusterCg& cg, const Geometry& g,
                           const Band& bd, const float* __restrict__ x0,
                           float* best, float tol, int maxiter, bool precond,
                           ClusterReducer<kT>& red) {
  const int w = g.w, n = bd.rows() * w, hw = g.h * w;
  const float* fluid = g.fluid + bd.a * w;
  float* r = r_band<kLayout>(cg, bd, w);
  float* ad = kLayout != kLayoutSmall ? cg.t : cg.ga + bd.a * w;
  float* x = cg.x;
  float* d = cg.d + w;  // the band's first row; d[-w..] and d[n..] are halo
  float* z = cg.z;

  float part_f = 0.f, part_b = 0.f, part_x = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += kT) {
    const float f = __ldg(fluid + idx);
    const float v = f > 0.f ? -r[idx] : 0.f;  // b
    r[idx] = v;
    part_f += f;
    part_b += f * v;
    if (x0 != nullptr) {
      const float xv = f > 0.f ? __ldg(x0 + bd.a * w + idx) : 0.f;
      x[idx] = xv;
      part_x += f * xv;
    } else {
      x[idx] = 0.f;
    }
  }
  const float4 sums = red.sum4(bd, make_float4(part_f, part_b, part_x, 0.f));
  const float n_fluid = fmaxf(sums.x, 1.f);
  if (g.closed) {
    const float mean = sums.y / n_fluid;
    for (int idx = threadIdx.x; idx < n; idx += kT)
      if (__ldg(fluid + idx) > 0.f) r[idx] -= mean;
  }
  float part = 0.f;
  for (int idx = threadIdx.x; idx < n; idx += kT) part += r[idx] * r[idx];
  if (x0 != nullptr) {  // r = b - A x, x and its halo rows in d's layout
    const float mx = sums.z / n_fluid;
    for (int idx = threadIdx.x; idx < n; idx += kT) {
      x[idx] = warm_x(x0, g, bd.a * w + idx, mx);
      d[idx] = x[idx];
    }
    for (int j = threadIdx.x; j < w; j += kT) {
      if (bd.a > 0) d[j - w] = warm_x(x0, g, (bd.a - 1) * w + j, mx);
      if (bd.b < g.h) d[n + j] = warm_x(x0, g, bd.b * w + j, mx);
    }
    __syncthreads();
    apply_a_band<kT>(cg.d, z, g, bd);
    for (int idx = threadIdx.x; idx < n; idx += kT) r[idx] -= z[idx];
  }
  const float b2 = fmaxf(
      red.sum(bd, part, [&] { publish_r_band<kT, kLayout>(cg, bd); }), 1e-30f);
  if (precond)
    apply_m_band<kT, kTrace, kLayout>(cg, g, bd, TripClock<kTrace>{});
  else
    copy_r_band<kT, kLayout>(cg, g, bd);
  float2 dots = project_and_dot<kT, kLayout>(cg, g, bd, n_fluid, precond, red);
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
    const float dad = red.sum(bd, part, [&] {
      if constexpr (kLayout == kLayoutSmall) push_band<kT>(cg.ga, bd);
    });
    clk.mark(0);
    const bool ok = dad > 0.f;
    const float alpha = ok ? rz / dad : 0.f;
    for (int idx = threadIdx.x; idx < n; idx += kT) x[idx] += alpha * d[idx];
    if constexpr (kLayout == kLayoutBanded) {
      for (int idx = threadIdx.x; idx < n; idx += kT) {
        const float v = __fmaf_rn(-alpha, ad[idx], r[idx]);
        r[idx] = v;
        cg.g1[bd.a * w + idx] = v;
      }
      cgrp::this_cluster().sync();  // r whole in the scratch
    } else if constexpr (kLayout == kLayoutLarge) {
      for (int idx = threadIdx.x; idx < n; idx += kT)
        r[idx] = __fmaf_rn(-alpha, ad[idx], r[idx]);
      __syncthreads();  // the band of r complete
      push_band<kT>(cg.g1, bd);
      cgrp::this_cluster().sync();  // r whole
    } else {
      for (int idx = threadIdx.x; idx < hw; idx += kT)
        cg.g1[idx] = __fmaf_rn(-alpha, cg.ga[idx], cg.g1[idx]);
      __syncthreads();  // r whole
    }
    clk.mark(1);
    if (precond)
      apply_m_band<kT, kTrace, kLayout>(cg, g, bd, clk);
    else
      copy_r_band<kT, kLayout>(cg, g, bd);
    dots = project_and_dot<kT, kLayout>(cg, g, bd, n_fluid, precond, red);
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

// The launch of `kernel` for `batch` systems, one cluster of `cluster`
// blocks of `threads` threads per system, each block with `bytes` of
// dynamic shared memory: the kernel's attributes set and cfg and attr
// filled in (grid batch x cluster, the cluster dimension).
// cudaErrorInvalidValue, with nothing set, for a plan the cluster kernels
// cannot run: a cluster size other than 1, 2, 4, 8 or 16 or above H, a
// thread count other than kClusterThreads, or more shared memory than a
// block may have.
template <class Kernel>
cudaError_t cluster_config(Kernel kernel, int batch, int h, int cluster,
                           int threads, size_t bytes, void* stream,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const bool size_ok = cluster == 1 || cluster == 2 || cluster == 4 ||
                       cluster == 8 || cluster == 16;
  if (!size_ok || cluster > h || batch < 1 || threads != kClusterThreads ||
      bytes > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

// How many clusters of `kernel` under a plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of the query
// or of a plan cluster_config refuses.
template <class Kernel>
int max_active_clusters(Kernel kernel, int h, int cluster, int threads,
                        size_t bytes) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err =
      cluster_config(kernel, 1, h, cluster, threads, bytes, nullptr, cfg, attr);
  if (err == cudaSuccess) {
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (err == cudaSuccess) return n;
  }
  return -static_cast<int>(err);
}

}  // namespace
