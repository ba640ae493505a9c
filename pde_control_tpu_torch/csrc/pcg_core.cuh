// The masked, spectrally preconditioned CG loop as a block-wide device
// routine, shared by the standalone pressure solve (pcg.cu) and the fused
// fluid-step kernels (fused_step.cu), as ops/pallas_cg.py :: pcg_core is
// shared by the TPU kernels.
//
// What it computes, for one (H, W) system per thread block:
//
//   A p = -div(acc * grad p) / dx^2 on fluid cells, p on solid cells;
//   b   = project(where(fluid, -div, 0)), where project() removes the fluid
//         mean on a closed domain (the operator's nullspace) and is the
//         identity on an open one;
//   M r = project(Q^T ((Q r Q^T) * inv_lam) Q), the exact inverse of the
//         obstacle-free operator (DCT-II basis closed, DST-I open);
//   per-sample exit at |r|^2/|b|^2 <= tol^2, a stop when |r|^2 reaches 4x
//   the best seen, and the best iterate as the result.
//
// Every thread of the block agrees on every scalar: each reduction hands
// all of them the same total (warp shuffles, then one shared-memory pass
// that every thread sums in the same order), so the loop's exit is uniform
// and no barrier diverges. Cells are owned by thread idx % kThreads in every
// elementwise pass, here and in the callers, so a value a thread wrote in
// one pass it may read back in the next without a barrier; a value another
// thread wrote needs one.
//
// Read-only loads (__ldg) are used only for the geometry, which no kernel
// writes. The rhs, the iterates and the best iterate are read with plain
// loads, because a fused kernel computes them itself.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotFloats = 4 * kWarps;  // two alternating reduction slots
constexpr int kTileRows = 4;  // output rows per thread in a basis product
constexpr int kTileCols = 2;  // output columns per thread, C/2 apart

struct Geometry {
  const float* acc_y;    // (H+1, W)
  const float* acc_x;    // (H, W+1)
  const float* fluid;    // (H, W)
  const float* inv_lam;  // (H, W)
  int h, w;
  float inv_dx2;
  bool closed;
};

// Sum of `a` and `b` over the block; every thread gets the same totals.
// `slot` holds 2 * kWarps floats that no other reduction in flight uses.
__device__ __forceinline__ void block_sum2(float a, float b, float* slot,
                                           float& total_a, float& total_b) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, o);
    b += __shfl_xor_sync(0xffffffffu, b, o);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    slot[warp] = a;
    slot[kWarps + warp] = b;
  }
  __syncthreads();
  float sa = 0.f, sb = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    sa += slot[i];
    sb += slot[kWarps + i];
  }
  total_a = sa;
  total_b = sb;
}

// Alternates between two reduction slots. Each reduction ends in a
// barrier, so by the time a slot is written again every thread has read
// its previous totals. A kernel keeps one Reducer for all its reductions.
struct Reducer {
  float* slots;  // kSlotFloats floats of shared memory
  int parity = 0;
  __device__ void sum2(float a, float b, float& ta, float& tb) {
    block_sum2(a, b, slots + parity * 2 * kWarps, ta, tb);
    parity ^= 1;
  }
  __device__ float sum(float a) {
    float ta, tb;
    sum2(a, 0.f, ta, tb);
    return ta;
  }
};

// out = A p (see the header) for every cell.
__device__ void apply_a(const float* p, float* out, const Geometry& g) {
  const int hw = g.h * g.w;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / g.w;
    const int j = idx - i * g.w;
    const float pc = p[idx];
    float gy_lo = i > 0 ? pc - p[idx - g.w] : (g.closed ? 0.f : pc);
    float gy_hi = i < g.h - 1 ? p[idx + g.w] - pc : (g.closed ? 0.f : -pc);
    float gx_lo = j > 0 ? pc - p[idx - 1] : (g.closed ? 0.f : pc);
    float gx_hi = j < g.w - 1 ? p[idx + 1] - pc : (g.closed ? 0.f : -pc);
    gy_lo *= __ldg(g.acc_y + i * g.w + j);
    gy_hi *= __ldg(g.acc_y + (i + 1) * g.w + j);
    gx_lo *= __ldg(g.acc_x + i * (g.w + 1) + j);
    gx_hi *= __ldg(g.acc_x + i * (g.w + 1) + j + 1);
    const float lap = (((gy_hi - gy_lo) + gx_hi) - gx_lo) * g.inv_dx2;
    out[idx] = __ldg(g.fluid + idx) > 0.f ? -lap : pc;
  }
}

// Removes the fluid mean of p (closed domains only). Reads p at owned
// cells, so p must be complete (barrier) before the call when another
// ownership wrote it.
__device__ void project(float* p, const Geometry& g, float n_fluid,
                        Reducer& red) {
  if (!g.closed) return;
  const int hw = g.h * g.w;
  float part = 0.f;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads)
    part += p[idx] * __ldg(g.fluid + idx);
  const float mean = red.sum(part) / n_fluid;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads)
    if (__ldg(g.fluid + idx) > 0.f) p[idx] -= mean;
}

// out (R x C, row stride C) = A (R x K) . B (K x C), optionally scaled
// elementwise by `scale` (global, row stride C). Element (i, k) of A is at
// a[i * a_row + k * a_col], element (k, j) of B at b[k * b_row + j * b_col].
// A thread computes rows i0..i0+3 of columns j and j + ceil(C/2); lanes of
// a warp take neighbouring j, so A's reads are broadcasts and B's reads
// fall in distinct banks. Ends with a barrier.
__device__ void matmul(const float* a, int a_row, int a_col, const float* b,
                       int b_row, int b_col, float* out, int R, int K, int C,
                       const float* __restrict__ scale) {
  const int half = (C + 1) / 2;
  const int groups = (R + kTileRows - 1) / kTileRows;
  for (int item = threadIdx.x; item < groups * half; item += kThreads) {
    const int j0 = item % half;
    const int i0 = (item / half) * kTileRows;
    int rows[kTileRows];
    int cols[kTileCols];
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) rows[m] = min(i0 + m, R - 1);
#pragma unroll
    for (int n = 0; n < kTileCols; ++n) cols[n] = min(j0 + n * half, C - 1);
    float acc[kTileRows][kTileCols] = {};
    for (int k = 0; k < K; ++k) {
      float av[kTileRows], bv[kTileCols];
#pragma unroll
      for (int m = 0; m < kTileRows; ++m) av[m] = a[rows[m] * a_row + k * a_col];
#pragma unroll
      for (int n = 0; n < kTileCols; ++n) bv[n] = b[k * b_row + cols[n] * b_col];
#pragma unroll
      for (int m = 0; m < kTileRows; ++m)
#pragma unroll
        for (int n = 0; n < kTileCols; ++n)
          acc[m][n] = fmaf(av[m], bv[n], acc[m][n]);
    }
#pragma unroll
    for (int m = 0; m < kTileRows; ++m) {
#pragma unroll
      for (int n = 0; n < kTileCols; ++n) {
        const int i = i0 + m;
        const int j = j0 + n * half;
        if (i < R && j < C) {
          float v = acc[m][n];
          if (scale != nullptr) v *= __ldg(scale + i * C + j);
          out[i * C + j] = v;
        }
      }
    }
  }
  __syncthreads();
}

// z = M r (see the header); `t` is scratch. r must be complete (barrier).
__device__ void apply_m(const float* r, float* z, float* t, const float* qy,
                        int qy_stride, const float* qx, int qx_stride,
                        const Geometry& g, float n_fluid, Reducer& red) {
  const int h = g.h, w = g.w;
  matmul(qy, qy_stride, 1, r, w, 1, t, h, h, w, nullptr);           // Qy r
  matmul(t, w, 1, qx, 1, qx_stride, z, h, w, w, g.inv_lam);         // (.) Qx^T * 1/lam
  matmul(qy, 1, qy_stride, z, w, 1, t, h, h, w, nullptr);           // Qy^T (.)
  matmul(t, w, 1, qx, qx_stride, 1, z, h, w, w, nullptr);           // (.) Qx
  project(z, g, n_fluid, red);
}

// Shared-memory work space of one solve: five (H, W) fields and the basis.
// Q sits at `qy` with a row stride of H+1 (Q^T is read by index; the pad
// keeps transposed reads free of bank conflicts); when H != W the second
// basis follows at `qx` with a row stride of W+1.
struct CgBuffers {
  float* x;
  float* r;  // holds the solve's `div` on entry
  float* d;
  float* z;  // also holds A d
  float* t;
  float* qy;
  float* qx;
};

// Floats of the basis region of CgBuffers.
__host__ __device__ inline int basis_floats(int h, int w) {
  return h * (h + 1) + (h == w ? 0 : w * (w + 1));
}

// Copies the (H, H) and (W, W) bases from global memory into the padded
// shared layout. No barrier: the solve's first reduction provides one.
__device__ void load_basis(const CgBuffers& cg, const float* __restrict__ q_y,
                           const float* __restrict__ q_x, int h, int w) {
  for (int idx = threadIdx.x; idx < h * h; idx += kThreads)
    cg.qy[(idx / h) * (h + 1) + idx % h] = __ldg(q_y + idx);
  if (h != w)
    for (int idx = threadIdx.x; idx < w * w; idx += kThreads)
      cg.qx[(idx / w) * (w + 1) + idx % w] = __ldg(q_x + idx);
}

// The CG loop of ops/pallas_cg.py :: pcg_core for this block's sample.
// On entry cg.r holds `div` at the cells this thread owns (the rhs is
// b = project(where(fluid, -div, 0))), and the basis is loaded when
// `precond`. x0 (global, read-only, may be null for a cold start) is the
// warm start. The best iterate is written to `best` (global or shared
// memory) whenever the residual improves; it is complete after the next
// barrier. Returns the trip count, the same in every thread.
__device__ int pcg_core(const CgBuffers& cg, const Geometry& g,
                        const float* __restrict__ x0, float* best, float tol,
                        int maxiter, bool precond, Reducer& red) {
  const int h = g.h, w = g.w, hw = h * w;
  const int qy_stride = h + 1, qx_stride = w + 1;
  float* x = cg.x;
  float* r = cg.r;
  float* d = cg.d;
  float* z = cg.z;
  float* t = cg.t;

  float part = 0.f;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const float f = __ldg(g.fluid + idx);
    part += f;
    r[idx] = f > 0.f ? -r[idx] : 0.f;  // b
    x[idx] = (x0 != nullptr && f > 0.f) ? __ldg(x0 + idx) : 0.f;
  }
  const float n_fluid = fmaxf(red.sum(part), 1.f);
  project(r, g, n_fluid, red);
  part = 0.f;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) part += r[idx] * r[idx];
  const float b2 = fmaxf(red.sum(part), 1e-30f);

  if (x0 != nullptr) {
    project(x, g, n_fluid, red);
    __syncthreads();
    apply_a(x, z, g);
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) r[idx] -= z[idx];
  }
  __syncthreads();
  if (precond) {
    apply_m(r, z, t, cg.qy, qy_stride, cg.qx, qx_stride, g, n_fluid, red);
  } else {
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) z[idx] = r[idx];
  }
  float rz_part = 0.f, rs_part = 0.f;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    d[idx] = z[idx];
    rz_part += r[idx] * z[idx];
    rs_part += r[idx] * r[idx];
    best[idx] = x[idx];
  }
  float rz, rs;
  red.sum2(rz_part, rs_part, rz, rs);
  float rs_best = rs;
  const float tol2 = tol * tol;
  int k = 0;
  while (k < maxiter && rs / b2 > tol2 && rs < 4.f * rs_best) {
    __syncthreads();  // d complete before the stencil reads neighbours
    apply_a(d, z, g);
    part = 0.f;
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) part += d[idx] * z[idx];
    const float dad = red.sum(part);
    const bool ok = dad > 0.f;
    const float alpha = ok ? rz / dad : 0.f;
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
      x[idx] += alpha * d[idx];
      r[idx] -= alpha * z[idx];
    }
    __syncthreads();
    if (precond) {
      apply_m(r, z, t, cg.qy, qy_stride, cg.qx, qx_stride, g, n_fluid, red);
    } else {
      for (int idx = threadIdx.x; idx < hw; idx += kThreads) z[idx] = r[idx];
    }
    rz_part = 0.f;
    rs_part = 0.f;
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
      rz_part += r[idx] * z[idx];
      rs_part += r[idx] * r[idx];
    }
    float rz_new, rs_new;
    red.sum2(rz_part, rs_part, rz_new, rs_new);
    const float beta = ok ? rz_new / (rz != 0.f ? rz : 1.f) : 0.f;
    const bool better = rs_new < rs_best;
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
      d[idx] = z[idx] + beta * d[idx];
      if (better) best[idx] = x[idx];
    }
    rs_best = fminf(rs_new, rs_best);
    rz = rz_new;
    rs = rs_new;
    ++k;
  }
  return k;
}

}  // namespace
