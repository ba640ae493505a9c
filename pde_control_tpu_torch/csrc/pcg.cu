// Masked, spectrally preconditioned CG pressure solve for Hopper (sm_90a).
//
// Replaces the TPU kernel pde_control_tpu/ops/pallas_cg.py ::
// pallas_pressure_solve (body _pcg_kernel -> pcg_core) and computes what
// pcg_core computes, for one (H, W) system per batch sample:
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
// Design for the card. One thread block solves one sample and runs the
// whole CG loop, so there is no host synchronisation and no launch per
// iteration; the block's threads agree on every scalar because each
// reduction hands all of them the same total (warp shuffles, then one
// shared-memory pass that every thread sums in the same order). All CG
// state lives in shared memory: x, r, d, one buffer shared by A d and z,
// one buffer for the intermediate of the basis products, and the basis Q
// (one copy when H == W; Q^T is read by index from a row stride of n+1,
// which keeps the transposed reads free of bank conflicts). Masks and
// 1/lambda are read from global memory through L1, and the best iterate is
// written straight to the output whenever the residual improves. At 64^2
// that is 98,816 bytes of shared memory per block (cuda_solve_fits in
// ops/cuda_cg.py computes the same count).
//
// What bounds it: latency. B blocks occupy B of the card's 132 SMs, and
// one iteration is a chain of about ten block-wide barriers around four
// 64x64x64 fp32 basis products, which each SM runs from shared memory at
// its load bandwidth (each thread computes a 4x2 tile of outputs, six
// shared loads per eight FMAs). Splitting a sample across a thread-block
// cluster, or packing several samples per block at large batch, are the
// next steps; this version is the plain one.
//
// The products run in fp32 FMA (the TPU kernel fed bf16 to its MXU), so
// trip counts match the fp32 'pcg' path of the port.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
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
// its previous totals.
struct Reducer {
  float* slots;
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

// out = A p (see the header) for every cell; cells are owned by thread
// idx % kThreads, the same ownership as every elementwise pass below.
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

__global__ void __launch_bounds__(kThreads)
pcg_kernel(const float* __restrict__ div, const float* __restrict__ x0,
           Geometry g, const float* __restrict__ q_y,
           const float* __restrict__ q_x, float* __restrict__ out,
           int* __restrict__ iters, float tol, int maxiter, bool precond) {
  extern __shared__ float smem[];
  const int h = g.h, w = g.w, hw = h * w;
  const bool square = h == w;
  const int qy_stride = h + 1, qx_stride = w + 1;
  float* x = smem;
  float* r = x + hw;
  float* d = r + hw;
  float* z = d + hw;  // also holds A d
  float* t = z + hw;
  float* qy = t + hw;
  float* qx = square ? qy : qy + h * qy_stride;
  float* slots = qy + h * qy_stride + (square ? 0 : w * qx_stride);
  Reducer red{slots};

  const size_t off = static_cast<size_t>(blockIdx.x) * hw;
  const float* div_b = div + off;
  float* out_b = out + off;

  if (precond) {
    for (int idx = threadIdx.x; idx < h * h; idx += kThreads)
      qy[(idx / h) * qy_stride + idx % h] = __ldg(q_y + idx);
    if (!square)
      for (int idx = threadIdx.x; idx < w * w; idx += kThreads)
        qx[(idx / w) * qx_stride + idx % w] = __ldg(q_x + idx);
  }

  float part = 0.f;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const float f = __ldg(g.fluid + idx);
    part += f;
    r[idx] = f > 0.f ? -__ldg(div_b + idx) : 0.f;  // b
    x[idx] = (x0 != nullptr && f > 0.f) ? __ldg(x0 + off + idx) : 0.f;
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
    apply_m(r, z, t, qy, qy_stride, qx, qx_stride, g, n_fluid, red);
  } else {
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) z[idx] = r[idx];
  }
  float rz_part = 0.f, rs_part = 0.f;
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    d[idx] = z[idx];
    rz_part += r[idx] * z[idx];
    rs_part += r[idx] * r[idx];
    out_b[idx] = x[idx];
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
      apply_m(r, z, t, qy, qy_stride, qx, qx_stride, g, n_fluid, red);
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
      if (better) out_b[idx] = x[idx];
    }
    rs_best = fminf(rs_new, rs_best);
    rz = rz_new;
    rs = rs_new;
    ++k;
  }
  if (threadIdx.x == 0) iters[blockIdx.x] = k;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; ops/cuda_cg.py ::
// cuda_solve_fits mirrors this count.
size_t pcg_shared_bytes(int h, int w) {
  size_t floats = 5 * static_cast<size_t>(h) * w + static_cast<size_t>(h) * (h + 1);
  if (h != w) floats += static_cast<size_t>(w) * (w + 1);
  floats += 4 * kWarps;
  return floats * sizeof(float);
}

// Solves `batch` systems on `stream`. x0 may be null (cold start: x0 is
// never read). Returns the cudaError_t of the launch.
int pcg_solve_f32(const float* div, const float* x0, const float* acc_y,
                  const float* acc_x, const float* fluid, const float* q_y,
                  const float* q_x, const float* inv_lam, float* out,
                  int* iters, int batch, int h, int w, float dx, int closed,
                  float tol, int maxiter, int precond, void* stream) {
  const size_t bytes = pcg_shared_bytes(h, w);
  cudaError_t err = cudaFuncSetAttribute(
      pcg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{acc_y, acc_x, fluid, inv_lam, h, w, 1.f / (dx * dx), closed != 0};
  pcg_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      div, x0, g, q_y, q_x, out, iters, tol, maxiter, precond != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
