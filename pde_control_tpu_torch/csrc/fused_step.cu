// The whole 2D fluid step as one kernel per direction, for Hopper (sm_90a).
//
// Replaces the TPU kernels pde_control_tpu/ops/pallas_fluid.py ::
// _make_fused_step._forward (body _fwd_kernel) and ._backward (body
// _bwd_kernel), and computes what they compute, one batch sample per
// thread block:
//
//   fused_fwd_kernel (K2): shift advection of the density and of both MAC
//     velocity components (the clipped, edge-clamped (2k+2)^2 hat window of
//     _advect_window), inflow, force, buoyancy, the wall and obstacle
//     masks, the divergence, the warm or cold PCG pressure solve
//     (pcg_core.cuh), and the closed-wall pressure-gradient correction;
//   fused_bwd_kernel (K3): the hand-written VJP: a cold transpose solve on
//     the pressure cotangent, the stencil and face/centre adjoints, and the
//     three window adjoints with JAX's tie rules (d|x|/dx = +1 at x = 0,
//     the hat's and the clip's derivatives 0.5 at their kinks). The
//     displacements are recomputed from the step's inputs; nothing else is
//     saved between the directions.
//
// Design for the card. All intermediates live in shared memory: seven
// field-sized slots and the preconditioner's basis (133,376 bytes at 64^2,
// fused_shared_bytes below; ops/cuda_fluid.py :: shared_bytes counts the
// same). The step's inputs are read-only for the whole launch and are read
// from global memory through L1 (__ldg), with clamped indices standing in
// for the edge padding; everything the kernel computes itself (the
// divergence, the masked velocity, the pressure, the cotangents) is read
// with plain loads after a barrier, never through the read-only path. The
// window adjoint's field cotangent is a gather: each thread owns its target
// cells and sums, in a fixed order, every window term whose clamped source
// is that cell, which folds the edge padding in as well. No atomics, so the
// result is deterministic. Window terms whose hat weight is exactly zero
// are skipped: for finite fields they add exact zeros in the plain version,
// and at most 2 of the 2k+2 offsets per axis carry weight (3 for the hat's
// derivative at an integer displacement).
//
// Non-finite values. The plain version multiplies every tap, so a NaN or
// an infinity anywhere in a window (0 * inf is NaN) makes the window's
// result NaN. A sample whose inputs or window cotangents hold a non-finite
// value therefore sums every tap (`dense`, one block-wide vote), and the
// clip and the hat pass NaN through as torch.clamp does. The non-finite
// cells of the outputs are then the plain version's, so a diverged state
// still gives non-finite gradients and the training step skips its update.
//
// What bounds it: latency, as for the standalone solve. B blocks occupy B
// of the card's 132 SMs, and the solve is a chain of about ten barriers
// per CG trip around four 64x64x64 fp32 basis products; the advection and
// its adjoint add a dozen barrier-separated passes. The design keeps all of
// it in one launch per direction with no host round trip; splitting a
// sample across a thread-block cluster is the next step. The shared memory
// allows one block per SM anyway, and the launch bounds say so, which
// leaves each thread up to 128 registers (with the thread bound alone,
// ptxas held K3 to 64 and spilled).
//
// Floating-point contraction. nvcc contracts a*b+c into an FMA by default,
// which rounds once instead of twice. A displacement that moved by one
// rounding could cross a tie of the hat or the clip (0, +-1, +-k) that the
// plain version sits on, so every displacement is formed with __fmul_rn,
// which is never contracted: s * v, s * 0.5 (a + b) and
// s * 0.5 (0.5 (a + b) + 0.5 (c + d)) are the plain version's values bit
// for bit, and so are the hat weights and the tie tests. FMAs do form in
// the sums that follow; they move results by rounding only.

#include "pcg_core.cuh"

namespace {

constexpr int kSlots = 7;  // field-sized shared slots before the basis

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

// Whether any of the n values at p (global, read-only) is not finite, over
// the entries this thread owns.
__device__ bool any_nonfinite(const float* p, int n) {
  bool bad = false;
  for (int idx = threadIdx.x; idx < n; idx += kThreads) bad |= !isfinite(__ldg(p + idx));
  return bad;
}

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
// cotangent g: hat-derivative windows chained through the clip.
__device__ void window_disp_T(const float* f, int m, int n, int i, int j,
                              float g, float dy, float dx, int k, bool dense,
                              float& g_dy, float& g_dx) {
  const float kf = static_cast<float>(k);
  const float dyc = clip(dy, kf), dxc = clip(dx, kf);
  float s_dy = 0.f, s_dx = 0.f;
  for (int oy = -k; oy <= k + 1; ++oy) {
    const float wy = hat(dyc - oy), wyp = hat_grad(dyc - oy);
    if (wy == 0.f && wyp == 0.f && !dense) continue;
    const float* row = f + clampi(i + oy, 0, m - 1) * n;
    float ady = 0.f, adx = 0.f;
    for (int ox = -k; ox <= k + 1; ++ox) {
      const float wx = hat(dxc - ox), wxp = hat_grad(dxc - ox);
      if (wx == 0.f && wxp == 0.f && !dense) continue;
      const float val = __ldg(row + clampi(j + ox, 0, n - 1));
      ady += val * (g * wx);
      adx += val * (g * wxp);
    }
    s_dy += ady * wyp;
    s_dx += adx * wy;
  }
  g_dy = s_dy * clip_grad(dy, kf);
  g_dx = s_dx * clip_grad(dx, kf);
}

// The field cotangent of _advect_window_T at source cell (r, c) of an
// m x n field: every window term (cell (i, j), offset (oy, ox)) whose
// clamped source clamp(i+oy), clamp(j+ox) is (r, c) contributes
// g * hat(dxc - ox) * hat(dyc - oy). g and the clipped displacements are
// per-cell shared arrays, complete before the call. For an interior row
// the only source row is r - oy; the edge rows also collect the rows that
// the edge padding clamps onto them (the fold of _edge_pad2_T).
__device__ float window_field_T(const float* g, const float* dyc,
                                const float* dxc, int m, int n, int r, int c,
                                int k, bool dense) {
  float acc = 0.f;
  for (int oy = -k; oy <= k + 1; ++oy) {
    const int ilo = max(r == 0 ? 0 : r - oy, 0);
    const int ihi = min(r == m - 1 ? m - 1 : r - oy, m - 1);
    for (int i = ilo; i <= ihi; ++i) {
      for (int ox = -k; ox <= k + 1; ++ox) {
        const int jlo = max(c == 0 ? 0 : c - ox, 0);
        const int jhi = min(c == n - 1 ? n - 1 : c - ox, n - 1);
        for (int j = jlo; j <= jhi; ++j) {
          const int idx = i * n + j;
          const float wy = hat(dyc[idx] - oy);
          if (wy == 0.f && !dense) continue;
          const float wx = hat(dxc[idx] - ox);
          if (wx == 0.f && !dense) continue;
          acc += (g[idx] * wx) * wy;
        }
      }
    }
  }
  return acc;
}

// Adjoints of _to_y_faces / _to_x_faces at cell (i, j): a (H+1, W) or
// (H, W+1) face field g (shared, complete) back onto the (H, W) cells.
__device__ __forceinline__ float to_y_faces_T(const float* g, int i, int j,
                                              int h, int w) {
  float v = 0.5f * (g[i * w + j] + g[(i + 1) * w + j]);
  if (i == 0) v += 0.5f * g[j];
  if (i == h - 1) v += 0.5f * g[h * w + j];
  return v;
}

__device__ __forceinline__ float to_x_faces_T(const float* g, int i, int j,
                                              int w) {
  const float* row = g + i * (w + 1);
  float v = 0.5f * (row[j] + row[j + 1]);
  if (j == 0) v += 0.5f * row[0];
  if (j == w - 1) v += 0.5f * row[w];
  return v;
}

// Floats of one field-sized slot: the larger face grid.
__host__ __device__ inline int slot_floats(int h, int w) {
  return (h + 1) * w > h * (w + 1) ? (h + 1) * w : h * (w + 1);
}

struct Layout {
  float* slot[kSlots + 1];  // slot[kSlots] starts the basis region
  CgBuffers cg;
  float* reduce;
};

// Both kernels: slots 0-4 are the CG's x, r, d, z, t; slots 5 and 6 and the
// basis region are the kernel's own. The basis region holds at least one
// slot, which K3 takes as an eighth slot once the solve is done.
__device__ Layout make_layout(float* smem, int h, int w) {
  Layout l;
  const int len = slot_floats(h, w);
  for (int i = 0; i <= kSlots; ++i) l.slot[i] = smem + i * len;
  l.cg = CgBuffers{l.slot[0], l.slot[1], l.slot[2], l.slot[3], l.slot[4],
                   l.slot[kSlots],
                   h == w ? l.slot[kSlots] : l.slot[kSlots] + h * (h + 1)};
  l.reduce = l.slot[kSlots] + basis_floats(h, w);
  return l;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_fwd_kernel(Step st, Geometry g, const float* __restrict__ q_y,
                 const float* __restrict__ q_x, const float* __restrict__ fy,
                 const float* __restrict__ fx,
                 const float* __restrict__ inflow,
                 const float* __restrict__ x0, float* vy4, float* vx4,
                 float* rho1_out, float* p_out, int* iters, float tol,
                 int maxiter) {
  extern __shared__ float smem[];
  const int h = g.h, w = g.w, hw = h * w;
  const int ny = (h + 1) * w, nx = h * (w + 1);
  const size_t b = blockIdx.x;
  st.vy += b * ny;
  st.vx += b * nx;
  st.rho += b * hw;
  Layout l = make_layout(smem, h, w);
  Reducer red{l.reduce};
  float* rho1 = l.slot[0];  // until the solve claims it as x
  float* vy3 = l.slot[5];
  float* vx3 = l.slot[6];
  float* p = p_out + b * hw;
  load_basis(l.cg, q_y, q_x, h, w);
  const bool dense = __syncthreads_or(any_nonfinite(st.vy, ny) ||
                                      any_nonfinite(st.vx, nx) ||
                                      any_nonfinite(st.rho, hw));

  // Phase A (_phase_a): density advected by the centred velocity.
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx;
    st.disp_rho(i, j, dy, dx);
    float v = window(st.rho, h, w, i, j, dy, dx, st.k, dense);
    if (inflow != nullptr) v += st.dt * __ldg(inflow + b * hw + idx);
    rho1[idx] = v;
    rho1_out[b * hw + idx] = v;
  }
  __syncthreads();
  // Self-advection of each velocity component, force, buoyancy, masks.
  for (int idx = threadIdx.x; idx < ny; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx;
    st.disp_vy(i, j, dy, dx);
    float v = window(st.vy, h + 1, w, i, j, dy, dx, st.k, dense);
    if (fy != nullptr) v += st.dt * __ldg(fy + b * ny + idx);
    if (st.buoy)
      v += st.dt_buoy *
           (0.5f * (rho1[max(i - 1, 0) * w + j] + rho1[min(i, h - 1) * w + j]));
    vy3[idx] = v * __ldg(g.acc_y + idx);
  }
  for (int idx = threadIdx.x; idx < nx; idx += kThreads) {
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    float dy, dx;
    st.disp_vx(i, j, dy, dx);
    float v = window(st.vx, h, w + 1, i, j, dy, dx, st.k, dense);
    if (fx != nullptr) v += st.dt * __ldg(fx + b * nx + idx);
    vx3[idx] = v * __ldg(g.acc_x + idx);
  }
  __syncthreads();
  // The divergence is the solve's `div`, in r.
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    const float* row = vx3 + i * (w + 1) + j;
    l.cg.r[idx] =
        ((vy3[idx + w] - vy3[idx]) + (row[1] - row[0])) / st.dx;
  }
  const int trips = pcg_core(l.cg, g, x0 == nullptr ? nullptr : x0 + b * hw,
                             p, tol, maxiter, true, red);
  __syncthreads();  // p complete
  // _pgrad_closed: v4 = v3 - acc * grad p, zero on the walls.
  for (int idx = threadIdx.x; idx < ny; idx += kThreads) {
    const int i = idx / w;
    const float gy = (i > 0 && i < h) ? (p[idx] - p[idx - w]) / st.dx : 0.f;
    vy4[b * ny + idx] = vy3[idx] - gy * __ldg(g.acc_y + idx);
  }
  for (int idx = threadIdx.x; idx < nx; idx += kThreads) {
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    const float gx = (j > 0 && j < w)
                         ? (p[i * w + j] - p[i * w + j - 1]) / st.dx
                         : 0.f;
    vx4[b * nx + idx] = vx3[idx] - gx * __ldg(g.acc_x + idx);
  }
  if (threadIdx.x == 0) iters[b] = trips;
}

__global__ void __launch_bounds__(kThreads, 1)
fused_bwd_kernel(Step st, Geometry g, const float* __restrict__ q_y,
                 const float* __restrict__ q_x,
                 const float* __restrict__ g_vy4,
                 const float* __restrict__ g_vx4,
                 const float* __restrict__ g_rho1,
                 const float* __restrict__ g_p, float* g_vy, float* g_vx,
                 float* g_rho, float* g_fy, float* g_fx, float* g_inflow,
                 int* iters, float tol, int maxiter) {
  extern __shared__ float smem[];
  const int h = g.h, w = g.w, hw = h * w;
  const int ny = (h + 1) * w, nx = h * (w + 1);
  const size_t b = blockIdx.x;
  st.vy += b * ny;
  st.vx += b * nx;
  st.rho += b * hw;
  g_vy4 += b * ny;
  g_vx4 += b * nx;
  g_rho1 += b * hw;
  g_p += b * hw;
  g_vy += b * ny;
  g_vx += b * nx;
  g_rho += b * hw;
  Layout l = make_layout(smem, h, w);
  Reducer red{l.reduce};
  // Slots after the solve (K3's eighth slot is the basis region):
  float* xt = l.slot[5];    // the transpose solution, then g_div
  float* gvy2 = l.slot[0];  // cotangent of the forced, unmasked velocity
  float* gvx2 = l.slot[1];
  float* grho = l.slot[2];  // total cotangent of the advected density
  float* dyc = l.slot[3];   // clipped displacements of the current window
  float* dxc = l.slot[4];
  float* tmp = l.slot[5];   // s * the cross-component displacement cotangent
  float* gvyc = l.slot[6];  // cotangents of the centred velocity
  float* gvxc = l.slot[7];
  load_basis(l.cg, q_y, q_x, h, w);
  // Every window sums all taps when an input is not finite, and, from the
  // field cotangents on, when a window cotangent is not.
  bool dense = __syncthreads_or(any_nonfinite(st.vy, ny) ||
                                any_nonfinite(st.vx, nx) ||
                                any_nonfinite(st.rho, hw));
  bool bad = false;  // a non-finite window cotangent in this thread's cells

  // Projection backward: cot_p = g_p + div(acc * g_v4); the transpose solve
  // runs cold on -cot_p, so its `div` is -cot_p.
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    const int fx_ = i * (w + 1) + j;
    const float dvy = g_vy4[idx + w] * __ldg(g.acc_y + idx + w) -
                      g_vy4[idx] * __ldg(g.acc_y + idx);
    const float dvx = g_vx4[fx_ + 1] * __ldg(g.acc_x + fx_ + 1) -
                      g_vx4[fx_] * __ldg(g.acc_x + fx_);
    l.cg.r[idx] = -(g_p[idx] + (dvy + dvx) / st.dx);
  }
  const int trips = pcg_core(l.cg, g, nullptr, xt, tol, maxiter, true, red);
  __syncthreads();  // xt complete
  // The closed domain's mean projection of xt, then g_div = -M(P(xt)).
  float mean = 0.f;
  if (g.closed) {
    float part_x = 0.f, part_f = 0.f;
    for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
      const float f = __ldg(g.fluid + idx);
      part_x += xt[idx] * f;
      part_f += f;
    }
    float sum_x, sum_f;
    red.sum2(part_x, part_f, sum_x, sum_f);
    mean = sum_x / fmaxf(sum_f, 1.f);
  }
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const bool fluid = __ldg(g.fluid + idx) > 0.f;
    const float v = g.closed && fluid ? xt[idx] - mean : xt[idx];
    xt[idx] = fluid ? -v : 0.f;
  }
  __syncthreads();
  // _divergence_T, the masks, and the force cotangents.
  for (int idx = threadIdx.x; idx < ny; idx += kThreads) {
    const int i = idx / w;
    const float lo = i > 0 ? xt[idx - w] : 0.f;
    const float hi = i < h ? xt[idx] : 0.f;
    const float v = (g_vy4[idx] + (lo - hi) / st.dx) * __ldg(g.acc_y + idx);
    gvy2[idx] = v;
    bad |= !isfinite(v);
    if (g_fy != nullptr) g_fy[b * ny + idx] = st.dt * v;
  }
  for (int idx = threadIdx.x; idx < nx; idx += kThreads) {
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    const float lo = j > 0 ? xt[i * w + j - 1] : 0.f;
    const float hi = j < w ? xt[i * w + j] : 0.f;
    const float v = (g_vx4[idx] + (lo - hi) / st.dx) * __ldg(g.acc_x + idx);
    gvx2[idx] = v;
    bad |= !isfinite(v);
    if (g_fx != nullptr) g_fx[b * nx + idx] = st.dt * v;
  }
  __syncthreads();
  // Buoyancy backward onto the advected density, and the inflow cotangent;
  // then the density window's displacement cotangents, which start the
  // centred-velocity cotangents.
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    float v = g_rho1[idx];
    if (st.buoy) v += st.dt_buoy * to_y_faces_T(gvy2, i, j, h, w);
    grho[idx] = v;
    bad |= !isfinite(v);
    if (g_inflow != nullptr) g_inflow[b * hw + idx] = st.dt * v;
    float dy, dx;
    st.disp_rho(i, j, dy, dx);
    const float kf = static_cast<float>(st.k);
    dyc[idx] = clip(dy, kf);
    dxc[idx] = clip(dx, kf);
    float gdy, gdx;
    window_disp_T(st.rho, h, w, i, j, v, dy, dx, st.k, dense, gdy, gdx);
    gvyc[idx] = st.s * gdy;
    gvxc[idx] = st.s * gdx;
  }
  dense = __syncthreads_or(dense || bad);
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    g_rho[idx] = window_field_T(grho, dyc, dxc, h, w, i, j, st.k, dense);
  }
  __syncthreads();
  // vy self-advection: vy1 = W(vy; s vy, s Y(vx_c)).
  for (int idx = threadIdx.x; idx < ny; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    float dy, dx;
    st.disp_vy(i, j, dy, dx);
    const float kf = static_cast<float>(st.k);
    dyc[idx] = clip(dy, kf);
    dxc[idx] = clip(dx, kf);
    float gdy, gdx;
    window_disp_T(st.vy, h + 1, w, i, j, gvy2[idx], dy, dx, st.k, dense, gdy,
                  gdx);
    g_vy[idx] = st.s * gdy;
    tmp[idx] = st.s * gdx;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    gvxc[idx] += to_y_faces_T(tmp, i, j, h, w);
  }
  for (int idx = threadIdx.x; idx < ny; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    g_vy[idx] =
        window_field_T(gvy2, dyc, dxc, h + 1, w, i, j, st.k, dense) + g_vy[idx];
  }
  __syncthreads();
  // vx self-advection: vx1 = W(vx; s X(vy_c), s vx).
  for (int idx = threadIdx.x; idx < nx; idx += kThreads) {
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    float dy, dx;
    st.disp_vx(i, j, dy, dx);
    const float kf = static_cast<float>(st.k);
    dyc[idx] = clip(dy, kf);
    dxc[idx] = clip(dx, kf);
    float gdy, gdx;
    window_disp_T(st.vx, h, w + 1, i, j, gvx2[idx], dy, dx, st.k, dense, gdy,
                  gdx);
    g_vx[idx] = st.s * gdx;
    tmp[idx] = st.s * gdy;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < hw; idx += kThreads) {
    const int i = idx / w, j = idx - (idx / w) * w;
    gvyc[idx] += to_x_faces_T(tmp, i, j, w);
  }
  for (int idx = threadIdx.x; idx < nx; idx += kThreads) {
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    g_vx[idx] =
        window_field_T(gvx2, dyc, dxc, h, w + 1, i, j, st.k, dense) + g_vx[idx];
  }
  __syncthreads();
  // Centres backward (_centers_y_T, _centers_x_T).
  for (int idx = threadIdx.x; idx < ny; idx += kThreads) {
    const int i = idx / w;
    g_vy[idx] += 0.5f * ((i > 0 ? gvyc[idx - w] : 0.f) + (i < h ? gvyc[idx] : 0.f));
  }
  for (int idx = threadIdx.x; idx < nx; idx += kThreads) {
    const int i = idx / (w + 1), j = idx - (idx / (w + 1)) * (w + 1);
    const float* row = gvxc + i * w;
    g_vx[idx] += 0.5f * ((j > 0 ? row[j - 1] : 0.f) + (j < w ? row[j] : 0.f));
  }
  if (threadIdx.x == 0) iters[b] = trips;
}

Step make_step(const float* vy, const float* vx, const float* rho, int h,
               int w, float dx, float s, float dt, float dt_buoy, int buoy,
               int k) {
  return Step{vy, vx, rho, h, w, s, dt, dx, dt_buoy, buoy != 0, k};
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block of either kernel needs: seven
// field-sized slots, the basis region and the reduction slots.
// ops/cuda_fluid.py :: shared_bytes mirrors this count.
size_t fused_shared_bytes(int h, int w) {
  const size_t floats = static_cast<size_t>(kSlots) * slot_floats(h, w) +
                        basis_floats(h, w) + kSlotFloats;
  return floats * sizeof(float);
}

// K2 for `batch` samples on `stream`. fy/fx, inflow and x0 may be null
// (no force, no inflow, cold solve). Returns the cudaError_t of the launch.
int fused_step_fwd_f32(const float* vy, const float* vx, const float* rho,
                       const float* fy, const float* fx, const float* inflow,
                       const float* x0, const float* acc_y, const float* acc_x,
                       const float* fluid, const float* q_y, const float* q_x,
                       const float* inv_lam, float* vy4, float* vx4,
                       float* rho1, float* p, int* iters, int batch, int h,
                       int w, float dx, float s, float dt, float dt_buoy,
                       int buoy, int k, int closed, float tol, int maxiter,
                       void* stream) {
  const size_t bytes = fused_shared_bytes(h, w);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{acc_y, acc_x, fluid, inv_lam, h, w, 1.f / (dx * dx), closed != 0};
  fused_fwd_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      make_step(vy, vx, rho, h, w, dx, s, dt, dt_buoy, buoy, k), g, q_y, q_x,
      fy, fx, inflow, x0, vy4, vx4, rho1, p, iters, tol, maxiter);
  return static_cast<int>(cudaGetLastError());
}

// K3 for `batch` samples on `stream`. g_fy/g_fx and g_inflow may be null
// (not wanted). Returns the cudaError_t of the launch.
int fused_step_bwd_f32(const float* vy, const float* vx, const float* rho,
                       const float* g_vy4, const float* g_vx4,
                       const float* g_rho1, const float* g_p,
                       const float* acc_y, const float* acc_x,
                       const float* fluid, const float* q_y, const float* q_x,
                       const float* inv_lam, float* g_vy, float* g_vx,
                       float* g_rho, float* g_fy, float* g_fx, float* g_inflow,
                       int* iters, int batch, int h, int w, float dx, float s,
                       float dt, float dt_buoy, int buoy, int k, int closed,
                       float tol, int maxiter, void* stream) {
  const size_t bytes = fused_shared_bytes(h, w);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{acc_y, acc_x, fluid, inv_lam, h, w, 1.f / (dx * dx), closed != 0};
  fused_bwd_kernel<<<batch, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      make_step(vy, vx, rho, h, w, dx, s, dt, dt_buoy, buoy, k), g, q_y, q_x,
      g_vy4, g_vx4, g_rho1, g_p, g_vy, g_vx, g_rho, g_fy, g_fx, g_inflow,
      iters, tol, maxiter);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
