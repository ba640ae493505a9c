// Masked, spectrally preconditioned CG pressure solve for Hopper (sm_90a).
//
// Replaces the TPU kernel pde_control_tpu/ops/pallas_cg.py ::
// pallas_pressure_solve (body _pcg_kernel -> pcg_core) and computes what
// pcg_core computes, for one (H, W) system per batch sample: the CG loop of
// pcg_cluster.cuh, whose header states the operator, the preconditioner,
// the warm start and the exit rule.
//
// Design for the card. One thread-block cluster of C blocks solves one
// sample (ops/cuda_cg.py :: solve_plan picks C, up to 16, to fill the
// card), so a batch of 8 runs on 8C SMs and not on 8. Rank c owns a band
// of rows (pcg_cluster.cuh :: Band) and holds the basis, three whole-field
// copies (the residual, the scaled spectrum, A d) and its band's iterates
// in shared memory (solve_layout below; 92,160 bytes at 64^2 and C = 8;
// ops/cuda_cg.py :: solve_shared_bytes counts the same). On a grid where
// that fits a block under no cluster size (from 112^2; 314,624 bytes at
// 128^2 and C = 8), every plan takes the core's large layout,
// pcg_cluster_kernel<512, true>: the basis read from L2 and r exchanged by
// bands, 183,040 bytes at 128^2 and C = 8. Where the large layout fits a
// block under no cluster size either (from 154^2 on squares), every plan
// takes the banded layout, pcg_banded_kernel<512>: no whole field in
// shared memory, r and the scaled spectrum whole in a scratch in global
// memory that the caller allocates (B x 2 x H x W floats), 185,088 bytes at
// 256^2 and C = 8 (pcg_cluster.cuh's header for both). grid_layout picks
// the layout. The whole loop, its per-sample exit included, runs on the
// card: no host round trip and no launch per trip. The best iterate's band
// goes straight to the output whenever the residual improves.
//
// What bounds it: latency. A trip is four fp32 basis products of 1/C of
// the work and the stencil around three cluster barriers (four in the
// large and banded layouts); at 64^2 it is far below the card's operation
// and byte rates (PERF.md). In the banded layout the products' reads of
// the basis and of the scratch from L2 come on top.
//
// The products run in fp32 FMA (the TPU kernel fed bf16 to its MXU), so
// trip counts match the fp32 'pcg' path of the port.

#include "pcg_cluster.cuh"

namespace {

// Offsets (floats) into one rank's shared memory: the reduction area, then
// the solve's buffers for bands of at most ceil(H / C) rows.
struct SolveLayout {
  CgOffsets cg;
  int total;
};

__host__ __device__ inline SolveLayout layout_of(int h, int w, int C, int T,
                                                 int layout) {
  SolveLayout l;
  int o = align4(kRedFloats);
  l.cg = take_cg(o, h, w, (h + C - 1) / C, T, layout);
  l.total = o;
  return l;
}

// The layout in which K1 solves an H x W grid (pcg_cluster.cuh ::
// layout_where_fits on its bytes): the small one where it fits a block
// under some cluster size, else the large one where that fits, else the
// banded one.
__host__ __device__ inline int grid_layout(int h, int w, int T) {
  return layout_where_fits(h, [=](int C, int layout) {
    return static_cast<size_t>(layout_of(h, w, C, T, layout).total) *
           sizeof(float);
  });
}

__host__ __device__ inline SolveLayout solve_layout(int h, int w, int C,
                                                    int T) {
  return layout_of(h, w, C, T, grid_layout(h, w, T));
}

// K1 for one sample on a cluster of C blocks (the launch's cluster size),
// in the small layout or (kLarge) the large one. q_xt (Qx^T) is read only
// by the large layout; `scratch` by neither (it has pcg_banded_kernel's
// signature).
template <int kT, bool kLarge>
__global__ void __launch_bounds__(kT, 1)
pcg_cluster_kernel(const float* __restrict__ div, const float* __restrict__ x0,
                   Geometry g, const float* __restrict__ q_y,
                   const float* __restrict__ q_x,
                   const float* __restrict__ q_xt, float* scratch,
                   float* __restrict__ out, int* __restrict__ iters, float tol,
                   int maxiter, bool precond) {
  extern __shared__ __align__(16) float smem_pcg[];
  float* smem = smem_pcg;
  auto cluster = cgrp::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int h = g.h, w = g.w;
  const Band bd(static_cast<int>(cluster.block_rank()), C, h, w);
  const size_t off = static_cast<size_t>(blockIdx.x / C) * h * w;
  ClusterReducer<kT> red{reinterpret_cast<float4*>(smem),
                         reinterpret_cast<float4*>(smem + 8 * kMaxCluster)};
  ClusterCg cg = cluster_cg(
      smem, layout_of(h, w, C, kT, kLarge ? kLayoutLarge : kLayoutSmall).cg, h,
      w);
  if constexpr (kLarge) {
    cg.gqy = q_y;
    cg.gqx = q_x;
    cg.gqxt = q_xt;
  } else {
    if (precond) load_basis_t<kT>(cg, q_y, q_x, h, w);
  }
  for (int t = threadIdx.x; t < bd.rows() * w; t += kT)
    cg.g1[bd.a * w + t] = __ldg(div + off + bd.a * w + t);
  const int k = pcg_cluster<kT, false, kLarge>(
      cg, g, bd, x0 == nullptr ? nullptr : x0 + off, out + off + bd.a * w, tol,
      maxiter, precond, red);
  if (bd.rank == 0 && threadIdx.x == 0) iters[blockIdx.x / C] = k;
}

// K1 in the banded layout (pcg_cluster.cuh's header): the basis (q_y, q_x,
// q_xt) read from L2, `scratch` (2 H W floats a sample: r, then the scaled
// spectrum) holding the two whole fields. A kernel of its own and not a
// third instantiation of pcg_cluster_kernel: so each keeps within 128
// registers without spills.
template <int kT>
__global__ void __launch_bounds__(kT, 1)
pcg_banded_kernel(const float* __restrict__ div, const float* __restrict__ x0,
                  Geometry g, const float* __restrict__ q_y,
                  const float* __restrict__ q_x,
                  const float* __restrict__ q_xt, float* scratch,
                  float* __restrict__ out, int* __restrict__ iters, float tol,
                  int maxiter, bool precond) {
  extern __shared__ __align__(16) float smem_pcg[];
  float* smem = smem_pcg;
  auto cluster = cgrp::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int h = g.h, w = g.w;
  const Band bd(static_cast<int>(cluster.block_rank()), C, h, w);
  const size_t off = static_cast<size_t>(blockIdx.x / C) * h * w;
  ClusterReducer<kT> red{reinterpret_cast<float4*>(smem),
                         reinterpret_cast<float4*>(smem + 8 * kMaxCluster)};
  ClusterCg cg =
      cluster_cg(smem, layout_of(h, w, C, kT, kLayoutBanded).cg, h, w);
  cg.gqy = q_y;
  cg.gqx = q_x;
  cg.gqxt = q_xt;
  cg.g1 = scratch + 2 * off;
  cg.g2 = cg.g1 + h * w;
  for (int t = threadIdx.x; t < bd.rows() * w; t += kT)
    cg.rb[t] = __ldg(div + off + bd.a * w + t);
  const int k = pcg_cluster<kT, false, kLayoutBanded>(
      cg, g, bd, x0 == nullptr ? nullptr : x0 + off, out + off + bd.a * w, tol,
      maxiter, precond, red);
  if (bd.rank == 0 && threadIdx.x == 0) iters[blockIdx.x / C] = k;
}

using PcgKernel = void (*)(const float*, const float*, Geometry, const float*,
                           const float*, const float*, float*, float*, int*,
                           float, int, bool);

// The kernel of a plan: 512 threads a block, the grid's layout.
PcgKernel pcg_kernel(int h, int w, int threads) {
  switch (grid_layout(h, w, threads)) {
    case kLayoutSmall:
      return pcg_cluster_kernel<kClusterThreads, false>;
    case kLayoutLarge:
      return pcg_cluster_kernel<kClusterThreads, true>;
    default:
      return pcg_banded_kernel<kClusterThreads>;
  }
}

size_t solve_bytes(int h, int w, int cluster, int threads) {
  return static_cast<size_t>(solve_layout(h, w, cluster, threads).total) *
         sizeof(float);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one rank of K1 needs (solve_layout);
// ops/cuda_cg.py :: solve_shared_bytes mirrors this count.
size_t pcg_shared_bytes(int h, int w, int cluster, int threads) {
  return solve_bytes(h, w, cluster, threads);
}

// The layout in which K1 solves an H x W grid: 0 small, 1 large, 2 banded
// (grid_layout; ops/cuda_cg.py :: layout mirrors this).
int pcg_layout(int h, int w, int threads) {
  return grid_layout(h, w, threads);
}

// How many clusters of K1 under this plan the card can hold at once
// (cudaOccupancyMaxActiveClusters), or minus the cudaError_t of the query
// or of a plan the launcher would refuse.
int pcg_max_clusters(int h, int w, int cluster, int threads) {
  return max_active_clusters(pcg_kernel(h, w, threads), h, cluster, threads,
                             solve_bytes(h, w, cluster, threads));
}

// Solves `batch` systems on `stream`, one cluster of `cluster` blocks of
// `threads` threads per system. x0 may be null (cold start: x0 is never
// read). q_y, q_x and q_xt are Qy, Qx and Qx^T, unpadded. `scratch` holds
// batch x 2 x H x W floats for the banded layout (pcg_layout 2; it may be
// null in the others). Returns the cudaError_t of the launch:
// cudaErrorInvalidValue, with nothing launched, for a plan the kernel
// cannot run (a cluster size other than 1, 2, 4, 8, 16 or above H, a
// thread count other than 512, or more shared memory than a block may
// have) or a banded grid without a scratch.
int pcg_solve_f32(const float* div, const float* x0, const float* acc_y,
                  const float* acc_x, const float* fluid, const float* q_y,
                  const float* q_x, const float* q_xt, const float* inv_lam,
                  float* scratch, float* out, int* iters, int batch, int h,
                  int w, float dx, int closed, float tol, int maxiter,
                  int precond, int cluster, int threads, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (scratch == nullptr && grid_layout(h, w, threads) == kLayoutBanded)
    return static_cast<int>(cudaErrorInvalidValue);
  const PcgKernel kernel = pcg_kernel(h, w, threads);
  cudaError_t err = cluster_config(kernel, batch, h, cluster, threads,
                                   solve_bytes(h, w, cluster, threads), stream,
                                   cfg, attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  Geometry g{acc_y, acc_x, fluid, inv_lam, h, w, 1.f / (dx * dx), closed != 0};
  err = cudaLaunchKernelEx(&cfg, kernel, div, x0, g, q_y, q_x, q_xt, scratch,
                           out, iters, tol, maxiter, precond != 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
