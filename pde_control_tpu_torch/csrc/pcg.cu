// Masked, spectrally preconditioned CG pressure solve for Hopper (sm_90a).
//
// Replaces the TPU kernel pde_control_tpu/ops/pallas_cg.py ::
// pallas_pressure_solve (body _pcg_kernel -> pcg_core) and computes what
// pcg_core computes, for one (H, W) system per batch sample. The loop itself
// is pcg_core.cuh :: pcg_core, which the fused fluid-step kernels share;
// its header states the operator, the preconditioner and the exit rule.
//
// Design for the card. One thread block solves one sample and runs the
// whole CG loop, so there is no host synchronisation and no launch per
// iteration. All CG state lives in shared memory: x, r, d, one buffer
// shared by A d and z, one buffer for the intermediate of the basis
// products, and the basis Q (one copy when H == W; Q^T is read by index
// from a row stride of n+1, which keeps the transposed reads free of bank
// conflicts). Masks and 1/lambda are read from global memory through L1,
// and the best iterate is written straight to the output whenever the
// residual improves. At 64^2 that is 98,816 bytes of shared memory per
// block (cuda_solve_fits in ops/cuda_cg.py computes the same count).
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

#include "pcg_core.cuh"

namespace {

__global__ void __launch_bounds__(kThreads)
pcg_kernel(const float* __restrict__ div, const float* __restrict__ x0,
           Geometry g, const float* __restrict__ q_y,
           const float* __restrict__ q_x, float* __restrict__ out,
           int* __restrict__ iters, float tol, int maxiter, bool precond) {
  extern __shared__ float smem[];
  const int h = g.h, w = g.w, hw = h * w;
  CgBuffers cg;
  cg.x = smem;
  cg.r = cg.x + hw;
  cg.d = cg.r + hw;
  cg.z = cg.d + hw;
  cg.t = cg.z + hw;
  cg.qy = cg.t + hw;
  cg.qx = h == w ? cg.qy : cg.qy + h * (h + 1);
  Reducer red{cg.qy + basis_floats(h, w)};

  const size_t off = static_cast<size_t>(blockIdx.x) * hw;
  if (precond) load_basis(cg, q_y, q_x, h, w);
  for (int idx = threadIdx.x; idx < hw; idx += kThreads)
    cg.r[idx] = __ldg(div + off + idx);
  const int k = pcg_core(cg, g, x0 == nullptr ? nullptr : x0 + off, out + off,
                         tol, maxiter, precond, red);
  if (threadIdx.x == 0) iters[blockIdx.x] = k;
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory one block needs; ops/cuda_cg.py ::
// cuda_solve_fits mirrors this count.
size_t pcg_shared_bytes(int h, int w) {
  const size_t floats = 5 * static_cast<size_t>(h) * w + basis_floats(h, w) +
                        kSlotFloats;
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
