// 3x3 SAME stride-1 convolution, channels-last, bf16 operands with fp32
// accumulation, and its weight gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pde_control_tpu/ops/pallas_conv.py:
//  * K4, _make_conv._run_fwd (body _fwd_kernel): y = im2col(x) @ W + b,
//    and the same kernel run on the cotangent with the 180-degree rotated,
//    io-transposed weights for dX (the pallas_call with `wback`).
//    conv3x3_fwd_kernel<BN, false> reads W as the (9*Cin, Cout) matrix;
//    conv3x3_fwd_kernel<BN, true> reads the same array rotated by index,
//    so no rotated copy of the weights is ever built.
//  * K5, _make_conv.bwd's dW (body _dw_kernel): dW[9*Cin, Cout] = the sum
//    over batch and pixels of im2col(x)^T dY.
//
// Both are implicit GEMMs on the bf16 tensor cores (nvcuda::wmma 16x16x16
// fragments, fp32 accumulators). im2col is never stored in device memory:
// each slice of the A tile is gathered from x straight into shared memory,
// zero outside the image and past K = 9*Cin, 16 bytes per load where the
// channel count is a multiple of 8 and one element per load where it is
// not (Cin = 3 or 5, Cout = 1). K and N are zero-padded to the fragment in
// shared memory, so every 3x3 stride-1 SAME shape is taken.
//  * K4: a block computes 64 output pixels x BN output channels (BN = 16, 32
//    or 64, the least that covers Cout, so Cout = 1 or 16 wastes little of
//    the tile) over K in slices of 32. The bias, rounded to bf16 by the
//    caller, is added to the fp32 sum, and the result is rounded to bf16
//    once: the Pallas kernel's rounding points.
//  * K5: the Pallas kernel carries the fp32 sum from one grid step to the
//    next, which works because the TPU grid runs in order. Here blocks run
//    in parallel, so block (k tile, n tile, s) sums its own run of pixels
//    into slice s of an fp32 (S, 9*Cin, Cout) scratch that the wrapper
//    allocates, and a second kernel adds the S slices in order and rounds
//    to bf16 once. No atomics: the result is the same in every run.
//
// What bounds them on this card at the main path's shapes: the 32..128
// channel layers do 2*M*N*K operations on about (M*(Cin+Cout) + 9*Cin*Cout)
// bf16 values, 100..290 operations per byte against the card's ridge of
// 989e12 / 3.35e12 = 295, so operations and bytes bound them about equally
// and the tensor cores are the unit to feed; the 3- and 5-channel first
// layers and the 1-channel output layer (K = 27 or 45, or N = 1) do a few
// operations per byte and are bound by bytes. This version is the simple
// one: one buffer of shared memory, loads that wait, wmma instead of
// wgmma; a TMA-fed, pipelined wgmma version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int kThreads = 128;  // four warps per block
constexpr int kBM = 64;        // K4: output pixels per block
constexpr int kKC = 32;        // K4: K slice per step
constexpr int kBK = 64;        // K5: rows of dW per block
constexpr int kMC = 32;        // K5: pixels per step
constexpr int kPad = 8;        // bf16 row padding in shared memory (16 B)
constexpr int kOutside = -(1 << 20);  // a row for a pixel past the end

// Four warps over a 64 x BN output tile, in 16x16 fragments.
template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN == 64 ? 2 : 1;
  static constexpr int kWarpsM = 4 / kWarpsN;
  static constexpr int kFragsM = 64 / 16 / kWarpsM;
  static constexpr int kFragsN = BN / 16 / kWarpsN;
};

// Element k of pixel m's im2col row: tap = k / cin = 3*dy + dx, channel
// c = k % cin, read at (h + dy - 1, w + dx - 1), zero outside the image.
// (ph, pw) is pixel m's position, ph = kOutside for no pixel.
__device__ __forceinline__ bf16 im2col_at(const bf16* __restrict__ x, int m,
                                          int ph, int pw, int k, int kdim,
                                          int h, int w, int cin) {
  if (k < kdim) {
    const int tap = k / cin, c = k - tap * cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int yy = ph + dy, xx = pw + dx;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w)
      return x[static_cast<size_t>(m + dy * w + dx) * cin + c];
  }
  return __float2bfloat16(0.f);
}

// Elements k .. k+7 of the same row: one tap, eight channels, when
// cin % 8 == 0 and k % 8 == 0.
__device__ __forceinline__ uint4 im2col_vec(const bf16* __restrict__ x, int m,
                                            int ph, int pw, int k, int kdim,
                                            int h, int w, int cin) {
  if (k < kdim) {
    const int tap = k / cin, c = k - tap * cin;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int yy = ph + dy, xx = pw + dx;
    if (yy >= 0 && yy < h && xx >= 0 && xx < w)
      return __ldg(reinterpret_cast<const uint4*>(
          x + static_cast<size_t>(m + dy * w + dx) * cin + c));
  }
  return make_uint4(0u, 0u, 0u, 0u);
}

// Gathers rows m0 .. m0+ROWS-1, columns k0 .. k0+COLS-1 of im2col(x) into
// tile[r * ld + kk]; (s_h[r], s_w[r]) is row r's pixel.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_im2col(bf16* tile, int ld,
                                            const bf16* __restrict__ x, int m0,
                                            int k0, const int* s_h,
                                            const int* s_w, int kdim, int h,
                                            int w, int cin, bool vec) {
  if (vec) {
    for (int v = threadIdx.x; v < ROWS * COLS / 8; v += kThreads) {
      const int r = v / (COLS / 8), kk = (v % (COLS / 8)) * 8;
      *reinterpret_cast<uint4*>(tile + r * ld + kk) =
          im2col_vec(x, m0 + r, s_h[r], s_w[r], k0 + kk, kdim, h, w, cin);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * COLS; e += kThreads) {
      const int r = e / COLS, kk = e % COLS;
      tile[r * ld + kk] =
          im2col_at(x, m0 + r, s_h[r], s_w[r], k0 + kk, kdim, h, w, cin);
    }
  }
}

// Rows k0 .. k0+kKC-1, columns n0 .. n0+BN-1 of the GEMM's right operand.
// Forward: B(k, n) = w[k * cout + n], stored tile[k][n]. Rotated (dX): the
// operand is the forward weights (9*cout, cin) turned 180 degrees with in
// and out channels swapped, B(tap * cin + c, n) = w[((8 - tap) * cout + n)
// * cin + c], stored tile[n][k] (contiguous along c).
template <int BN, bool kRot>
__device__ __forceinline__ void load_weights(bf16* tile,
                                             const bf16* __restrict__ w,
                                             int k0, int n0, int kdim, int cin,
                                             int cout, bool vec) {
  constexpr int ld = kRot ? kKC + kPad : BN + kPad;
  if (!kRot && vec) {  // cout % 8 == 0
    for (int v = threadIdx.x; v < kKC * BN / 8; v += kThreads) {
      const int r = v / (BN / 8), j = (v % (BN / 8)) * 8;
      const int k = k0 + r, n = n0 + j;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < kdim && n < cout)
        val = __ldg(reinterpret_cast<const uint4*>(
            w + static_cast<size_t>(k) * cout + n));
      *reinterpret_cast<uint4*>(tile + r * ld + j) = val;
    }
  } else if (!kRot) {
    for (int e = threadIdx.x; e < kKC * BN; e += kThreads) {
      const int r = e / BN, j = e % BN, k = k0 + r, n = n0 + j;
      tile[r * ld + j] = k < kdim && n < cout
                             ? w[static_cast<size_t>(k) * cout + n]
                             : __float2bfloat16(0.f);
    }
  } else if (vec) {  // cin % 8 == 0: eight consecutive k share one tap
    for (int v = threadIdx.x; v < BN * kKC / 8; v += kThreads) {
      const int j = v / (kKC / 8), kk = (v % (kKC / 8)) * 8;
      const int k = k0 + kk, n = n0 + j;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (k < kdim && n < cout) {
        const int tap = k / cin, c = k - tap * cin;
        val = __ldg(reinterpret_cast<const uint4*>(
            w + (static_cast<size_t>(8 - tap) * cout + n) * cin + c));
      }
      *reinterpret_cast<uint4*>(tile + j * ld + kk) = val;
    }
  } else {
    for (int e = threadIdx.x; e < BN * kKC; e += kThreads) {
      const int j = e / kKC, kk = e % kKC, k = k0 + kk, n = n0 + j;
      bf16 val = __float2bfloat16(0.f);
      if (k < kdim && n < cout) {
        const int tap = k / cin, c = k - tap * cin;
        val = w[(static_cast<size_t>(8 - tap) * cout + n) * cin + c];
      }
      tile[j * ld + kk] = val;
    }
  }
}

// K4: y[m, n] = bf16(sum_k im2col(x)[m, k] B(k, n) + bias[n]) for the
// (B*H*W, cout) output; bias may be null (zero).
template <int BN, bool kRot>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ y,
                   int m_total, int h, int w_, int cin, int cout, bool vec_a,
                   bool vec_b) {
  using T = Tile<BN>;
  using BLayout = std::conditional_t<kRot, wmma::col_major, wmma::row_major>;
  constexpr int lda = kKC + kPad;
  constexpr int ldb = kRot ? kKC + kPad : BN + kPad;
  constexpr int ldc = BN + 4;
  __shared__ __align__(128) bf16 a_tile[kBM * lda];
  __shared__ __align__(128) bf16 b_tile[kRot ? BN * ldb : kKC * ldb];
  __shared__ __align__(128) float c_tile[kBM * ldc];
  __shared__ int s_h[kBM], s_w[kBM];

  const int kdim = 9 * cin;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const int m = m0 + r;
    s_h[r] = m < m_total ? (m / w_) % h : kOutside;
    s_w[r] = m < m_total ? m % w_ : 0;
  }
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFragsM]
                                                         [T::kFragsN];
#pragma unroll
  for (int i = 0; i < T::kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  __syncthreads();

  for (int k0 = 0; k0 < kdim; k0 += kKC) {
    load_im2col<kBM, kKC>(a_tile, lda, x, m0, k0, s_h, s_w, kdim, h, w_, cin,
                          vec_a);
    load_weights<BN, kRot>(b_tile, w, k0, n0, kdim, cin, cout, vec_b);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          a[T::kFragsM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[T::kFragsN];
#pragma unroll
      for (int i = 0; i < T::kFragsM; ++i)
        wmma::load_matrix_sync(a[i], a_tile + (wm * T::kFragsM + i) * 16 * lda + kk,
                               lda);
#pragma unroll
      for (int j = 0; j < T::kFragsN; ++j) {
        const int col = (wn * T::kFragsN + j) * 16;
        wmma::load_matrix_sync(
            b[j], kRot ? b_tile + col * ldb + kk : b_tile + kk * ldb + col, ldb);
      }
#pragma unroll
      for (int i = 0; i < T::kFragsM; ++i)
#pragma unroll
        for (int j = 0; j < T::kFragsN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragsN; ++j)
      wmma::store_matrix_sync(
          c_tile + (wm * T::kFragsM + i) * 16 * ldc + (wn * T::kFragsN + j) * 16,
          acc[i][j], ldc, wmma::mem_row_major);
  __syncthreads();
  for (int e = threadIdx.x; e < kBM * BN; e += kThreads) {
    const int r = e / BN, j = e % BN, m = m0 + r, n = n0 + j;
    if (m < m_total && n < cout) {
      float v = c_tile[r * ldc + j];
      if (bias != nullptr) v += __bfloat162float(bias[n]);
      y[static_cast<size_t>(m) * cout + n] = __float2bfloat16_rn(v);
    }
  }
}

// K5, first pass: partial[s, k, n] = sum over pixels m of split s of
// im2col(x)[m, k] g[m, n], in fp32. Split s covers pixels
// [s * chunk, min((s + 1) * chunk, m_total)).
template <int BN>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ partial, int m_total, int h, int w_,
                  int cin, int cout, int chunk, bool vec_a, bool vec_g) {
  using T = Tile<BN>;
  constexpr int lda = kBK + kPad;  // a_tile[m][k]: im2col(x)^T read col-major
  constexpr int ldg = BN + kPad;   // g_tile[m][n]
  constexpr int ldc = BN + 4;
  __shared__ __align__(128) bf16 a_tile[kMC * lda];
  __shared__ __align__(128) bf16 g_tile[kMC * ldg];
  __shared__ __align__(128) float c_tile[kBK * ldc];
  __shared__ int s_h[kMC], s_w[kMC];

  const int kdim = 9 * cin;
  const int k0 = blockIdx.x * kBK, n0 = blockIdx.y * BN;
  const int m_begin = blockIdx.z * chunk;
  const int m_end = min(m_total, m_begin + chunk);
  const int warp = threadIdx.x / 32;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::kFragsM]
                                                         [T::kFragsN];
#pragma unroll
  for (int i = 0; i < T::kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragsN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int mb = m_begin; mb < m_end; mb += kMC) {
    if (threadIdx.x < kMC) {
      const int m = mb + threadIdx.x;
      s_h[threadIdx.x] = m < m_end ? (m / w_) % h : kOutside;
      s_w[threadIdx.x] = m < m_end ? m % w_ : 0;
    }
    __syncthreads();
    load_im2col<kMC, kBK>(a_tile, lda, x, mb, k0, s_h, s_w, kdim, h, w_, cin,
                          vec_a);
    if (vec_g) {  // cout % 8 == 0
      for (int v = threadIdx.x; v < kMC * BN / 8; v += kThreads) {
        const int r = v / (BN / 8), j = (v % (BN / 8)) * 8;
        const int m = mb + r, n = n0 + j;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (m < m_end && n < cout)
          val = __ldg(reinterpret_cast<const uint4*>(
              g + static_cast<size_t>(m) * cout + n));
        *reinterpret_cast<uint4*>(g_tile + r * ldg + j) = val;
      }
    } else {
      for (int e = threadIdx.x; e < kMC * BN; e += kThreads) {
        const int r = e / BN, j = e % BN, m = mb + r, n = n0 + j;
        g_tile[r * ldg + j] = m < m_end && n < cout
                                  ? g[static_cast<size_t>(m) * cout + n]
                                  : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < kMC; mm += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
          a[T::kFragsM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
          b[T::kFragsN];
#pragma unroll
      for (int i = 0; i < T::kFragsM; ++i)
        wmma::load_matrix_sync(a[i], a_tile + mm * lda + (wm * T::kFragsM + i) * 16,
                               lda);
#pragma unroll
      for (int j = 0; j < T::kFragsN; ++j)
        wmma::load_matrix_sync(b[j], g_tile + mm * ldg + (wn * T::kFragsN + j) * 16,
                               ldg);
#pragma unroll
      for (int i = 0; i < T::kFragsM; ++i)
#pragma unroll
        for (int j = 0; j < T::kFragsN; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < T::kFragsM; ++i)
#pragma unroll
    for (int j = 0; j < T::kFragsN; ++j)
      wmma::store_matrix_sync(
          c_tile + (wm * T::kFragsM + i) * 16 * ldc + (wn * T::kFragsN + j) * 16,
          acc[i][j], ldc, wmma::mem_row_major);
  __syncthreads();
  float* out = partial + static_cast<size_t>(blockIdx.z) * kdim * cout;
  for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
    const int r = e / BN, j = e % BN, k = k0 + r, n = n0 + j;
    if (k < kdim && n < cout)
      out[static_cast<size_t>(k) * cout + n] = c_tile[r * ldc + j];
  }
}

// K5, second pass: dw[i] = bf16(sum over s in order of partial[s, i]).
__global__ void __launch_bounds__(256)
conv3x3_dw_reduce_kernel(const float* __restrict__ partial,
                         bf16* __restrict__ dw, int count, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += partial[static_cast<size_t>(p) * count + i];
  dw[i] = __float2bfloat16_rn(s);
}

// The least tile width of 16, 32 or 64 that covers n channels (64 above);
// ops/cuda_conv.py :: _tile_n mirrors it to size K5's splits.
int tile_n(int n) { return n <= 16 ? 16 : n <= 32 ? 32 : 64; }

template <bool kRot>
void launch_fwd(dim3 grid, cudaStream_t st, const bf16* x, const bf16* w,
                const bf16* bias, bf16* y, int m, int h, int w_, int cin,
                int cout, bool vec_a, bool vec_b) {
  switch (tile_n(cout)) {
    case 16:
      conv3x3_fwd_kernel<16, kRot><<<grid, kThreads, 0, st>>>(
          x, w, bias, y, m, h, w_, cin, cout, vec_a, vec_b);
      break;
    case 32:
      conv3x3_fwd_kernel<32, kRot><<<grid, kThreads, 0, st>>>(
          x, w, bias, y, m, h, w_, cin, cout, vec_a, vec_b);
      break;
    default:
      conv3x3_fwd_kernel<64, kRot><<<grid, kThreads, 0, st>>>(
          x, w, bias, y, m, h, w_, cin, cout, vec_a, vec_b);
  }
}

}  // namespace

extern "C" {

// K4 on `stream`: y (batch, h, w, cout) = conv3x3(x (batch, h, w, cin), W)
// + bias, all bf16, channels-last, contiguous. rotated == 0: wgt is W as
// (9*cin, cout). rotated != 0 (dX): wgt is the forward weights (9*cout,
// cin) of the conv whose input gradient this is, read rotated. bias may be
// null. vec_a / vec_b allow 16-byte loads of x / wgt (cin % 8 == 0, and
// cout % 8 == 0 unrotated or cin % 8 == 0 rotated, with 16-byte aligned
// pointers). Returns the cudaError_t of the launch.
int conv3x3_fwd_bf16(const void* x, const void* wgt, const void* bias, void* y,
                     int batch, int h, int w, int cin, int cout, int rotated,
                     int vec_a, int vec_b, void* stream) {
  const int m = batch * h * w;
  const int bn = tile_n(cout);
  const dim3 grid((m + kBM - 1) / kBM, (cout + bn - 1) / bn);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* wp = static_cast<const bf16*>(wgt);
  const auto* bp = static_cast<const bf16*>(bias);
  auto* yp = static_cast<bf16*>(y);
  if (rotated)
    launch_fwd<true>(grid, st, xp, wp, bp, yp, m, h, w, cin, cout, vec_a != 0,
                     vec_b != 0);
  else
    launch_fwd<false>(grid, st, xp, wp, bp, yp, m, h, w, cin, cout, vec_a != 0,
                      vec_b != 0);
  return static_cast<int>(cudaGetLastError());
}

// K5 on `stream`: dw (9*cin, cout) bf16 = sum over batch and pixels of
// im2col(x)^T g, with x (batch, h, w, cin) and g (batch, h, w, cout) bf16,
// channels-last, contiguous. partial is fp32 scratch of splits * 9*cin *
// cout values; split s sums pixels [s * chunk, (s + 1) * chunk). vec_a /
// vec_g allow 16-byte loads of x / g. Two launches; returns the first
// cudaError_t either reports.
int conv3x3_dw_bf16(const void* x, const void* g, float* partial, void* dw,
                    int batch, int h, int w, int cin, int cout, int splits,
                    int chunk, int vec_a, int vec_g, void* stream) {
  const int m = batch * h * w;
  const int kdim = 9 * cin;
  const int bn = tile_n(cout);
  const dim3 grid((kdim + kBK - 1) / kBK, (cout + bn - 1) / bn, splits);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const bf16*>(g);
  switch (bn) {
    case 16:
      conv3x3_dw_kernel<16><<<grid, kThreads, 0, st>>>(
          xp, gp, partial, m, h, w, cin, cout, chunk, vec_a != 0, vec_g != 0);
      break;
    case 32:
      conv3x3_dw_kernel<32><<<grid, kThreads, 0, st>>>(
          xp, gp, partial, m, h, w, cin, cout, chunk, vec_a != 0, vec_g != 0);
      break;
    default:
      conv3x3_dw_kernel<64><<<grid, kThreads, 0, st>>>(
          xp, gp, partial, m, h, w, cin, cout, chunk, vec_a != 0, vec_g != 0);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = kdim * cout;
  conv3x3_dw_reduce_kernel<<<(count + 255) / 256, 256, 0, st>>>(
      partial, static_cast<bf16*>(dw), count, splits);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
