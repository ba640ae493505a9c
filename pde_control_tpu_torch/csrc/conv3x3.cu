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
//    in parallel, so a block sums its own runs of image rows into slice s
//    of an fp32 (S, 9*Cin, Cout) scratch that the wrapper allocates, and a
//    second kernel adds the S slices in order and rounds to bf16 once
//    (with S = 1 the first pass rounds and writes dW itself). No atomics:
//    the result is the same in every run.
//
// What bounds them on this card at the main path's shapes: the 32..128
// channel layers do 2*M*N*K operations on about (M*(Cin+Cout) + 9*Cin*Cout)
// bf16 values, 100..290 operations per byte against the card's ridge of
// 989e12 / 3.35e12 = 295, so operations and bytes bound them about equally
// and the tensor cores are the unit to feed; the 3- and 5-channel first
// layers and the 1-channel output layer (K = 27 or 45, or N = 1) do a few
// operations per byte and are bound by bytes. K4 is still the plain
// version of its design: one buffer of shared memory, loads that wait,
// wmma.
//
// K5 is far from either bound; what holds it back is latency (a block that
// waits for its loads between a few products) and reading x nine times,
// once per tap. Its design answers both:
//  * A block owns runs of whole image rows of one sample, a tile of 16 or
//    32 input channels and a tile of 16..64 output channels, and computes
//    all nine taps of dW for them. It stages the run's x halo tile,
//    (R+2) x (W+2) pixels with zeros outside the image, and the dY tile
//    once; tap (dy, dx)'s operand is the same shared tile read at the
//    constant pixel offset dy*(W+2) + dx. x and dY leave L2 once per
//    (channel tile, Cout tile) and no index is divided in the inner loop.
//  * Pixels are walked in the padded index space q in [0, R*(W+2)), dY
//    staged in the same layout with zeros in the two pad columns, so a
//    16-pixel fragment keeps one stride across row ends and the products
//    of pad pixels are multiplied by zero: 2/(W+2) of the products wasted.
//  * Fragments are loaded with ldmatrix.trans and multiplied with
//    mma.sync.m16n8k16 by hand, not wmma: a one-pixel offset moves the
//    fragment by one shared-memory row, and ldmatrix wants 16-byte aligned
//    rows where wmma wants 32. Rows are padded by 8 elements to 48, 80 or
//    144 bytes, an odd count of 16-byte chunks, so the eight rows of one
//    8x8 matrix fall into eight different chunks of the 128-byte bank
//    line: no bank conflicts.
//  * Each of the eight warps keeps one 16-channel x 16-Cout fragment pair
//    of all nine taps (72 fp32 registers) and uses one dY fragment for
//    nine products. Where the tile has fewer than eight such pairs the
//    warps share the run's 16-pixel steps and are added, in order, through
//    shared memory at the end.
//  * The tiles go through a ring of two buffers filled by cp.async (16
//    bytes, zero-filled for the borders), so run i+1 loads while run i
//    multiplies. Channel counts that are no multiple of 8 (Cin = 3, 5;
//    Cout = 1) are staged by element loads, zero-padded to the fragment.
//  * The wrapper plans rows per run, runs per block and the splits S
//    (ops/cuda_conv.py :: dw_plan); a run never crosses a sample.

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
constexpr int kPad = 8;        // bf16 row padding in shared memory (16 B)
constexpr int kOutside = -(1 << 20);  // a row for a pixel past the end
constexpr int kDwThreads = 256;  // K5: eight warps per block
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kDwStages = 2;     // K5: buffers in the ring
// K5: pixels kept zero after the halo tile. The last fragment of a run
// starts below R*(W+2) rounded up to 16, reads 16 pixels and is shifted by
// at most 2*(W+2) + 2, so it ends at most 17 pixels past the tile.
constexpr int kDwSlack = 24;

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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory without passing a register;
// bytes = 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices, transposed: lane l gives the address of row l % 8
// of matrix l / 8; register j holds elements (2 * (lane % 4) + {0, 1},
// lane / 4) of matrix j.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16 x 8, fp32) += a (16 x 16, row) b (16 x 8, col), bf16 operands.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// K5: stages n_px pixels x CH channels of one sample's image `src` (h, w,
// chans) into dst[p * ld + c]. Pixel p sits at row p / wp and column
// p % wp of a tile wp = w + 2 pixels wide whose corner is the image's
// (row0, col0); channel c is the image's c0 + c. Zero outside rows
// [0, row_hi), outside columns [0, w) and, with vec, past the last channel.
// With vec (chans % 8 == 0, 16-byte aligned) by cp.async, else by element
// loads of the channels that exist.
template <int CH>
__device__ __forceinline__ void stage_tile(bf16* dst, int ld,
                                           const bf16* __restrict__ src,
                                           int chans, int c0, int n_px,
                                           int row0, int col0, int row_hi,
                                           int w, int wp, bool vec) {
  // A thread takes one 16-byte chunk of a pixel (vec) or one pixel's
  // channels that exist (the others of the tile were zeroed when the
  // kernel began), every `step` pixels; (tr, pc) follows p without dividing.
  const int per_px = vec ? CH / 8 : 1;
  const int step = kDwThreads / per_px;
  const int j = (threadIdx.x % per_px) * 8;
  const int real = vec ? (c0 + j < chans ? 8 : 0) : min(CH, chans - c0);
  int p = threadIdx.x / per_px;
  int tr = p / wp, pc = p - tr * wp;
  const int dtr = step / wp, dpc = step - dtr * wp;
  for (; p < n_px; p += step) {
    const int row = row0 + tr, col = col0 + pc;
    const bool ok = real > 0 && row >= 0 && row < row_hi && col >= 0 && col < w;
    const bf16* from =
        src + (ok ? (static_cast<size_t>(row) * w + col) * chans + c0 + j : 0);
    bf16* to = dst + p * ld + j;
    if (vec) {
      cp_async16(to, from, ok ? 16 : 0);
    } else {
      for (int c = 0; c < real; ++c)
        to[c] = ok ? from[c] : __float2bfloat16(0.f);
    }
    pc += dpc;
    tr += dtr;
    if (pc >= wp) {
      pc -= wp;
      ++tr;
    }
  }
}

// K5's tile: CF fragments of 16 input channels x NF fragments of 16 output
// channels, one pair per warp, and G warps per pair sharing a run's steps.
template <int CF, int NF>
struct DwTile {
  static constexpr int kCT = 16 * CF, kBN = 16 * NF;
  static constexpr int kLdx = kCT + kPad, kLdg = kBN + kPad;
  static constexpr int kPairs = CF * NF;
  static constexpr int kGroups = kDwWarps / kPairs;
  // fp32 values one warp hands over in the final sum: 9 taps x 2 x 4 per
  // lane.
  static constexpr int kAccPerWarp = 72 * 32;
};

// The dynamic shared memory of K5's first pass: the ring of (x halo tile +
// slack, dY tile) buffers, or the warps' final sum where that is larger.
template <int CF, int NF>
size_t dw_shared_bytes(int rows, int w) {
  using T = DwTile<CF, NF>;
  const size_t wp = w + 2;
  const size_t xs_px = (rows + 2) * wp + kDwSlack;
  const size_t q_px = (rows * wp + 15) / 16 * 16;
  const size_t ring =
      kDwStages * sizeof(bf16) * (xs_px * T::kLdx + q_px * T::kLdg);
  const size_t sum =
      sizeof(float) * (T::kGroups - 1) * T::kPairs * T::kAccPerWarp;
  return ring > sum ? ring : sum;
}

// K5, first pass. Run i of the batch is rows [r0, min(h, r0 + rows)) of
// sample i / ceil(h / rows), r0 = (i % ceil(h / rows)) * rows. Block
// (x, y, z) sums runs [z * runs_per_block, (z + 1) * runs_per_block), cut
// at total_runs, for channels [x * 16 CF, ..) and output channels
// [y * 16 NF, ..): partial[z, tap * cin + c, n] = sum over the runs' pixels
// of x[pixel + tap's offset, c] g[pixel, n], in fp32; or, with dw not null
// (one split), dw[tap * cin + c, n] = the same rounded to bf16.
template <int CF, int NF>
__global__ void __launch_bounds__(kDwThreads)
conv3x3_dw_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                  float* __restrict__ partial, bf16* __restrict__ dw, int h,
                  int w_, int cin, int cout, int rows, int runs_per_block,
                  int total_runs, bool vec_x, bool vec_g) {
  using T = DwTile<CF, NF>;
  constexpr int kLdx = T::kLdx, kLdg = T::kLdg;
  extern __shared__ __align__(128) unsigned char dw_smem[];
  bf16* ring = reinterpret_cast<bf16*>(dw_smem);

  const int wp = w_ + 2;
  const int tile_px = (rows + 2) * wp;         // the x halo tile
  const int q_px = (rows * wp + 15) / 16 * 16;  // the padded dY tile
  const int xs_elems = (tile_px + kDwSlack) * kLdx;
  const int stage_elems = xs_elems + q_px * kLdg;
  const int runs_per_sample = (h + rows - 1) / rows;
  const int c0 = blockIdx.x * T::kCT, n0 = blockIdx.y * T::kBN;
  const int run_begin = blockIdx.z * runs_per_block;
  const int run_end = min(total_runs, run_begin + runs_per_block);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pair = warp % T::kPairs, group = warp / T::kPairs;
  const int c_off = (pair / NF) * 16, n_off = (pair % NF) * 16;

  // The slack after each halo tile is written once and stays zero: pad
  // pixels read it, and anything but a finite value there would turn
  // their zero products into NaN. A tile staged by element loads is zeroed
  // whole, for its channels past the last.
  for (int s = 0; s < kDwStages; ++s) {
    bf16* xs = ring + s * stage_elems;
    const int x_from = vec_x ? tile_px * kLdx : 0;
    for (int e = x_from + threadIdx.x; e < xs_elems; e += kDwThreads)
      xs[e] = __float2bfloat16(0.f);
    if (!vec_g)
      for (int e = threadIdx.x; e < q_px * kLdg; e += kDwThreads)
        xs[xs_elems + e] = __float2bfloat16(0.f);
  }
  __syncthreads();  // before the element stores of the first run

  auto stage_run = [&](int run, int stage) {
    const int sample = run / runs_per_sample;
    const int r0 = (run - sample * runs_per_sample) * rows;
    bf16* xs = ring + stage * stage_elems;
    const size_t image = static_cast<size_t>(sample) * h * w_;
    stage_tile<T::kCT>(xs, kLdx, x + image * cin, cin, c0, tile_px, r0 - 1, -1,
                       h, w_, wp, vec_x);
    stage_tile<T::kBN>(xs + xs_elems, kLdg, g + image * cout, cout, n0, q_px,
                       r0, 0, min(h, r0 + rows), w_, wp, vec_g);
  };

  float acc[9][2][4];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[tap][j][i] = 0.f;

  // Byte offsets of this lane's ldmatrix rows. x (A, channels x pixels,
  // from rows of pixels): matrices (pixels 0-7, channels 0-7), (0-7, 8-15),
  // (8-15, 0-7), (8-15, 8-15). dY (B, pixels x Cout): (pixels 0-7, Cout
  // 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15).
  const unsigned a_lane =
      2 * (((lane & 7) + (lane >> 4) * 8) * kLdx + ((lane >> 3) & 1) * 8 + c_off);
  const unsigned b_lane =
      2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * kLdg + (lane >> 4) * 8 + n_off);
  const unsigned row_bytes = 2 * kLdx * wp;  // one tile row down (dy)
  const int steps = q_px / 16;

  if (run_begin < run_end) stage_run(run_begin, 0);
  cp_async_commit();
  for (int run = run_begin; run < run_end; ++run) {
    const int stage = (run - run_begin) % kDwStages;
    // The other buffer was last read before the barrier that ended the
    // run before this one.
    if (run + 1 < run_end) stage_run(run + 1, (stage + 1) % kDwStages);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this run has landed
    __syncthreads();
    const unsigned xs_addr = smem_addr(ring + stage * stage_elems) + a_lane;
    const unsigned gs_addr =
        smem_addr(ring + stage * stage_elems + xs_elems) + b_lane;
    for (int s = group; s < steps; s += T::kGroups) {
      // All ten fragments first, then the eighteen products: the loads'
      // latency is paid once a step. One block fits an SM, so the 40
      // registers are free.
      unsigned b[4], a[9][4];
      ldmatrix_x4_trans(b, gs_addr + s * (16 * 2 * kLdg));
      const unsigned a_addr = xs_addr + s * (16 * 2 * kLdx);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
        ldmatrix_x4_trans(a[tap], a_addr + (tap / 3) * row_bytes +
                                      (tap % 3) * (2 * kLdx));
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        mma_bf16(acc[tap][0], a[tap], b[0], b[1]);
        mma_bf16(acc[tap][1], a[tap], b[2], b[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // Warps of one pair: groups 1.. hand their sums over through shared
  // memory and group 0 adds them in order.
  if constexpr (T::kGroups > 1) {
    float* sums = reinterpret_cast<float*>(dw_smem);
    if (group > 0) {
      float* mine = sums + ((group - 1) * T::kPairs + pair) * T::kAccPerWarp + lane;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            mine[((tap * 2 + j) * 4 + i) * 32] = acc[tap][j][i];
    }
    __syncthreads();
    if (group == 0) {
      for (int k = 1; k < T::kGroups; ++k) {
        const float* theirs =
            sums + ((k - 1) * T::kPairs + pair) * T::kAccPerWarp + lane;
#pragma unroll
        for (int tap = 0; tap < 9; ++tap)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              acc[tap][j][i] += theirs[((tap * 2 + j) * 4 + i) * 32];
      }
    }
  }
  if (group != 0) return;

  // Registers 2 * half + {0, 1} of fragment j: channel lane / 4 + 8 * half,
  // output channels 8 * j + 2 * (lane % 4) + {0, 1}.
  const size_t count = static_cast<size_t>(9) * cin * cout;
  float* out = partial + blockIdx.z * count;
  const bool pairs = dw == nullptr && cout % 2 == 0;  // 8-byte stores
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = c0 + c_off + lane / 4 + 8 * half;
        const int n = n0 + n_off + 8 * j + 2 * (lane % 4);
        if (c >= cin || n >= cout) continue;
        const size_t at = (static_cast<size_t>(tap) * cin + c) * cout + n;
        const float v0 = acc[tap][j][2 * half], v1 = acc[tap][j][2 * half + 1];
        if (pairs) {
          *reinterpret_cast<float2*>(out + at) = make_float2(v0, v1);
        } else if (dw != nullptr) {
          dw[at] = __float2bfloat16_rn(v0);
          if (n + 1 < cout) dw[at + 1] = __float2bfloat16_rn(v1);
        } else {
          out[at] = v0;
          if (n + 1 < cout) out[at + 1] = v1;
        }
      }
}

// K5, second pass: dw[i] = bf16(sum over s of partial[s, i]) in a fixed
// order. `ways` (1, 2, 4 or 8) warps share 32 values of i: warp j of them
// adds slices j, j + ways, .., and warp 0 adds their sums in order. A small
// dW under many splits would else be a few threads' long chains of loads.
__global__ void __launch_bounds__(256)
conv3x3_dw_reduce_kernel(const float* __restrict__ partial,
                         bf16* __restrict__ dw, int count, int splits,
                         int ways) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int j = warp % ways;
  const int i = (blockIdx.x * (8 / ways) + warp / ways) * 32 + lane;
  float s = 0.f;
  if (i < count)
    for (int p = j; p < splits; p += ways)
      s += partial[static_cast<size_t>(p) * count + i];
  sums[warp][lane] = s;
  __syncthreads();
  if (j != 0 || i >= count) return;
  for (int k = 1; k < ways; ++k) s += sums[warp + k][lane];
  dw[i] = __float2bfloat16_rn(s);
}

// The least tile width of 16, 32 or 64 that covers n channels (64 above).
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

// K5's channel fragments per block: all of cin up to 16, else 32 at a time.
int dw_frags_c(int cin) { return cin <= 16 ? 1 : 2; }

template <int CF, int NF>
cudaError_t launch_dw(cudaStream_t st, const bf16* x, const bf16* g,
                      float* partial, bf16* dw, int batch, int h, int w,
                      int cin, int cout, int rows, int runs_per_block,
                      int splits, bool vec_x, bool vec_g) {
  using T = DwTile<CF, NF>;
  auto* kernel = conv3x3_dw_kernel<CF, NF>;
  const size_t smem = dw_shared_bytes<CF, NF>(rows, w);
  // Above 48 KB shared memory has to be allowed, once per device.
  static int allowed_on = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device != allowed_on) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return err;
    allowed_on = device;
  }
  const dim3 grid((cin + T::kCT - 1) / T::kCT, (cout + T::kBN - 1) / T::kBN,
                  splits);
  const int total_runs = batch * ((h + rows - 1) / rows);
  kernel<<<grid, kDwThreads, smem, st>>>(x, g, partial,
                                         splits == 1 ? dw : nullptr, h, w, cin,
                                         cout, rows, runs_per_block,
                                         total_runs, vec_x, vec_g);
  return cudaGetLastError();
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

// The dynamic shared memory K5's first pass asks for with `rows` image rows
// per run; ops/cuda_conv.py :: dw_plan counts the same.
size_t conv3x3_dw_shared_bytes(int rows, int w, int cin, int cout) {
  using Count = size_t (*)(int, int);
  static constexpr Count counts[2][3] = {
      {dw_shared_bytes<1, 1>, dw_shared_bytes<1, 2>, dw_shared_bytes<1, 4>},
      {dw_shared_bytes<2, 1>, dw_shared_bytes<2, 2>, dw_shared_bytes<2, 4>}};
  return counts[dw_frags_c(cin) - 1][tile_n(cout) / 32](rows, w);
}

// K5 on `stream`: dw (9*cin, cout) bf16 = sum over batch and pixels of
// im2col(x)^T g, with x (batch, h, w, cin) and g (batch, h, w, cout) bf16,
// channels-last, contiguous. The batch is cut into runs of `rows` image
// rows of one sample; split s of `splits` sums runs [s * runs_per_block,
// (s + 1) * runs_per_block) into slice s of partial, fp32 scratch of
// splits * 9*cin * cout values (unused, and may be null, with one split).
// vec_x / vec_g allow 16-byte loads of x / g. Two launches, one with one
// split; returns the first cudaError_t either reports.
int conv3x3_dw_bf16(const void* x, const void* g, float* partial, void* dw,
                    int batch, int h, int w, int cin, int cout, int rows,
                    int runs_per_block, int splits, int vec_x, int vec_g,
                    void* stream) {
  const long long total_runs =
      rows > 0 ? static_cast<long long>(batch) * ((h + rows - 1) / rows) : 0;
  if (rows <= 0 || runs_per_block <= 0 || splits <= 0 || splits > 65535 ||
      static_cast<long long>(splits) * runs_per_block < total_runs ||
      conv3x3_dw_shared_bytes(rows, w, cin, cout) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const bf16*>(x);
  const auto* gp = static_cast<const bf16*>(g);
  auto* dwp = static_cast<bf16*>(dw);
  static constexpr decltype(&launch_dw<1, 1>) launches[2][3] = {
      {launch_dw<1, 1>, launch_dw<1, 2>, launch_dw<1, 4>},
      {launch_dw<2, 1>, launch_dw<2, 2>, launch_dw<2, 4>}};
  const cudaError_t err = launches[dw_frags_c(cin) - 1][tile_n(cout) / 32](
      st, xp, gp, partial, dwp, batch, h, w, cin, cout, rows, runs_per_block,
      splits, vec_x != 0, vec_g != 0);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const int count = 9 * cin * cout;
  // Enough threads to fill the card, as far as the splits go round.
  int ways = 1;
  while (ways < 8 && 2 * ways <= splits && count * ways < 65536) ways *= 2;
  const int per_block = 32 * (8 / ways);
  conv3x3_dw_reduce_kernel<<<(count + per_block - 1) / per_block, 256, 0, st>>>(
      partial, dwp, count, splits, ways);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
