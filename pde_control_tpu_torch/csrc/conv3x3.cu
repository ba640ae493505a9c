// 3x3 SAME stride-1 convolution, channels-last, bf16 operands with fp32
// accumulation, and its weight gradient, for Hopper (sm_90a).
//
// Replaces the TPU kernels of pde_control_tpu/ops/pallas_conv.py:
//  * K4, _make_conv._run_fwd (body _fwd_kernel): y = im2col(x) @ W + b,
//    and the same kernel run on the cotangent with the 180-degree rotated,
//    io-transposed weights for dX (the pallas_call with `wback`).
//    conv3x3_fwd_kernel<BN, FM, false> reads W as the (9*Cin, Cout) matrix;
//    conv3x3_fwd_kernel<BN, FM, true> reads the same array rotated by
//    index while it stages it, so no rotated copy of the weights is built.
//  * K5, _make_conv.bwd's dW (body _dw_kernel): dW[9*Cin, Cout] = the sum
//    over batch and pixels of im2col(x)^T dY.
//
// Both are implicit GEMMs on the bf16 tensor cores (mma.sync.m16n8k16,
// fp32 accumulators). im2col is never stored, not even in shared memory:
// a block stages the halo tile of x (or dY) that its pixels read, with
// zeros outside the image, once per slice of channels, and the operand of
// tap (dy, dx) is that one tile read at a constant pixel offset. Channel
// counts that are no multiple of 8 (Cin = 3 or 5, Cout = 1) are staged by
// element loads and zero-padded to the 16-channel fragment in shared
// memory, so every 3x3 stride-1 SAME shape is taken. The Pallas kernels'
// rounding points are kept: the bias, rounded to bf16 by the caller, is
// added to the fp32 sum, and y, dX and dW are rounded to bf16 once.
//
// What bounds them on this card at the main path's shapes: the 32..128
// channel layers do 2*M*N*K operations on about (M*(Cin+Cout) + 9*Cin*Cout)
// bf16 values, 100..290 operations per byte against the card's ridge of
// 989e12 / 3.35e12 = 295, so operations and bytes bound them about equally
// and the tensor cores are the unit to feed; the 3- and 5-channel first
// layers and the 1-channel output layer (K = 27 or 45, or N = 1) do a few
// operations per byte and are bound by bytes. Neither kernel is near
// either bound: what holds a kernel of this size back is latency (blocks
// that wait for loads between a few products), reading x once per tap, and
// on the 8^2..16^2 layers too few blocks for 132 SMs. Both designs answer
// those the same way:
//  * Pixels are walked in a padded index space in which one 16-pixel
//    fragment keeps one stride across row ends: a pixel's three taps of a
//    row are neighbours in shared memory and its rows are wp pixels apart.
//    Products of the pad pixels are wasted, (wp - W)/wp of them, and
//    dropped (K4) or multiplied by zero (K5).
//  * Fragments come by ldmatrix into mma.sync by hand, not wmma: a
//    one-pixel offset moves the fragment by one shared-memory row, and
//    ldmatrix wants 16-byte aligned rows where wmma wants 32. Rows are
//    padded by 8 elements to 48, 80 or 144 bytes, an odd count of 16-byte
//    chunks, so the eight rows of one 8x8 matrix fall into eight different
//    chunks of the 128-byte bank line: no bank conflicts.
//  * The tiles go through a ring of two buffers filled by cp.async (16
//    bytes, zero-filled for the borders), so slice i+1 loads while slice i
//    multiplies.
//  * Blocks run in parallel and in no order (the TPU grid ran in order and
//    carried sums from step to step): where a block has too little of the
//    work to fill the card alone, S blocks sum disjoint parts of K into
//    their own fp32 partials and a second kernel adds the S partials in a
//    fixed order and rounds once. No atomics: the same bits in every run.
//
// K4. A block owns BM = 128 * FM consecutive positions of the padded
// output, one tile of BN output channels (16 or 32) and, with S
// splits, one run of the 16-channel slices of K. The padded space stacks
// the batch's images as rows of wp pixels: row 0 is zero, then each
// sample's H rows and one zero row, so a tap that leaves a sample reads
// zeros. An image wider than one segment of `seg` columns is cut into
// strips, each with its own halo columns (wp = seg + 2); one strip needs
// one halo column only (wp = W + 1: the right halo of a row is the left
// halo of the next). The block's halo tile is the BM + 2*wp + 2
// consecutive padded pixels that its taps read. Each of the eight warps
// keeps 16*FM pixels x BN channels of fp32 sums (FM * BN / 2 registers)
// and feeds each x fragment to BN / 8 products. For each slice the block
// stages the halo tile and the slice's weights for all nine taps, and
// runs nine taps x FM x BN/8 products per warp behind one barrier pair.
// The epilogue adds the bias and rounds from registers and stores pairs
// of channels. The wrapper plans BN, FM, the segment and S
// (ops/cuda_conv.py :: fwd_plan).
//
// K5. A block owns runs of whole image rows of one sample, a tile of 16 or
// 32 input channels and a tile of 16..64 output channels, and computes all
// nine taps of dW for them. It stages the run's x halo tile, (R+2) x (W+2)
// pixels with zeros outside the image, and the dY tile once; x and dY
// leave L2 once per (channel tile, Cout tile) and no index is divided in
// the inner loop.
//  * dY is staged in the padded layout with zeros in the two pad columns,
//    so the products of pad pixels are multiplied by zero.
//  * Each of the eight warps keeps one 16-channel x 16-Cout fragment pair
//    of all nine taps (72 fp32 registers) and uses one dY fragment for
//    nine products. Where the tile has fewer than eight such pairs the
//    warps share the run's 16-pixel steps and are added, in order, through
//    shared memory at the end.
//  * The wrapper plans rows per run, runs per block and the splits S
//    (ops/cuda_conv.py :: dw_plan); a run never crosses a sample.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 row padding in shared memory (16 B)
constexpr int kFwdThreads = 256;  // K4: eight warps per block
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kFwdStages = 2;     // K4: buffers in the ring
constexpr int kSlice = 16;        // K4: input channels per slice of K
constexpr int kLdh = kSlice + kPad;  // K4: halo tile row, 48 bytes
constexpr int kDwThreads = 256;  // K5: eight warps per block
constexpr int kDwWarps = kDwThreads / 32;
constexpr int kDwStages = 2;     // K5: buffers in the ring
// K5: pixels kept zero after the halo tile. The last fragment of a run
// starts below R*(W+2) rounded up to 16, reads 16 pixels and is shifted by
// at most 2*(W+2) + 2, so it ends at most 17 pixels past the tile.
constexpr int kDwSlack = 24;

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

// Four 8x8 bf16 matrices: lane l gives the address of row l % 8 of matrix
// l / 8; register j holds elements (lane / 4, 2 * (lane % 4) + {0, 1}) of
// matrix j.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// The same, transposed: register j holds elements (2 * (lane % 4) + {0,
// 1}, lane / 4) of matrix j.
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

// K4's weight tile of one slice, all nine taps. Forward, [tap][k][n]: 16
// rows of BN + 8, read by ldmatrix.trans. Rotated, [tap][n][k]: BN rows of
// 16 + 8, contiguous along the input channel as the forward weights are,
// read by ldmatrix. A stage holds the larger of the two.
template <int BN>
struct FwdTile {
  static constexpr int kLdw = BN + kPad;
  static constexpr int kWElems =
      9 * (kSlice * kLdw > BN * kLdh ? kSlice * kLdw : BN * kLdh);
};

// The padded width: one halo column where one strip holds the whole width.
__host__ __device__ __forceinline__ int fwd_wp(int seg, int w) {
  return seg >= w ? seg + 1 : seg + 2;
}

// The dynamic shared memory of K4's first pass: the ring of (halo tile,
// weight tile) buffers.
size_t fwd_shared_bytes(int bn, int fm, int wp) {
  const size_t halo = static_cast<size_t>(kFwdWarps) * 16 * fm + 2 * wp + 2;
  const int w_elems = bn == 16 ? FwdTile<16>::kWElems : FwdTile<32>::kWElems;
  return kFwdStages * sizeof(bf16) * (halo * kLdh + w_elems);
}

// K4: where a thread's first pixel of the halo tile lies in the padded
// space (H + 1 rows per sample after row 0, wp columns), and what `step`
// pixels add, so that staging follows its pixels without dividing.
struct HaloWalk {
  int b, rr, pc;  // sample, row in it (0 is the zero row), padded column
  int db, drr, dpc;
};

__device__ __forceinline__ HaloWalk halo_walk(long long first, int h, int wp,
                                              int step, int lead) {
  const long long p = first + lead;  // >= -1: the pixel before row 1
  HaloWalk walk;
  const long long row = p < 0 ? -1 : p / wp;
  walk.pc = static_cast<int>(p - row * wp);
  walk.b = row < 0 ? -1 : static_cast<int>(row / (h + 1));
  walk.rr = static_cast<int>(row - static_cast<long long>(walk.b) * (h + 1));
  const int drow = step / wp;
  walk.dpc = step - drow * wp;
  walk.db = drow / (h + 1);
  walk.drr = drow - walk.db * (h + 1);
  return walk;
}

// K4: stages the halo tile, n_px padded pixels of strip `col0` from the
// walk's start on, channels c0 .. c0+15 of x (batch, h, w, cin), into
// dst[p * kLdh + c]. Zero outside the image, in the zero rows and past the
// last channel. With vec (cin % 8 == 0, 16-byte aligned) by cp.async,
// else by element loads. A thread takes one 16-byte chunk of a pixel (vec)
// or one pixel, every `step` pixels.
__device__ __forceinline__ void stage_halo(bf16* dst,
                                           const bf16* __restrict__ x,
                                           HaloWalk walk, int n_px, int batch,
                                           int h, int w, int cin, int c0,
                                           int col0, int wp, bool vec) {
  const int per_px = vec ? kSlice / 8 : 1;
  const int step = kFwdThreads / per_px;
  const int j = vec ? (threadIdx.x % per_px) * 8 : 0;
  const int real = vec ? (c0 + j < cin ? 8 : 0) : min(kSlice, cin - c0);
  for (int p = threadIdx.x / per_px; p < n_px; p += step) {
    const int col = col0 + walk.pc - 1;
    const bool ok = real > 0 && walk.b >= 0 && walk.b < batch &&
                    walk.rr >= 1 && col >= 0 && col < w;
    const bf16* from =
        x + (ok ? ((static_cast<size_t>(walk.b) * h + walk.rr - 1) * w + col) *
                          cin + c0 + j
                : 0);
    bf16* to = dst + p * kLdh + j;
    if (vec) {
      cp_async16(to, from, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int c = 0; c < kSlice; ++c)
        to[c] = ok && c < real ? from[c] : __float2bfloat16(0.f);
    }
    walk.pc += walk.dpc;
    walk.rr += walk.drr;
    walk.b += walk.db;
    if (walk.pc >= wp) {
      walk.pc -= wp;
      ++walk.rr;
    }
    if (walk.rr > h) {
      walk.rr -= h + 1;
      ++walk.b;
    }
  }
}

// K4: stages the nine taps' weights of input channels c0 .. c0+15 and
// output channels n0 .. n0+BN-1, zero past either end. Forward: B(tap*cin
// + c, n) = w[(tap*cin + c)*cout + n] at dst[(tap*16 + c)*kLdw + n].
// Rotated (dX): the operand is the forward weights (9*cout, cin) turned
// 180 degrees with in and out channels swapped, B(tap*cin + c, n) =
// w[((8 - tap)*cout + n)*cin + c], at dst[(tap*BN + n)*kLdh + c]. With vec
// (the contiguous dimension a multiple of 8, 16-byte aligned) by cp.async,
// else by element loads.
template <int BN, bool kRot>
__device__ __forceinline__ void stage_weights(bf16* dst,
                                              const bf16* __restrict__ w,
                                              int c0, int n0, int cin,
                                              int cout, bool vec) {
  constexpr int kLdw = FwdTile<BN>::kLdw;
  if (vec && !kRot) {  // chunks of 8 output channels
    for (int v = threadIdx.x; v < 9 * kSlice * (BN / 8); v += kFwdThreads) {
      const int n = (v % (BN / 8)) * 8, r = v / (BN / 8);  // r = tap*16 + c
      const int tap = r / kSlice, c = r % kSlice;
      const bool ok = c0 + c < cin && n0 + n < cout;
      const bf16* from =
          w + (ok ? (static_cast<size_t>(tap) * cin + c0 + c) * cout + n0 + n
                  : 0);
      cp_async16(dst + r * kLdw + n, from, ok ? 16 : 0);
    }
  } else if (vec) {  // chunks of 8 input channels
    for (int v = threadIdx.x; v < 9 * BN * 2; v += kFwdThreads) {
      const int c = (v % 2) * 8, r = v / 2;  // r = tap*BN + n
      const int tap = r / BN, n = r % BN;
      const bool ok = c0 + c < cin && n0 + n < cout;
      const bf16* from =
          w + (ok ? (static_cast<size_t>(8 - tap) * cout + n0 + n) * cin + c0 +
                        c
                  : 0);
      cp_async16(dst + r * kLdh + c, from, ok ? 16 : 0);
    }
  } else if (!kRot) {
    for (int e = threadIdx.x; e < 9 * kSlice * BN; e += kFwdThreads) {
      const int n = e % BN, r = e / BN, tap = r / kSlice, c = r % kSlice;
      dst[r * kLdw + n] =
          c0 + c < cin && n0 + n < cout
              ? w[(static_cast<size_t>(tap) * cin + c0 + c) * cout + n0 + n]
              : __float2bfloat16(0.f);
    }
  } else {
    for (int e = threadIdx.x; e < 9 * BN * kSlice; e += kFwdThreads) {
      const int c = e % kSlice, r = e / kSlice, tap = r / BN, n = r % BN;
      dst[r * kLdh + c] =
          c0 + c < cin && n0 + n < cout
              ? w[(static_cast<size_t>(8 - tap) * cout + n0 + n) * cin + c0 + c]
              : __float2bfloat16(0.f);
    }
  }
}

// K4: two fragments of 8 output channels by 16 input channels from the
// weight tile (see stage_weights for the layouts).
template <bool kRot>
__device__ __forceinline__ void load_weight_pair(unsigned (&r)[4],
                                                 unsigned addr) {
  if constexpr (kRot)
    ldmatrix_x4(r, addr);
  else
    ldmatrix_x4_trans(r, addr);
}

// K4, first pass, for x (batch, h, w, cin) and y (batch, h, w, cout).
// Block (x, y, z) computes padded positions [wp + t*BM, wp + (t+1)*BM) of
// strip x / tiles_per_strip (t = x % tiles_per_strip), output channels
// [y*BN, (y+1)*BN) and slices [z*slices_per_split, ..) of K. With partial
// null (one split): y = bf16(sum + bias) (bias may be null: zero); else
// partial[z, pixel, n] = the fp32 sum over its slices.
template <int BN, int FM, bool kRot>
__global__ void __launch_bounds__(kFwdThreads, 2)
conv3x3_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const bf16* __restrict__ bias, bf16* __restrict__ y,
                   float* __restrict__ partial, int batch, int h, int w_,
                   int cin, int cout, int seg, int tiles_per_strip,
                   int slices_per_split, bool vec_x, bool vec_w) {
  constexpr int kBM = kFwdWarps * 16 * FM;
  constexpr int kLdw = FwdTile<BN>::kLdw;
  extern __shared__ __align__(128) unsigned char fwd_smem[];
  bf16* ring = reinterpret_cast<bf16*>(fwd_smem);

  const int wp = fwd_wp(seg, w_);
  const int halo_px = kBM + 2 * wp + 2;
  const int halo_elems = halo_px * kLdh;
  const int stage_elems = halo_elems + FwdTile<BN>::kWElems;
  const int strip = blockIdx.x / tiles_per_strip;
  const int col0 = strip * seg;  // the image column of padded column 1
  const long long q0 =
      wp + static_cast<long long>(blockIdx.x - strip * tiles_per_strip) * kBM;
  const long long q_end = static_cast<long long>(batch) * (h + 1) * wp;
  const int n0 = blockIdx.y * BN;
  const int slices = (cin + kSlice - 1) / kSlice;
  const int s_begin = blockIdx.z * slices_per_split;
  const int s_end = min(slices, s_begin + slices_per_split);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Tap (dy, dx) of position q reads padded pixel q + (dy-1)*wp + (dx-1):
  // the halo tile starts at q0 - wp - 1.
  const int per_px = vec_x ? kSlice / 8 : 1;
  const HaloWalk walk = halo_walk(q0 - wp - 1, h, wp, kFwdThreads / per_px,
                                  threadIdx.x / per_px);
  auto stage_slice = [&](int slice, int stage) {
    bf16* buf = ring + stage * stage_elems;
    stage_halo(buf, x, walk, halo_px, batch, h, w_, cin, slice * kSlice, col0,
               wp, vec_x);
    stage_weights<BN, kRot>(buf + halo_elems, w, slice * kSlice, n0, cin, cout,
                            vec_w);
  };

  float acc[FM][BN / 8][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  // Byte offsets of this lane's ldmatrix rows. x (A, pixels x channels):
  // matrices (pixels 0-7, channels 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
  // 8-15). Weights (B, two fragments of 8 output channels): forward, by
  // .trans from [k][n], (k 0-7, n 0-7), (8-15, 0-7), (0-7, 8-15), (8-15,
  // 8-15); rotated, from [n][k], (n 0-7, k 0-7), (0-7, 8-15), (8-15, 0-7),
  // (8-15, 8-15).
  const unsigned a_lane =
      2 * ((warp * 16 * FM + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdh +
           (lane >> 4) * 8);
  const unsigned b_lane =
      kRot ? 2 * (((lane & 7) + (lane >> 4) * 8) * kLdh + ((lane >> 3) & 1) * 8)
           : 2 * (((lane & 7) + ((lane >> 3) & 1) * 8) * kLdw + (lane >> 4) * 8);
  constexpr unsigned kTapBytes = 2 * (kRot ? BN * kLdh : kSlice * kLdw);
  constexpr unsigned kPairBytes = 2 * (kRot ? 16 * kLdh : 16);
  const unsigned row_bytes = 2 * kLdh * wp;  // one padded row down (dy)

  if (s_begin < s_end) stage_slice(s_begin, 0);
  cp_async_commit();
  for (int slice = s_begin; slice < s_end; ++slice) {
    const int stage = (slice - s_begin) % kFwdStages;
    // The other buffer was last read before the barrier that ended the
    // slice before this one.
    if (slice + 1 < s_end) stage_slice(slice + 1, (stage + 1) % kFwdStages);
    cp_async_commit();
    cp_async_wait<1>();  // all but the newest group: this slice has landed
    __syncthreads();
    const unsigned xs = smem_addr(ring + stage * stage_elems);
    const unsigned ws = xs + 2 * halo_elems + b_lane;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const unsigned a_tap =
          xs + a_lane + (tap / 3) * row_bytes + (tap % 3) * (2 * kLdh);
      const unsigned b_tap = ws + tap * kTapBytes;
      unsigned b[BN / 16][4];
#pragma unroll
      for (int jj = 0; jj < BN / 16; ++jj)
        load_weight_pair<kRot>(b[jj], b_tap + jj * kPairBytes);
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        unsigned a[4];
        ldmatrix_x4(a, a_tap + i * (16 * 2 * kLdh));
#pragma unroll
        for (int jj = 0; jj < BN / 16; ++jj) {
          mma_bf16(acc[i][2 * jj], a, b[jj][0], b[jj][1]);
          mma_bf16(acc[i][2 * jj + 1], a, b[jj][2], b[jj][3]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  // Registers 2 * half + {0, 1} of fragment (i, j): position q0 + warp's
  // first + 16 i + lane / 4 + 8 half, output channels 8 j + 2 (lane % 4) +
  // {0, 1}. Positions in the zero rows, the halo columns or past the image
  // are dropped.
  float* out = partial == nullptr
                   ? nullptr
                   : partial + blockIdx.z * static_cast<size_t>(batch) * h *
                                   w_ * cout;
  const bool pairs = cout % 2 == 0;  // 4- or 8-byte stores
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long q = q0 + warp * 16 * FM + i * 16 + lane / 4 + 8 * half;
      if (q >= q_end) continue;
      const long long row = q / wp;
      const int pc = static_cast<int>(q - row * wp);
      const int b = static_cast<int>(row / (h + 1));
      const int rr = static_cast<int>(row - static_cast<long long>(b) * (h + 1));
      const int col = col0 + pc - 1;
      if (rr < 1 || pc < 1 || pc > seg || col >= w_) continue;
      const size_t at =
          ((static_cast<size_t>(b) * h + rr - 1) * w_ + col) * cout;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (n >= cout) continue;
        float v0 = acc[i][j][2 * half], v1 = acc[i][j][2 * half + 1];
        if (partial != nullptr) {
          if (pairs) {
            *reinterpret_cast<float2*>(out + at + n) = make_float2(v0, v1);
          } else {
            out[at + n] = v0;
            if (n + 1 < cout) out[at + n + 1] = v1;
          }
          continue;
        }
        if (bias != nullptr) {
          v0 += __bfloat162float(bias[n]);
          if (n + 1 < cout) v1 += __bfloat162float(bias[n + 1]);
        }
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(y + at + n) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          y[at + n] = __float2bfloat16_rn(v0);
          if (n + 1 < cout) y[at + n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// K4, second pass: y[i] = bf16(sum over s of partial[s, i] + bias[i %
// cout]) in a fixed order, four values a thread: by 16-byte loads and
// 8-byte stores where cout % 4 == 0, else one at a time.
__global__ void __launch_bounds__(256)
conv3x3_fwd_reduce_kernel(const float* __restrict__ partial,
                          const bf16* __restrict__ bias, bf16* __restrict__ y,
                          long long count, int cout, int splits) {
  const long long i0 = (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * 4;
  if (i0 >= count) return;
  if (cout % 4 == 0) {
    float4 s = *reinterpret_cast<const float4*>(partial + i0);
    for (int p = 1; p < splits; ++p) {
      const float4 t = *reinterpret_cast<const float4*>(partial + p * count + i0);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    if (bias != nullptr) {
      const int n = static_cast<int>(i0 % cout);
      s.x += __bfloat162float(bias[n]);
      s.y += __bfloat162float(bias[n + 1]);
      s.z += __bfloat162float(bias[n + 2]);
      s.w += __bfloat162float(bias[n + 3]);
    }
    __nv_bfloat162* to = reinterpret_cast<__nv_bfloat162*>(y + i0);
    to[0] = __floats2bfloat162_rn(s.x, s.y);
    to[1] = __floats2bfloat162_rn(s.z, s.w);
    return;
  }
  for (long long i = i0; i < i0 + 4 && i < count; ++i) {
    float s = partial[i];
    for (int p = 1; p < splits; ++p) s += partial[p * count + i];
    if (bias != nullptr) s += __bfloat162float(bias[i % cout]);
    y[i] = __float2bfloat16_rn(s);
  }
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

template <int BN, int FM, bool kRot>
cudaError_t launch_fwd(dim3 grid, size_t smem, cudaStream_t st, const bf16* x,
                       const bf16* w, const bf16* bias, bf16* y,
                       float* partial, int batch, int h, int w_, int cin,
                       int cout, int seg, int tiles_per_strip,
                       int slices_per_split, bool vec_x, bool vec_w) {
  auto* kernel = conv3x3_fwd_kernel<BN, FM, kRot>;
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
  kernel<<<grid, kFwdThreads, smem, st>>>(x, w, bias, y, partial, batch, h, w_,
                                          cin, cout, seg, tiles_per_strip,
                                          slices_per_split, vec_x, vec_w);
  return cudaGetLastError();
}

using FwdLaunch = decltype(&launch_fwd<16, 1, false>);

// K4's instantiations: BN = 16 or 32 by FM = 1, 2 or 4 (at most 64 fp32
// sums a thread); null for any other.
template <bool kRot>
FwdLaunch fwd_launch(int bn, int fm) {
  static constexpr FwdLaunch table[2][3] = {
      {launch_fwd<16, 1, kRot>, launch_fwd<16, 2, kRot>, launch_fwd<16, 4, kRot>},
      {launch_fwd<32, 1, kRot>, launch_fwd<32, 2, kRot>, launch_fwd<32, 4, kRot>}};
  const int i = bn == 16 ? 0 : bn == 32 ? 1 : -1;
  const int j = fm == 1 ? 0 : fm == 2 ? 1 : fm == 4 ? 2 : -1;
  return i < 0 || j < 0 ? nullptr : table[i][j];
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

// The dynamic shared memory K4's first pass asks for with output-channel
// tile bn, fm fragments of 16 positions per warp and segments of seg of
// the w columns; ops/cuda_conv.py :: fwd_shared_bytes counts the same.
size_t conv3x3_fwd_shared_bytes(int bn, int fm, int seg, int w) {
  return fwd_shared_bytes(bn, fm, fwd_wp(seg, w));
}

// K4 on `stream`: y (batch, h, w, cout) = conv3x3(x (batch, h, w, cin), W)
// + bias, all bf16, channels-last, contiguous. rotated == 0: wgt is W as
// (9*cin, cout). rotated != 0 (dX): wgt is the forward weights (9*cout,
// cin) of the conv whose input gradient this is, read rotated. bias may be
// null. The plan (ops/cuda_conv.py :: fwd_plan): output-channel tile bn,
// fm, segments of seg columns and `splits` runs of the 16-channel slices
// of K; with splits > 1, partial is fp32 scratch of splits * batch*h*w *
// cout values (unused, and may be null, with one split). vec_x / vec_w
// allow 16-byte loads of x / wgt (cin % 8 == 0; cout % 8 == 0 unrotated or
// cin % 8 == 0 rotated; 16-byte aligned pointers). Two launches, one with
// one split; returns the first cudaError_t either reports.
int conv3x3_fwd_bf16(const void* x, const void* wgt, const void* bias, void* y,
                     float* partial, int batch, int h, int w, int cin,
                     int cout, int rotated, int bn, int fm, int seg,
                     int splits, int vec_x, int vec_w, void* stream) {
  const FwdLaunch launch =
      rotated ? fwd_launch<true>(bn, fm) : fwd_launch<false>(bn, fm);
  const int slices = (cin + kSlice - 1) / kSlice;
  if (launch == nullptr || batch <= 0 || h <= 0 || w <= 0 || cin <= 0 ||
      cout <= 0 || seg <= 0 || seg > w || splits <= 0 || splits > slices ||
      splits > 65535 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_split = (slices + splits - 1) / splits;
  const int wp = fwd_wp(seg, w);
  const long long rows = static_cast<long long>(batch) * (h + 1);
  const long long tiles = ((rows - 1) * wp + kFwdWarps * 16 * fm - 1) /
                          (kFwdWarps * 16 * fm);
  const long long strips = (w + seg - 1) / seg;
  const long long n_tiles = (cout + bn - 1) / bn;
  if ((slices + per_split - 1) / per_split != splits ||
      tiles * strips > INT_MAX || n_tiles > 65535 ||
      fwd_shared_bytes(bn, fm, wp) > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* bp = static_cast<const bf16*>(bias);
  auto* yp = static_cast<bf16*>(y);
  const cudaError_t err = launch(
      dim3(static_cast<unsigned>(tiles * strips), n_tiles, splits),
      fwd_shared_bytes(bn, fm, wp), st, static_cast<const bf16*>(x),
      static_cast<const bf16*>(wgt), bp, yp, splits > 1 ? partial : nullptr,
      batch, h, w, cin, cout, seg, static_cast<int>(tiles), per_split,
      vec_x != 0, vec_w != 0);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long count = static_cast<long long>(batch) * h * w * cout;
  conv3x3_fwd_reduce_kernel<<<static_cast<unsigned>((count + 1023) / 1024),
                              256, 0, st>>>(partial, bp, yp, count, cout,
                                            splits);
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
