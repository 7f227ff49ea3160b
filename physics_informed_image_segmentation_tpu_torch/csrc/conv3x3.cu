// 3x3, stride-1, SAME (zero-padded) NHWC convolution for Hopper (sm_90a):
// forward (two tap orders) and weight gradient.
//
// Replaces the Pallas TPU kernels of
// physics_informed_image_segmentation_tpu/ops/pallas_conv.py::conv3x3_same:
// _fwd_kernel and _fwd_kernel_paired (pallas_call in _conv_fwd_raw, which the
// VJP also runs on the cotangent for dx) and _dw_kernel (pallas_call in
// _conv_dw_raw).
//
//   out[b, y, x, co] = sum_t sum_ci x[b, y+dy_t, x+dx_t, ci] * w[t, ci, co]
//   dw[t, ci, co]    = sum_{b,y,x} x[b, y+dy_t, x+dx_t, ci] * g[b, y, x, co]
//
// with the taps t = 0..8 in row-major order, (dy, dx) = (t/3 - 1, t%3 - 1),
// and x read as 0 outside the image.  Operands are bf16 or float32, every
// product and sum is float32, the forward rounds once to the operand type and
// dw stays float32.
//
// Tap order of the forward.  Row-major: each tap's Cin products are summed,
// then the nine tap sums enter the accumulator in the order 0..8.  Paired:
// the centre tap first, then the pairs (0,8), (1,7), (2,6), (3,5), each
// pair's 2*Cin products summed together before they enter the accumulator.
// On the TPU the paired kernel fills a 128-deep matrix unit with a
// channel-duplicated input; nothing of that applies here, so on this card the
// paired row measures an order of summation, not a deeper contraction.  The
// CUDA-core and wmma kernels keep a tap group's sum apart until it is whole;
// the wgmma kernels feed the products into one accumulator in the same order
// of taps.  The plain PyTorch version states what is computed; the kernels
// differ from it by float32 rounding only.
//
// Bound.  At (8,128,128,64)->64 in bf16 the forward reads x (16.8 MB) and
// writes out (16.8 MB): 0.0100 ms at 3.35 TB/s; its 9.66 GFLOP take 0.0098 ms
// on the bf16 tensor cores (989 TFLOP/s), so bytes and operations are level.
// dW reads x and g: the same.  Neither is near its bound: what the kernels
// below fight is latency (a tile loaded, then computed, with nothing in
// flight) and shared-memory traffic (weights staged again for every tile).
//
// Three sets of kernels, chosen by what the operands are and by nothing else
// (conv3x3_fwd_kernel_set, conv3x3_dw_kernel_set):
//
//   wgmma       bf16, 16-byte aligned pointers, Cout % 64 == 0 and
//               Cin == 64 or 128 (forward: nine taps' weights must fit in
//               shared memory beside one input tile) or Cin % 64 == 0 (dW).
//               Any B, H and W.
//   wmma        the other bf16 operands with Cin % 16 == 0 and 16-byte
//               aligned pointers.
//   CUDA cores  float32, and bf16 with another Cin or alignment.
//
// All three compute the same sums; the forward's tap orders stay two stated
// orders of float32 summation.
//
// Design of the wgmma kernels (Hopper: TMA, mbarrier ring, wgmma):
// * Both are persistent: at most one block an SM, block i walks the 8x16
//   pixel tiles i, i + gridDim.x, ...  TMA loads run ahead of the products
//   into a ring of tile stages in shared memory, handed over with one "full"
//   and one "empty" mbarrier a stage; one thread starts them (the forward's
//   producer warp; in dW the block's first thread, see there).  The tensor
//   maps are 4-d (C, W, H, B) with the 128-byte swizzle, so TMA's zero fill
//   outside the image is the SAME padding and the ragged last tiles, and a
//   pixel's 64 channels are one 128-byte swizzled line.
// * Tap shifts against the swizzle.  A dx shift moves an operand by one
//   128-byte line, which is not a multiple of the 1024-byte swizzle atom, so a
//   wgmma descriptor cannot simply start one pixel later.  Both kernels
//   therefore load the shifted operand (A) into registers with ldmatrix, each
//   lane computing its line's swizzled address: any pixel offset, no conflicts
//   (8 consecutive lines have 8 different swizzle phases), one halo tile
//   instead of three shifted copies.  wgmma takes A from registers; B, which
//   is never shifted, is read from shared memory through a descriptor
//   (N-contiguous rows of 128 bytes, 128-byte swizzle, trans-b).
// * forward (conv3x3_fwd_wgmma_kernel): the nine taps' weights for the block's
//   64 output channels are loaded once by TMA (73,728 bytes at Cin 64) and
//   stay for all tiles.  Two consumer warpgroups take 4 rows x 16 pixels each
//   (M = 64; a warp owns one pixel row), N = 64, K = 16 channels a step.  A
//   tile's taps enter ONE float32 accumulator in the variant's order (row-major:
//   taps 0..8; paired: 4, then 0, 8, 1, 7, 2, 6, 3, 5), channels ascending
//   inside a tap: no second accumulator and no adds.  The next step's ldmatrix
//   runs while the last step's wgmma are in flight (two A register sets).  The
//   stage is released as soon as its last ldmatrix has run.  The epilogue rounds
//   to bf16 into a swizzled shared tile and leaves by a TMA store (clipped at
//   the image's edge) that overlaps the next tile's products.  For dx the same
//   kernel reads the convolution's own weights transposed (tap t takes the
//   transpose of w[8 - t], whose tile wgmma reads without trans-b), so no
//   second copy of the weights is laid out.
// * dW (conv3x3_dw_wgmma_kernel): three warpgroups, one a kernel row, hold
//   all nine taps' 64x64 float32 accumulators in registers (96 a thread) for
//   the whole walk; x (with halo) and g tiles are loaded once for all nine
//   taps.  The contraction runs over pixels, 16 (one tile row) a step:
//   A = x^T through ldmatrix.trans at the tap's column offset, B = g.  Each
//   block writes one (9, Cin, Cout) partial; conv3x3_dw_finish_kernel adds the
//   partials in a fixed order (8 interleaved groups in parallel, then the 8
//   group sums in order), so dW repeats bit for bit: no atomics.
// * What bounds them now is shared-memory bandwidth: at N = 64 a wgmma reads
//   its 2 KB of B in the 32 cycles it computes (64 of the SM's 128 bytes a
//   cycle), ldmatrix brings as many bytes of A, and TMA writes the tiles.
//
// Design of the CUDA-core kernels (simple and right first):
// * forward: a block owns an 8x16 tile of output pixels and 64 output
//   channels.  It loads the tile's 10x18 input pixels, halo included, once
//   from x into shared memory as float32 (zeros outside the image, so there
//   are no row-shifted copies of the input and no column mask, and W need not
//   be a power of two), and stages the weights of one tap group (one tap, or a
//   pair) at a time.  A thread owns one pixel column of the tile (8 pixels) and
//   4 output channels: per input channel it reads 8 inputs and one float4 of
//   weights for 32 FMAs.  The group's sum is kept in registers and added to the
//   accumulator when the group ends.  Shared memory grows with Cin (above 48 KB
//   it is dynamic, set with cudaFuncSetAttribute); the entry point refuses what
//   does not fit.
// * dW: blocks run in no order, so nothing is accumulated across them.  Block
//   (j, t, chunk) walks the 64-pixel tiles j, j + n_blocks, ... for tap t and a
//   64x64 chunk of (ci, co), stages the shifted x pixels and g as float32, and
//   each thread keeps a 4x4 patch of the chunk in registers.  Each block writes
//   one (9, Cin, Cout) partial; a second launch adds the n_blocks partials in a
//   fixed order.  No atomics, so a run repeats bit for bit; the caller bounds
//   n_blocks (one partial is 9*Cin*Cout*4 bytes).
//
// Design of the wmma kernels (bf16, wmma m16n16k16, float32 sums):
// * forward: the same 8x16 tile and 64 output channels a block, the input
//   tile and several tap groups' weights (as many as fit beside a second
//   block on the SM) in shared memory as bf16 (16-byte copies).  The tile is
//   16 pixels wide so that one pixel row is the 16 rows of an A fragment,
//   read straight from the halo tile at the tap's offset:
//   no im2col copy.  A warp owns 2 pixel rows and 32 output channels (2x2
//   accumulator fragments, and 2x2 more for the running tap group).  The
//   accumulators leave through a per-warp 16x16 float tile in shared memory,
//   rounded once to bf16.
// * dW: block (j, dy, chunk) walks spatial 8x16 tiles for the three taps of
//   one kernel row; the contraction runs over pixels, 16 at a time (one pixel
//   row of the tile): A is the x tile read column-major (channels by pixels)
//   at the tap's column offset, B the g tile.  A warp owns 16 input channels
//   and 32 output channels for the 3 taps (6 fragments).  Partials and the
//   fixed-order second pass as above.
//
// Every entry point launches on the caller's stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileH = 8;          // output rows of a tile = pixels of a thread
constexpr int kTileW = 16;         // output columns of a tile
constexpr int kInH = kTileH + 2;   // input rows of a tile, halo included
constexpr int kInW = kTileW + 2;
constexpr int kCoutTile = 64;      // output channels of a block: 16 threads x 4
constexpr int kMaxShared = 232448; // bytes a block can use on sm_90

constexpr int kDwPixels = 64;      // pixels of a dW tile
constexpr int kDwChan = 64;        // (ci, co) chunk of a dW block: 64 x 64

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_float(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_float(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// Shared memory of the forward, in floats: weights of the staged taps
// [slots][Cin][kCoutTile], then the input tile [kInH * kInW][Cin + 1].  The
// odd pixel stride keeps neighbouring columns in different banks.
__host__ __device__ inline int fwd_shared_floats(int cin, int slots) {
  return slots * cin * kCoutTile + kInH * kInW * (cin + 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, int H,
                   int W, int Cin, int Cout, int tiles_y, int tiles_x, int paired) {
  extern __shared__ __align__(16) float smem[];
  const int slots = paired ? 2 : 1;
  const int cin_p = Cin + 1;
  float* s_w = smem;
  float* s_in = smem + slots * Cin * kCoutTile;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tx = tid % 16;  // output channels 4*tx .. 4*tx+3 of the block's 64
  const int ty = tid / 16;  // pixel column of the tile

  int tile = blockIdx.x;
  const int tile_x = tile % tiles_x;
  tile /= tiles_x;
  const int tile_y = tile % tiles_y;
  const int b = tile / tiles_y;
  const int y0 = tile_y * kTileH;
  const int x0 = tile_x * kTileW;
  const int co0 = blockIdx.y * kCoutTile;

  // the input tile with its halo, zeros outside the image
  for (int pix = warp; pix < kInH * kInW; pix += kWarps) {
    const int gy = y0 + pix / kInW - 1;
    const int gx = x0 + pix % kInW - 1;
    const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const T* src = x + (((size_t)b * H + (inside ? gy : 0)) * W + (inside ? gx : 0)) * Cin;
    for (int k = lane; k < Cin; k += 32) s_in[pix * cin_p + k] = inside ? to_float(src[k]) : 0.f;
  }

  float acc[kTileH][4];
#pragma unroll
  for (int r = 0; r < kTileH; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  const int n_groups = paired ? 5 : 9;
  for (int group = 0; group < n_groups; ++group) {
    // taps of this group: one tap, or the pair (t, 8 - t)
    int tap0 = group;
    int tap1 = group;
    int n_taps = 1;
    if (paired) {
      tap0 = group == 0 ? 4 : group - 1;
      tap1 = 8 - tap0;
      n_taps = group == 0 ? 1 : 2;
    }

    __syncthreads();  // the previous group has been read (and, first, s_in written)
    for (int s = 0; s < n_taps; ++s) {
      const T* wt = w + (size_t)(s == 0 ? tap0 : tap1) * Cin * Cout;
      for (int i = tid; i < Cin * kCoutTile; i += kThreads) {
        const int k = i / kCoutTile;
        const int c = i % kCoutTile;
        s_w[s * Cin * kCoutTile + i] = (co0 + c < Cout) ? to_float(wt[(size_t)k * Cout + co0 + c]) : 0.f;
      }
    }
    __syncthreads();

    float part[kTileH][4];
#pragma unroll
    for (int r = 0; r < kTileH; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[r][j] = 0.f;

    for (int s = 0; s < n_taps; ++s) {
      const int tap = s == 0 ? tap0 : tap1;
      const int dy = tap / 3 - 1;
      const int dx = tap % 3 - 1;
      // output pixel (r, ty) reads input pixel (r + 1 + dy, ty + 1 + dx) of the tile
      const float* xcol = s_in + ((1 + dy) * kInW + (ty + 1 + dx)) * cin_p;
      const float* wrow = s_w + s * Cin * kCoutTile + 4 * tx;
#pragma unroll 4
      for (int k = 0; k < Cin; ++k) {
        const float4 w4 = *reinterpret_cast<const float4*>(wrow + k * kCoutTile);
#pragma unroll
        for (int r = 0; r < kTileH; ++r) {
          const float xv = xcol[r * kInW * cin_p + k];
          part[r][0] = fmaf(xv, w4.x, part[r][0]);
          part[r][1] = fmaf(xv, w4.y, part[r][1]);
          part[r][2] = fmaf(xv, w4.z, part[r][2]);
          part[r][3] = fmaf(xv, w4.w, part[r][3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kTileH; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] += part[r][j];
  }

  const int gx = x0 + ty;
  if (gx < W) {
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {
      const int gy = y0 + r;
      if (gy < H) {
        T* dst = out + (((size_t)b * H + gy) * W + gx) * Cout;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int co = co0 + 4 * tx + j;
          if (co < Cout) from_float(acc[r][j], dst + co);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_partials_kernel(const T* __restrict__ x, const T* __restrict__ g,
                           float* __restrict__ partials, int H, int W, int Cin, int Cout,
                           int n_pix, int cout_chunks) {
  __shared__ __align__(16) float s_x[kDwPixels * kDwChan];
  __shared__ __align__(16) float s_g[kDwPixels * kDwChan];
  __shared__ int s_src[kDwPixels];  // pixel index of the shifted x pixel, -1 outside

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int t = blockIdx.y;
  const int dy = t / 3 - 1;
  const int dx = t % 3 - 1;
  const int ci0 = (blockIdx.z / cout_chunks) * kDwChan;
  const int co0 = (blockIdx.z % cout_chunks) * kDwChan;
  const int tci = 4 * (tid / 16);  // this thread's 4 input channels of the chunk
  const int tco = 4 * (tid % 16);  // and its 4 output channels

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int n_tiles = (n_pix + kDwPixels - 1) / kDwPixels;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int q0 = tile * kDwPixels;
    __syncthreads();  // the previous tile has been read
    if (tid < kDwPixels) {
      const int q = q0 + tid;
      int src = -1;
      if (q < n_pix) {
        const int sx = q % W + dx;
        const int row = q / W;  // b * H + y
        const int sy = row % H + dy;
        if (sy >= 0 && sy < H && sx >= 0 && sx < W) src = q + dy * W + dx;
      }
      s_src[tid] = src;
    }
    __syncthreads();
    for (int p = warp; p < kDwPixels; p += kWarps) {
      const int q = q0 + p;
      const int src = s_src[p];
      for (int c = lane; c < kDwChan; c += 32) {
        float xv = 0.f, gv = 0.f;
        if (src >= 0 && ci0 + c < Cin) xv = to_float(x[(size_t)src * Cin + ci0 + c]);
        if (q < n_pix && co0 + c < Cout) gv = to_float(g[(size_t)q * Cout + co0 + c]);
        s_x[p * kDwChan + c] = xv;
        s_g[p * kDwChan + c] = gv;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int p = 0; p < kDwPixels; ++p) {
      const float4 xv = *reinterpret_cast<const float4*>(s_x + p * kDwChan + tci);
      const float4 gv = *reinterpret_cast<const float4*>(s_g + p * kDwChan + tco);
      const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
      const float gs[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xs[i], gs[j], acc[i][j]);
    }
  }

  float* dst = partials + ((size_t)blockIdx.x * 9 + t) * Cin * Cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = ci0 + tci + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tco + j;
      if (ci < Cin && co < Cout) dst[(size_t)ci * Cout + co] = acc[i][j];
    }
  }
}

// dw from the partials, in a fixed order: group q adds the partials q, q + 8,
// q + 16, ... in that order, then the 8 group sums are added in the order
// 0..7.  A block owns 32 columns of V floats (V = 4: 16-byte loads, 512
// contiguous bytes a warp); a warp is one group.
constexpr int kFinishGroups = 8;

template <int V>
__global__ void __launch_bounds__(32 * kFinishGroups)
conv3x3_dw_finish_kernel(const float* __restrict__ partials, float* __restrict__ dw, int n_blocks,
                         int n) {
  __shared__ float s_sum[kFinishGroups][32 * V];
  const int col = threadIdx.x % 32;
  const int group = threadIdx.x / 32;
  const int i = (blockIdx.x * 32 + col) * V;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  if (i < n) {
#pragma unroll 4
    for (int j = group; j < n_blocks; j += kFinishGroups) {
      const float* src = partials + (size_t)j * n + i;
      if constexpr (V == 4) {
        const float4 p = *reinterpret_cast<const float4*>(src);
        acc[0] += p.x;
        acc[1] += p.y;
        acc[2] += p.z;
        acc[3] += p.w;
      } else {
        acc[0] += *src;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) s_sum[group][col * V + v] = acc[v];
  __syncthreads();
  if (group == 0 && i < n) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float total = s_sum[0][col * V + v];
#pragma unroll
      for (int q = 1; q < kFinishGroups; ++q) total += s_sum[q][col * V + v];
      dw[i + v] = total;
    }
  }
}

// ---------------------------------------------------------------------------
// wmma kernels: bf16 operands, Cin % 16 == 0.

using namespace nvcuda;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
using AFragRow = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using AFragCol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using BFrag = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;

// Padding after every shared-memory row, in bf16.  A fragments start at any
// pixel, and wmma wants a fragment's address 32-byte aligned: 16 (rows i and
// i + 4 then share banks, a 2-way conflict).  B fragments start at multiples of
// 16 rows, so their rows may be 144 bytes apart, which is free of conflicts.
constexpr int kMmaPad = 16;
constexpr int kLdA = kDwChan + kMmaPad;  // row stride of dW's x tile
constexpr int kLdW = kCoutTile + 8;      // row stride of the staged weights and of g
constexpr int kScratchFloats = kWarps * 256;  // one 16x16 float tile per warp
constexpr int kDwXPix = kTileH * kInW;        // x pixels of a dW tile: 8 rows x 18 columns
constexpr int kDwMmaShared =
    (kDwXPix * kLdA + kTileH * kTileW * kLdW) * 2 + kScratchFloats * 4;

__host__ __device__ inline int fwd_mma_shared_bytes(int cin, int slots) {
  return (kInH * kInW * (cin + kMmaPad) + slots * cin * kLdW) * 2 + kScratchFloats * 4;
}

// Taps whose weights the forward stages in one round: as many as fit in half
// an SM's shared memory (two blocks an SM), at least one tap group.
inline int fwd_mma_slots(int cin, int paired) {
  const int budget = 110 * 1024;
  int slots = (budget - fwd_mma_shared_bytes(cin, 0)) / (cin * kLdW * 2);
  const int least = paired ? 2 : 1;
  return slots < least ? least : (slots > 9 ? 9 : slots);
}

// 8 consecutive bf16 to 16-byte aligned shared memory: the first `valid` from
// src, zeros after them.  `vec`: src is 16-byte aligned wherever valid >= 8.
__device__ __forceinline__ void copy8(__nv_bfloat16* dst, const __nv_bfloat16* src, int valid,
                                      bool vec) {
  if (valid >= 8 && vec) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    return;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) dst[q] = q < valid ? src[q] : __float2bfloat16_rn(0.f);
}

__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       __nv_bfloat16* __restrict__ out, int H, int W, int Cin, int Cout,
                       int tiles_y, int tiles_x, int paired, int slots, int vec) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  const int ld_in = Cin + kMmaPad;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kInH * kInW][ld_in]
  __nv_bfloat16* s_w = s_in + kInH * kInW * ld_in;                   // [slots][Cin][kLdW]
  float* s_scr = reinterpret_cast<float*>(s_w + slots * Cin * kLdW);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  int tile = blockIdx.x;
  const int tile_x = tile % tiles_x;
  tile /= tiles_x;
  const int tile_y = tile % tiles_y;
  const int b = tile / tiles_y;
  const int y0 = tile_y * kTileH;
  const int x0 = tile_x * kTileW;
  const int co0 = blockIdx.y * kCoutTile;

  // the input tile with its halo, zeros outside the image, 8 channels a copy
  const int vec_per_pix = Cin / 8;
  for (int i = tid; i < kInH * kInW * vec_per_pix; i += kThreads) {
    const int pix = i / vec_per_pix;
    const int v = i - pix * vec_per_pix;
    const int gy = y0 + pix / kInW - 1;
    const int gx = x0 + pix % kInW - 1;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      val = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + gy) * W + gx) * Cin + 8 * v);
    }
    *reinterpret_cast<uint4*>(s_in + pix * ld_in + 8 * v) = val;
  }

  const int r0 = 2 * (warp % 4);   // this warp's pixel rows r0, r0 + 1
  const int n0 = 32 * (warp / 4);  // and its output channels n0 .. n0 + 31 of the block's 64
  AccFrag acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // Tap groups in the order they enter the accumulator: group g of the
  // row-major order is tap g; of the paired order the centre tap, then the
  // pairs (g - 1, 9 - g).  A round stages the weights of as many whole groups
  // as fit in `slots` taps.
  const int n_groups = paired ? 5 : 9;
  int group = 0;
  while (group < n_groups) {
    int round_end = group;
    int staged = 0;
    while (round_end < n_groups) {
      const int size = (paired && round_end > 0) ? 2 : 1;
      if (staged + size > slots) break;
      staged += size;
      ++round_end;
    }

    __syncthreads();  // the previous round has been read (and, first, s_in written)
    int slot = 0;
    for (int gi = group; gi < round_end; ++gi) {
      const int n_taps = (paired && gi > 0) ? 2 : 1;
      for (int s = 0; s < n_taps; ++s, ++slot) {
        const int tap = !paired ? gi : (gi == 0 ? 4 : (s == 0 ? gi - 1 : 9 - gi));
        const __nv_bfloat16* wt = w + (size_t)tap * Cin * Cout;
        for (int i = tid; i < Cin * (kCoutTile / 8); i += kThreads) {
          const int k = i / (kCoutTile / 8);
          const int v = i % (kCoutTile / 8);
          const int co = co0 + 8 * v;
          copy8(s_w + (slot * Cin + k) * kLdW + 8 * v, wt + (size_t)k * Cout + co, Cout - co, vec);
        }
      }
    }
    __syncthreads();

    slot = 0;
    for (int gi = group; gi < round_end; ++gi) {
      AccFrag part[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(part[i][j], 0.f);

      const int n_taps = (paired && gi > 0) ? 2 : 1;
      for (int s = 0; s < n_taps; ++s, ++slot) {
        const int tap = !paired ? gi : (gi == 0 ? 4 : (s == 0 ? gi - 1 : 9 - gi));
        const int dy = tap / 3 - 1;
        const int dx = tap % 3 - 1;
        // A: rows are the 16 pixels of a pixel row, read at the tap's offset
        const __nv_bfloat16* a0p = s_in + ((r0 + 1 + dy) * kInW + 1 + dx) * ld_in;
        const __nv_bfloat16* a1p = a0p + kInW * ld_in;
        const __nv_bfloat16* bp = s_w + slot * Cin * kLdW + n0;
        for (int k0 = 0; k0 < Cin; k0 += 16) {
          AFragRow a0, a1;
          BFrag b0, b1;
          wmma::load_matrix_sync(a0, a0p + k0, ld_in);
          wmma::load_matrix_sync(a1, a1p + k0, ld_in);
          wmma::load_matrix_sync(b0, bp + k0 * kLdW, kLdW);
          wmma::load_matrix_sync(b1, bp + k0 * kLdW + 16, kLdW);
          wmma::mma_sync(part[0][0], a0, b0, part[0][0]);
          wmma::mma_sync(part[0][1], a0, b1, part[0][1]);
          wmma::mma_sync(part[1][0], a1, b0, part[1][0]);
          wmma::mma_sync(part[1][1], a1, b1, part[1][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < acc[i][j].num_elements; ++e) acc[i][j].x[e] += part[i][j].x[e];
    }
    group = round_end;
  }

  // out: each fragment through this warp's float tile; a lane rounds and
  // writes 8 channels of one pixel
  float* scr = s_scr + warp * 256;
  const int m = lane / 2;         // pixel column of the tile
  const int c8 = 8 * (lane % 2);  // first of the lane's 8 channels in the fragment
  const int gx = x0 + m;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gy = y0 + r0 + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int co = co0 + n0 + 16 * j + c8;
      if (gy < H && gx < W && co < Cout) {
        __nv_bfloat16* dst = out + (((size_t)b * H + gy) * W + gx) * Cout + co;
        const float* src = scr + m * 16 + c8;
        if (vec && co + 8 <= Cout) {
          __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) packed[q] = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
        } else {
          for (int q = 0; q < 8 && co + q < Cout; ++q) dst[q] = __float2bfloat16_rn(src[q]);
        }
      }
      __syncwarp();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
conv3x3_dw_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ partials, int B, int H, int W, int Cin, int Cout,
                      int tiles_y, int tiles_x, int cout_chunks, int vec) {
  extern __shared__ __align__(128) unsigned char smem_mma[];
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem_mma);  // [kTileH][kInW][kLdA]
  __nv_bfloat16* s_g = s_x + kDwXPix * kLdA;                        // [kTileH * kTileW][kLdW]
  float* s_scr = reinterpret_cast<float*>(s_g + kTileH * kTileW * kLdW);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int dy = (int)blockIdx.y - 1;  // this block's taps: 3 * blockIdx.y + {0, 1, 2}
  const int ci0 = (blockIdx.z / cout_chunks) * kDwChan;
  const int co0 = (blockIdx.z % cout_chunks) * kDwChan;
  const int mi = warp % 4;  // input channels ci0 + 16 * mi .. + 15
  const int nh = warp / 4;  // output channels co0 + 32 * nh .. + 31

  AccFrag acc[3][2];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int n_tiles = B * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int rest = tile;
    const int x0 = (rest % tiles_x) * kTileW;
    rest /= tiles_x;
    const int y0 = (rest % tiles_y) * kTileH;
    const int b = rest / tiles_y;

    __syncthreads();  // the previous tile has been read
    // x rows y0 + dy .. + 7, columns x0 - 1 .. x0 + 16, zeros outside the image
    for (int i = tid; i < kDwXPix * (kDwChan / 8); i += kThreads) {
      const int pix = i / (kDwChan / 8);
      const int v = i % (kDwChan / 8);
      const int gy = y0 + pix / kInW + dy;
      const int gx = x0 + pix % kInW - 1;
      const int ci = ci0 + 8 * v;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && ci < Cin) {  // Cin % 16 == 0: all 8 exist
        val = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + gy) * W + gx) * Cin + ci);
      }
      *reinterpret_cast<uint4*>(s_x + pix * kLdA + 8 * v) = val;
    }
    // g at the tile's pixels, zeros outside the image and beyond Cout
    for (int i = tid; i < kTileH * kTileW * (kDwChan / 8); i += kThreads) {
      const int pix = i / (kDwChan / 8);
      const int v = i % (kDwChan / 8);
      const int gy = y0 + pix / kTileW;
      const int gx = x0 + pix % kTileW;
      const int co = co0 + 8 * v;
      const bool inside = gy < H && gx < W;
      const __nv_bfloat16* src = g + (((size_t)b * H + (inside ? gy : 0)) * W + (inside ? gx : 0)) * Cout + co;
      copy8(s_g + pix * kLdW + 8 * v, src, inside ? Cout - co : 0, vec);
    }
    __syncthreads();

    // the contraction runs over pixels: one pixel row (16 pixels) a step
    for (int r = 0; r < kTileH; ++r) {
      BFrag b0, b1;
      wmma::load_matrix_sync(b0, s_g + r * kTileW * kLdW + 32 * nh, kLdW);
      wmma::load_matrix_sync(b1, s_g + r * kTileW * kLdW + 32 * nh + 16, kLdW);
#pragma unroll
      for (int dxi = 0; dxi < 3; ++dxi) {
        // A (channels x pixels), column-major: pixel c of the row sits at
        // column c + 1 + dx = c + dxi of the x tile
        AFragCol a;
        wmma::load_matrix_sync(a, s_x + (r * kInW + dxi) * kLdA + 16 * mi, kLdA);
        wmma::mma_sync(acc[dxi][0], a, b0, acc[dxi][0]);
        wmma::mma_sync(acc[dxi][1], a, b1, acc[dxi][1]);
      }
    }
  }

  float* scr = s_scr + warp * 256;
  const int m = lane / 2;
  const int c8 = 8 * (lane % 2);
  const int ci = ci0 + 16 * mi + m;
#pragma unroll
  for (int dxi = 0; dxi < 3; ++dxi) {
    const int tap = 3 * (int)blockIdx.y + dxi;
    float* dst = partials + ((size_t)blockIdx.x * 9 + tap) * Cin * Cout + (size_t)ci * Cout;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(scr, acc[dxi][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int co = co0 + 32 * nh + 16 * j + c8;
      if (ci < Cin) {
        for (int q = 0; q < 8 && co + q < Cout; ++q) dst[co + q] = scr[m * 16 + c8 + q];
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------------------
// wgmma kernels: bf16 operands, Cin and Cout multiples of 64.

constexpr int kLineBytes = 128;  // a pixel's 64 bf16 channels: one swizzled line
// the 10 x 18 input pixels of a tile, halo included; swizzle atoms are 1024 bytes
constexpr int kXTileBytes = kInH * kInW * kLineBytes;
constexpr int kXTileStride = (kXTileBytes + 1023) / 1024 * 1024;
constexpr int kTile64Bytes = 64 * kLineBytes;  // 64 lines: a tap's weights, or 64 output pixels
constexpr int kGTileBytes = kTileH * kTileW * kLineBytes;  // dW's g tile
constexpr int kDwStageBytes = kXTileStride + kGTileBytes;
constexpr int kBarrierBytes = 1024;   // the mbarriers, before the first tile
constexpr int kMaxStages = 4;         // of the forward's ring
constexpr int kFwdConsumerWarps = 8;  // 2 warpgroups
constexpr int kFwdThreads = 32 * (kFwdConsumerWarps + 1);
constexpr int kDwWarps = 12;  // 3 warpgroups, one a kernel row
constexpr int kDwThreads = 32 * kDwWarps;
constexpr int kDwStages = 4;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 128-byte swizzle of TMA and wgmma: in every 1024 bytes, the 16-byte
// chunk (address bits 4-6) of line l (bits 7-9) moves to chunk ^ l.  `addr` is
// the unswizzled address in a tile that starts on a 1024-byte boundary.
__device__ __forceinline__ uint32_t swizzle128(uint32_t addr) {
  return addr ^ ((addr >> 3) & 0x70u);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(arrivals) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of this parity is over.  A barrier that is
// never completed (a wrong byte count, a load that faulted) traps after about
// a second instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  long long start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start == 0) start = now;
    if (now - start > 2000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Descriptors of a B operand of 16 rows (the contraction) by 64 columns in a
// tile of 128-byte lines with the 128-byte swizzle, on a 1024-byte boundary.
//
// Columns contiguous (read with trans-b): a line is one row of the
// contraction.  `addr` is the first of the 16 lines and a multiple of 1024;
// the second group of 8 lines lies 1024 bytes on (the stride offset).  The
// leading offset, the way to a second 64 columns, is not used at N = 64.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1024 >> 4} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// Contraction contiguous (no trans-b): a line is one column, and its 64
// elements are 4 steps of the contraction.  `addr` is the tile's first line
// plus 32 bytes a step; groups of 8 columns lie 1024 bytes apart (the stride
// offset); the leading offset is not used with a swizzle.
__device__ __forceinline__ uint64_t b_desc_k_major(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

// d (64 x 64, float32) = a (64 x 16 bf16, in registers) * b (16 x 64 bf16, in
// shared memory) + (scale_d ? d : 0), asynchronously.  kTransB: b's columns
// are contiguous (b_desc), not its rows of the contraction (b_desc_k_major).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16(float* d, const uint32_t* a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d), "n"(kTransB));
}

// Barrier of the 128 threads of consumer warpgroup `wg` (barrier 0 is __syncthreads's).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void st_shared_bf16x2(uint32_t addr, float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(*reinterpret_cast<const uint32_t*>(&v))
               : "memory");
}

// Tile `tile` of the walk: its image and its first output pixel.
__device__ __forceinline__ void tile_origin(int tile, int tiles_y, int tiles_x, int* b, int* y0,
                                            int* x0) {
  *x0 = (tile % tiles_x) * kTileW;
  tile /= tiles_x;
  *y0 = (tile % tiles_y) * kTileH;
  *b = tile / tiles_y;
}

// Tap that enters the accumulator at place `i` of the paired order:
// 4, then the pairs (0,8), (1,7), (2,6), (3,5).
__host__ __device__ constexpr int paired_tap(int i) {
  return i == 0 ? 4 : ((i - 1) % 2 ? 8 - (i - 1) / 2 : (i - 1) / 2);
}

// Forward.  Shared memory, from a 1024-byte boundary: the mbarriers; the
// weights [9][kChunks] tiles of 64 input channels (lines) x 64 output
// channels; `stages` input tiles of [kChunks][10 * 18 lines]; one output tile
// of 64 pixels (lines) x 64 channels a consumer warpgroup.
//
// kTransposed computes the input gradient of a convolution from that
// convolution's own weights: map_w is then of w (9, Cout, Cin), and tap t
// multiplies by the transpose of w[8 - t].  Its tiles are 64 output channels
// (lines) x 64 input channels, which wgmma reads without trans-b.
template <int kChunks, bool kPaired, bool kTransposed>
__global__ void __launch_bounds__(kFwdThreads, 1)
conv3x3_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_out, int n_tiles, int tiles_y,
                         int tiles_x, int stages) {
  extern __shared__ unsigned char smem_wgmma[];
  const uint32_t base = (smem_u32(smem_wgmma) + 1023u) & ~1023u;
  const uint32_t bar_full = base;         // [stages]: a tile has landed
  const uint32_t bar_empty = base + 64;   // [stages]: every consumer warp has read it
  const uint32_t bar_w = base + 128;      // the weights have landed
  const uint32_t s_w = base + kBarrierBytes;
  const uint32_t s_x = s_w + 9 * kChunks * kTile64Bytes;
  const uint32_t s_out = s_x + stages * kChunks * kXTileStride;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int co0 = blockIdx.y * 64;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kFwdConsumerWarps);
    }
    mbar_init(bar_w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kFwdConsumerWarps) {
    // producer: one thread starts every load
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_w, 9 * kChunks * kTile64Bytes);
      for (int t = 0; t < 9; ++t) {
        for (int c = 0; c < kChunks; ++c) {
          const uint32_t w_tile = s_w + (t * kChunks + c) * kTile64Bytes;
          if (kTransposed) {
            tma_load_3d(w_tile, &map_w, bar_w, 64 * c, co0, 8 - t);
          } else {
            tma_load_3d(w_tile, &map_w, bar_w, co0, 64 * c, t);
          }
        }
      }
      int s = 0;
      uint32_t parity = 1;  // a fresh barrier counts as released
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int b, y0, x0;
        tile_origin(tile, tiles_y, tiles_x, &b, &y0, &x0);
        mbar_wait(bar_empty + 8 * s, parity);
        mbar_arrive_expect_tx(bar_full + 8 * s, kChunks * kXTileBytes);
        for (int c = 0; c < kChunks; ++c)
          tma_load_4d(s_x + (s * kChunks + c) * kXTileStride, &map_x, bar_full + 8 * s, 64 * c,
                      x0 - 1, y0 - 1, b);
        if (++s == stages) {
          s = 0;
          parity ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows 4 * wg .. + 3 of the tile, its warp wq one row
  const int wg = warp / 4;
  const int wq = warp % 4;
  // ldmatrix: lanes 0-7, 8-15, 16-23, 24-31 give the row addresses of the four
  // 8x8 parts of a 16 pixel x 16 channel A fragment: pixels 0-7 and 8-15 at
  // the first 8 channels, then at the second 8
  const int a_pixel = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_half = lane >> 4;
  // that pixel's channels, before the tap's shift, as bytes into an input tile
  const uint32_t a_offset = ((4 * wg + wq + 1) * kInW + a_pixel + 1) * kLineBytes + 16 * a_half;
  const uint32_t out_tile = s_out + wg * kTile64Bytes;
  const bool wg_leader = wq == 0 && lane == 0;
  // the accumulator's element 4j + {0, 1} is pixel m0, channels 8j + 2 * (lane % 4) + {0, 1};
  // 4j + {2, 3} the same channels of pixel m0 + 8
  const int m0 = 16 * wq + lane / 4;
  const uint32_t out_m0 = out_tile + m0 * kLineBytes + 4 * (lane % 4);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  mbar_wait(bar_w, 0);
  int s = 0;
  uint32_t parity = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    int b, y0, x0;
    tile_origin(tile, tiles_y, tiles_x, &b, &y0, &x0);
    mbar_wait(bar_full + 8 * s, parity);
    const uint32_t a_tile = s_x + s * kChunks * kXTileStride + a_offset;

    uint32_t a[2][16];
#pragma unroll
    for (int step = 0; step < 9 * kChunks; ++step) {
      const int tap = kPaired ? paired_tap(step / kChunks) : step / kChunks;
      const int c = step % kChunks;
      const int shift = ((tap / 3 - 1) * kInW + (tap % 3 - 1)) * kLineBytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        ldmatrix_x4(&a[step % 2][4 * ks], swizzle128(a_tile + c * kXTileStride + shift + 32 * ks));
      if (step == 9 * kChunks - 1) {
        // the tile is in registers or already multiplied: hand the stage back
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      }
      wgmma_fence();
      const uint32_t w_tile = s_w + (tap * kChunks + c) * kTile64Bytes;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if (kTransposed) {
          wgmma_m64n64k16<0>(acc, &a[step % 2][4 * ks], b_desc_k_major(w_tile + 32 * ks),
                             step > 0 || ks > 0);
        } else {
          wgmma_m64n64k16<1>(acc, &a[step % 2][4 * ks], b_desc(w_tile + ks * 16 * kLineBytes),
                             step > 0 || ks > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();  // the step before has read its A registers
    }
    wgmma_wait<0>();

    // epilogue: round to bf16 into the warpgroup's output tile (swizzled as
    // the store's map wants it), then one thread stores it
    if (wg_leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    warpgroup_sync(wg);  // the last store has read the tile
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t at = out_m0 + ((j ^ (m0 & 7)) << 4);
      st_shared_bf16x2(at, acc[4 * j], acc[4 * j + 1]);
      st_shared_bf16x2(at + 8 * kLineBytes, acc[4 * j + 2], acc[4 * j + 3]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // TMA will read these writes
    warpgroup_sync(wg);
    if (wg_leader) {
      tma_store_4d(&map_out, out_tile, co0, x0, y0 + 4 * wg, b);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (++s == stages) {
      s = 0;
      parity ^= 1;
    }
  }
  if (wg_leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// dW.  Block (j, chunk) walks the tiles j, j + gridDim.x, ... for a 64 x 64
// chunk of (ci, co) and writes partial j.  Shared memory, from a 1024-byte
// boundary: the mbarriers, then kDwStages times an x tile (10 * 18 lines of
// 64 input channels) and a g tile (8 * 16 lines of 64 output channels).
//
// Three warpgroups and no producer warp: registers are handed out by the
// warpgroup, so a fourth would leave 128 a thread, too few for 96 sums, the A
// fragments and addresses (ptxas then serialises the wgmma).  With 384
// threads there are 168.  The block's first thread starts the loads instead:
// before it works on tile i it refills the stage of tile i - 1, which the
// other warps have all but left, with tile i + kDwStages - 1.
__global__ void __launch_bounds__(kDwThreads, 1)
conv3x3_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_g, float* __restrict__ partials,
                        int Cin, int Cout, int n_tiles, int tiles_y, int tiles_x, int cout_chunks) {
  extern __shared__ unsigned char smem_wgmma[];
  const uint32_t base = (smem_u32(smem_wgmma) + 1023u) & ~1023u;
  const uint32_t bar_full = base;        // [kDwStages]: a tile has landed
  const uint32_t bar_empty = base + 64;  // [kDwStages]: every warp has read it
  const uint32_t s_stage = base + kBarrierBytes;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int ci0 = (blockIdx.y / cout_chunks) * 64;
  const int co0 = (blockIdx.y % cout_chunks) * 64;
  const bool loader = threadIdx.x == 0;

  // the loads of walk step `it` (tile blockIdx.x + it * gridDim.x), if there is one
  auto load = [&](int it) {
    const int tile = blockIdx.x + it * gridDim.x;
    if (tile >= n_tiles) return;
    int b, y0, x0;
    tile_origin(tile, tiles_y, tiles_x, &b, &y0, &x0);
    const int s = it % kDwStages;
    const uint32_t x_tile = s_stage + s * kDwStageBytes;
    mbar_arrive_expect_tx(bar_full + 8 * s, kXTileBytes + kGTileBytes);
    tma_load_4d(x_tile, &map_x, bar_full + 8 * s, ci0, x0 - 1, y0 - 1, b);
    tma_load_4d(x_tile + kXTileStride, &map_g, bar_full + 8 * s, co0, x0, y0, b);
  };

  if (loader) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kDwWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int it = 0; it < kDwStages - 1; ++it) load(it);
  }
  __syncthreads();

  // warpgroup `ky` owns kernel row ky (dy = ky - 1), taps 3 * ky + {0, 1, 2};
  // its warp wq the input channels ci0 + 16 * wq .. + 15
  const int ky = warp / 4;
  const int wq = warp % 4;
  // ldmatrix.trans: the four 8x8 parts of a 16 channel x 16 pixel A fragment are
  // stored as pixels x channels: lanes 0-7 give pixels 0-7 at the first 8
  // channels, 8-15 the same pixels at the second 8, 16-31 the pixels 8-15
  const int a_pixel = (lane & 7) + (lane >> 4) * 8;
  const int a_chunk = 2 * wq + ((lane >> 3) & 1);
  // output pixel (r, c) meets input pixel (r + dy, c + dx): line (r + ky, c + kx) of
  // the halo tile; this lane's bytes into an x tile at r = kx = 0
  const uint32_t a_offset = (ky * kInW + a_pixel) * kLineBytes + 16 * a_chunk;

  float acc[3][32];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[kx][i] = 0.f;

  for (int it = 0; blockIdx.x + it * gridDim.x < n_tiles; ++it) {
    if (loader) {
      // step it + kDwStages - 1 takes the stage that step it - 1 gives back
      if (it > 0) mbar_wait(bar_empty + 8 * ((it - 1) % kDwStages), ((it - 1) / kDwStages) & 1);
      load(it + kDwStages - 1);
    }
    __syncwarp();
    const int s = it % kDwStages;
    const uint32_t x_tile = s_stage + s * kDwStageBytes;
    const uint32_t g_tile = x_tile + kXTileStride;
    mbar_wait(bar_full + 8 * s, (it / kDwStages) & 1);

    uint32_t a[2][12];
#pragma unroll
    for (int r = 0; r < kTileH; ++r) {  // 16 pixels of the contraction: row r of the tile
#pragma unroll
      for (int kx = 0; kx < 3; ++kx)
        ldmatrix_x4_trans(&a[r % 2][4 * kx],
                          swizzle128(x_tile + a_offset + (r * kInW + kx) * kLineBytes));
      wgmma_fence();
      const uint64_t g_rows = b_desc(g_tile + r * kTileW * kLineBytes);
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) wgmma_m64n64k16<1>(acc[kx], &a[r % 2][4 * kx], g_rows, 1);
      wgmma_commit();
      wgmma_wait<1>();  // the row before has read its A registers
    }
    wgmma_wait<0>();  // and g: the stage can go back
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
  }

  // element 4j + {0, 1} of an accumulator is (ci, co) = (m0, 8j + 2 * (lane % 4) + {0, 1}),
  // 4j + {2, 3} the same columns of row m0 + 8
  const int m0 = 16 * wq + lane / 4;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float* dst = partials + (((size_t)blockIdx.x * 9 + 3 * ky + kx) * Cin + ci0 + m0) * Cout +
                 co0 + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[kx][4 * j], acc[kx][4 * j + 1]);
      *reinterpret_cast<float2*>(dst + (size_t)8 * Cout + 8 * j) =
          make_float2(acc[kx][4 * j + 2], acc[kx][4 * j + 3]);
    }
  }
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The kernel sets, and the one that these operands take.  `aligned`: every
// pointer of the call is 16-byte aligned.
enum KernelSet { kCudaCores = 0, kWmma = 1, kWgmma = 2 };

inline int fwd_kernel_set(int is_bf16, int Cin, int Cout, bool aligned) {
  if (!is_bf16 || !aligned || Cin % 16 != 0) return kCudaCores;
  // weights of 9 taps x Cin x 64 and one input tile must fit: Cin 64 or 128
  if ((Cin == 64 || Cin == 128) && Cout % 64 == 0) return kWgmma;
  return kWmma;
}

inline int dw_kernel_set(int is_bf16, int Cin, int Cout, bool aligned) {
  if (!is_bf16 || !aligned || Cin % 16 != 0) return kCudaCores;
  if (Cin % 64 == 0 && Cout % 64 == 0) return kWgmma;
  return kWmma;
}

inline int sm_count() {
  int device = 0, n = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1) {
    return 1;
  }
  return n;
}

inline long long tiles_8x16(int B, int H, int W) {
  return (long long)B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
}

// Stages of input tiles beside the forward's resident weights and output tiles.
inline int fwd_wgmma_fixed_bytes(int chunks) {
  return 1024 + kBarrierBytes + 9 * chunks * kTile64Bytes + 2 * kTile64Bytes;
}
inline int fwd_wgmma_stages(int chunks) {
  const int stages = (kMaxShared - fwd_wgmma_fixed_bytes(chunks)) / (chunks * kXTileStride);
  return stages > kMaxStages ? kMaxStages : stages;
}
inline int fwd_wgmma_shared_bytes(int chunks) {
  return fwd_wgmma_fixed_bytes(chunks) + fwd_wgmma_stages(chunks) * chunks * kXTileStride;
}
constexpr int kDwWgmmaShared = 1024 + kBarrierBytes + kDwStages * kDwStageBytes;

// Blocks that walk the tiles in the dW kernels; each writes one partial.
constexpr int kDwBlocks = 64;      // CUDA-core kernel, 64-pixel tiles
// wmma kernel, 8x16 tiles: 3 blocks (one a kernel row) walk the same
// tiles, and 3 x 88 blocks are one wave of 2 blocks an SM on an H100's 132 SMs
constexpr int kDwMmaBlocks = 88;
// wgmma kernel: one block an SM, shared between the (ci, co) chunks

inline int dw_blocks(int set, int B, int H, int W, int Cin, int Cout) {
  long long tiles, cap;
  if (set == kWgmma) {
    tiles = tiles_8x16(B, H, W);
    cap = sm_count() / ((Cin / 64) * (Cout / 64));
    if (cap < 1) cap = 1;
  } else if (set == kWmma) {
    tiles = tiles_8x16(B, H, W);
    cap = kDwMmaBlocks;
  } else {
    tiles = ((long long)B * H * W + kDwPixels - 1) / kDwPixels;
    cap = kDwBlocks;
  }
  return (int)(tiles < cap ? tiles : cap);
}

template <typename T>
int launch_fwd(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
               int paired, cudaStream_t s) {
  const int shared = fwd_shared_floats(Cin, paired ? 2 : 1) * (int)sizeof(float);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const dim3 grid((unsigned)(B * tiles_y * tiles_x), (unsigned)((Cout + kCoutTile - 1) / kCoutTile));
  conv3x3_fwd_kernel<T><<<grid, kThreads, shared, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out), H, W, Cin, Cout,
      tiles_y, tiles_x, paired);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dw_partials(const void* x, const void* g, float* partials, int B, int H, int W, int Cin,
                       int Cout, int n_blocks, cudaStream_t s) {
  const int cin_chunks = (Cin + kDwChan - 1) / kDwChan;
  const int cout_chunks = (Cout + kDwChan - 1) / kDwChan;
  const dim3 grid((unsigned)n_blocks, 9u, (unsigned)(cin_chunks * cout_chunks));
  conv3x3_dw_partials_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), partials, H, W, Cin, Cout, B * H * W,
      cout_chunks);
  return (int)cudaGetLastError();
}

int launch_fwd_mma(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
                   int paired, cudaStream_t s) {
  const int slots = fwd_mma_slots(Cin, paired);
  const int shared = fwd_mma_shared_bytes(Cin, slots);
  if (shared > kMaxShared) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(conv3x3_fwd_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const dim3 grid((unsigned)(B * tiles_y * tiles_x), (unsigned)((Cout + kCoutTile - 1) / kCoutTile));
  const int vec = Cout % 8 == 0;  // w and out are 16-byte aligned (fwd_kernel_set)
  conv3x3_fwd_mma_kernel<<<grid, kThreads, shared, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), H, W, Cin, Cout, tiles_y, tiles_x, paired, slots, vec);
  return (int)cudaGetLastError();
}

int launch_dw_mma(const void* x, const void* g, float* partials, int B, int H, int W, int Cin,
                  int Cout, int n_blocks, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(conv3x3_dw_mma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kDwMmaShared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int cin_chunks = (Cin + kDwChan - 1) / kDwChan;
  const int cout_chunks = (Cout + kDwChan - 1) / kDwChan;
  const dim3 grid((unsigned)n_blocks, 3u, (unsigned)(cin_chunks * cout_chunks));
  const int vec = Cout % 8 == 0;  // g is 16-byte aligned (dw_kernel_set)
  conv3x3_dw_mma_kernel<<<grid, kThreads, kDwMmaShared, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), partials, B, H, W,
      Cin, Cout, tiles_y, tiles_x, cout_chunks, vec);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled belongs to libcuda; it is fetched through the runtime
// so that the library links against nothing but the runtime.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess) {
      p = nullptr;
    }
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Map of a bf16 tensor whose dimensions, innermost first, are dims[0..rank):
// boxes of 64 elements of dimension 0 (one 128-byte swizzled line) by `box`.
bool encode_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[3];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr),
                dims, strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Map of an NHWC tensor (B, H, W, C): boxes of 64 channels x box_w x box_h pixels of one image.
bool encode_nhwc(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int box_w,
                 int box_h) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_w, (cuuint32_t)box_h, 1};
  return encode_map(map, ptr, 4, dims, box);
}

template <int kChunks, bool kPaired, bool kTransposed>
int launch_fwd_wgmma_as(const CUtensorMap& map_x, const CUtensorMap& map_w,
                        const CUtensorMap& map_out, int B, int H, int W, int Cout,
                        cudaStream_t s) {
  const auto kernel = conv3x3_fwd_wgmma_kernel<kChunks, kPaired, kTransposed>;
  const int shared = fwd_wgmma_shared_bytes(kChunks);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int n_tiles = B * tiles_y * tiles_x;
  const int cout_chunks = Cout / 64;
  int walkers = sm_count() / cout_chunks;  // one block an SM
  walkers = walkers < 1 ? 1 : (walkers > n_tiles ? n_tiles : walkers);
  const dim3 grid((unsigned)walkers, (unsigned)cout_chunks);
  kernel<<<grid, kFwdThreads, shared, s>>>(map_x, map_w, map_out, n_tiles, tiles_y, tiles_x,
                                           fwd_wgmma_stages(kChunks));
  return (int)cudaGetLastError();
}

template <int kChunks>
int launch_fwd_wgmma_chunks(const CUtensorMap& map_x, const CUtensorMap& map_w,
                            const CUtensorMap& map_out, int B, int H, int W, int Cout, int paired,
                            int transposed, cudaStream_t s) {
  const auto launch = transposed
                          ? (paired ? launch_fwd_wgmma_as<kChunks, true, true>
                                    : launch_fwd_wgmma_as<kChunks, false, true>)
                          : (paired ? launch_fwd_wgmma_as<kChunks, true, false>
                                    : launch_fwd_wgmma_as<kChunks, false, false>);
  return launch(map_x, map_w, map_out, B, H, W, Cout, s);
}

// `transposed`: w is (9, Cout, Cin), see the kernel.
int launch_fwd_wgmma(const void* x, const void* w, void* out, int B, int H, int W, int Cin,
                     int Cout, int paired, int transposed, cudaStream_t s) {
  CUtensorMap map_x, map_w, map_out;
  const cuuint64_t w_dims[3] = {(cuuint64_t)(transposed ? Cin : Cout),
                                (cuuint64_t)(transposed ? Cout : Cin), 9};
  const cuuint32_t w_box[3] = {64, 64, 1};
  if (!aligned16(out) || !encode_nhwc(&map_x, x, B, H, W, Cin, kInW, kInH) ||
      !encode_map(&map_w, w, 3, w_dims, w_box) ||
      !encode_nhwc(&map_out, out, B, H, W, Cout, kTileW, kTileH / 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (Cin == 64) {
    return launch_fwd_wgmma_chunks<1>(map_x, map_w, map_out, B, H, W, Cout, paired, transposed, s);
  }
  return launch_fwd_wgmma_chunks<2>(map_x, map_w, map_out, B, H, W, Cout, paired, transposed, s);
}

int launch_dw_wgmma(const void* x, const void* g, float* partials, int B, int H, int W, int Cin,
                    int Cout, int n_blocks, cudaStream_t s) {
  CUtensorMap map_x, map_g;
  if (!encode_nhwc(&map_x, x, B, H, W, Cin, kInW, kInH) ||
      !encode_nhwc(&map_g, g, B, H, W, Cout, kTileW, kTileH)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_dw_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kDwWgmmaShared);
  if (err != cudaSuccess) return (int)err;
  const int tiles_y = (H + kTileH - 1) / kTileH;
  const int tiles_x = (W + kTileW - 1) / kTileW;
  const int cout_chunks = Cout / 64;
  const dim3 grid((unsigned)n_blocks, (unsigned)((Cin / 64) * cout_chunks));
  conv3x3_dw_wgmma_kernel<<<grid, kDwThreads, kDwWgmmaShared, s>>>(
      map_x, map_g, partials, Cin, Cout, B * tiles_y * tiles_x, tiles_y, tiles_x, cout_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The kernel set (0 CUDA cores, 1 wmma, 2 wgmma) that the forward takes for
// these operands; `aligned`: x, w and out are 16-byte aligned.
int conv3x3_fwd_kernel_set(int Cin, int Cout, int is_bf16, int aligned) {
  return fwd_kernel_set(is_bf16, Cin, Cout, aligned != 0);
}

// The same for dW; `aligned`: x and g are 16-byte aligned.
int conv3x3_dw_kernel_set(int Cin, int Cout, int is_bf16, int aligned) {
  return dw_kernel_set(is_bf16, Cin, Cout, aligned != 0);
}

// Bytes of shared memory the forward needs, in the set that will run.
int conv3x3_fwd_shared_bytes(int Cin, int Cout, int paired, int is_bf16, int aligned) {
  const int set = fwd_kernel_set(is_bf16, Cin, Cout, aligned != 0);
  if (set == kWgmma) return fwd_wgmma_shared_bytes(Cin / 64);
  if (set == kWmma) return fwd_mma_shared_bytes(Cin, fwd_mma_slots(Cin, paired));
  return fwd_shared_floats(Cin, paired ? 2 : 1) * (int)sizeof(float);
}

// Partials that conv3x3_dw writes for these operands on the current
// device, in the set that will run: the size of its first grid dimension.
int conv3x3_dw_blocks(int B, int H, int W, int Cin, int Cout, int is_bf16, int aligned) {
  return dw_blocks(dw_kernel_set(is_bf16, Cin, Cout, aligned != 0), B, H, W, Cin, Cout);
}

// out (B, H, W, Cout) from x (B, H, W, Cin) and w (9, Cin, Cout), all of one
// type: is_bf16 = 0 for float32, 1 for bf16.  B * H * W < 2^31.
//
// transposed = 1 computes a convolution's input gradient from its own
// weights: x is the cotangent, w (9, Cout, Cin), and the result is
// sum_t sum_ci x[b, y+dy_t, x+dx_t, ci] * w[8 - t, co, ci].  Only the wgmma
// set reads the weights that way; for the others the caller lays them out as
// (9, Cin, Cout) first.
int conv3x3_fwd(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
                int paired, int transposed, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned = aligned16(x) && aligned16(w) && aligned16(out);
  const int set = fwd_kernel_set(is_bf16, Cin, Cout, aligned);
  if (set == kWgmma) {
    return launch_fwd_wgmma(x, w, out, B, H, W, Cin, Cout, paired, transposed, s);
  }
  if (transposed) return (int)cudaErrorInvalidValue;
  if (set == kWmma) return launch_fwd_mma(x, w, out, B, H, W, Cin, Cout, paired, s);
  if (is_bf16) return launch_fwd<__nv_bfloat16>(x, w, out, B, H, W, Cin, Cout, paired, s);
  return launch_fwd<float>(x, w, out, B, H, W, Cin, Cout, paired, s);
}

// dw (9, Cin, Cout) float32 from x (B, H, W, Cin) and g (B, H, W, Cout): the
// blocks' partials (n_blocks, 9, Cin, Cout), with n_blocks =
// conv3x3_dw_blocks(...), then the finish that adds them in a fixed order.
int conv3x3_dw(const void* x, const void* g, float* partials, float* dw, int B, int H, int W,
               int Cin, int Cout, int n_blocks, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int set = dw_kernel_set(is_bf16, Cin, Cout, aligned16(x) && aligned16(g));
  if (n_blocks != dw_blocks(set, B, H, W, Cin, Cout)) return (int)cudaErrorInvalidValue;
  int err;
  if (set == kWgmma) {
    err = launch_dw_wgmma(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
  } else if (set == kWmma) {
    err = launch_dw_mma(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
  } else if (is_bf16) {
    err = launch_dw_partials<__nv_bfloat16>(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
  } else {
    err = launch_dw_partials<float>(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
  }
  if (err != 0) return err;
  const int n = 9 * Cin * Cout;
  constexpr int threads = 32 * kFinishGroups;
  if (n % 4 == 0 && aligned16(partials) && aligned16(dw)) {
    conv3x3_dw_finish_kernel<4><<<(n / 4 + 31) / 32, threads, 0, s>>>(partials, dw, n_blocks, n);
  } else {
    conv3x3_dw_finish_kernel<1><<<(n + 31) / 32, threads, 0, s>>>(partials, dw, n_blocks, n);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
