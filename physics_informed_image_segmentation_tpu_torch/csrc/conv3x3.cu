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
// paired row measures an order of summation, not a deeper contraction.
//
// Bound.  At (8,128,128,64)->64 in bf16 the forward reads x (16.8 MB) and
// writes out (16.8 MB): 0.0100 ms at 3.35 TB/s; its 9.66 GFLOP take 0.0098 ms
// on the bf16 tensor cores (989 TFLOP/s), so bytes and operations are level.
// dW reads x and g: the same.  The CUDA-core kernels multiply in float32 and
// cannot beat 9.66 GFLOP / 67 TFLOP/s = 0.144 ms; the tensor-core kernels
// (below) use mma.sync through wmma; wgmma fed by TMA is later work.
//
// Two sets of kernels, chosen by what the operands are: float32 operands, and
// bf16 operands whose Cin is not a multiple of 16, take the CUDA-core kernels;
// bf16 operands with Cin % 16 == 0 (and 16-byte aligned pointers) take the
// tensor-core kernels, which compute the same sums in the same tap orders.
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
// Design of the tensor-core kernels (bf16, wmma m16n16k16, float32 sums):
// * forward: the same 8x16 tile and 64 output channels a block, the input
//   tile and several tap groups' weights (as many as fit beside a second
//   block on the SM) in shared memory as bf16 (16-byte copies).  The tile is 16 pixels wide so that one pixel row is the 16 rows
//   of an A fragment, read straight from the halo tile at the tap's offset:
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

__global__ void conv3x3_dw_finish_kernel(const float* __restrict__ partials,
                                         float* __restrict__ dw, int n_blocks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < n_blocks; ++j) s += partials[(size_t)j * n + i];
  dw[i] = s;
}

// ---------------------------------------------------------------------------
// Tensor-core kernels: bf16 operands, Cin % 16 == 0.

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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// bf16 operands take the tensor-core kernels when Cin is a multiple of 16
// and the pointers allow 16-byte copies.
inline bool use_mma(int is_bf16, int Cin, const void* a, const void* b) {
  return is_bf16 && Cin % 16 == 0 && aligned16(a) && aligned16(b);
}

// Blocks that walk the tiles in the dW kernels; each writes one partial.
constexpr int kDwBlocks = 64;      // CUDA-core kernel, 64-pixel tiles
// tensor-core kernel, 8x16 tiles: 3 blocks (one a kernel row) walk the same
// tiles, and 3 x 88 blocks are one wave of 2 blocks an SM on an H100's 132 SMs
constexpr int kDwMmaBlocks = 88;

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
  const int vec = Cout % 8 == 0 && aligned16(w) && aligned16(out);
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
  const int vec = Cout % 8 == 0;  // g is 16-byte aligned (use_mma)
  conv3x3_dw_mma_kernel<<<grid, kThreads, kDwMmaShared, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), partials, B, H, W,
      Cin, Cout, tiles_y, tiles_x, cout_chunks, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of shared memory the forward needs for x with Cin input channels.
int conv3x3_fwd_shared_bytes(const void* x, int Cin, int paired, int is_bf16) {
  if (use_mma(is_bf16, Cin, x, x)) return fwd_mma_shared_bytes(Cin, fwd_mma_slots(Cin, paired));
  return fwd_shared_floats(Cin, paired ? 2 : 1) * (int)sizeof(float);
}

// Partials that conv3x3_dw_partials writes for these operands: the size of
// its first grid dimension.
int conv3x3_dw_blocks(const void* x, const void* g, int B, int H, int W, int Cin, int is_bf16) {
  long long tiles;
  int cap;
  if (use_mma(is_bf16, Cin, x, g)) {
    tiles = (long long)B * ((H + kTileH - 1) / kTileH) * ((W + kTileW - 1) / kTileW);
    cap = kDwMmaBlocks;
  } else {
    tiles = ((long long)B * H * W + kDwPixels - 1) / kDwPixels;
    cap = kDwBlocks;
  }
  return (int)(tiles < cap ? tiles : cap);
}

// out (B, H, W, Cout) from x (B, H, W, Cin) and w (9, Cin, Cout), all of one
// type: is_bf16 = 0 for float32, 1 for bf16.  B * H * W < 2^31.
int conv3x3_fwd(const void* x, const void* w, void* out, int B, int H, int W, int Cin, int Cout,
                int paired, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma(is_bf16, Cin, x, x)) return launch_fwd_mma(x, w, out, B, H, W, Cin, Cout, paired, s);
  if (is_bf16) return launch_fwd<__nv_bfloat16>(x, w, out, B, H, W, Cin, Cout, paired, s);
  return launch_fwd<float>(x, w, out, B, H, W, Cin, Cout, paired, s);
}

// partials (n_blocks, 9, Cin, Cout) float32 from x (B, H, W, Cin) and
// g (B, H, W, Cout), with n_blocks = conv3x3_dw_blocks(...).
int conv3x3_dw_partials(const void* x, const void* g, float* partials, int B, int H, int W,
                        int Cin, int Cout, int n_blocks, int is_bf16, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_mma(is_bf16, Cin, x, g)) return launch_dw_mma(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
  if (is_bf16) {
    return launch_dw_partials<__nv_bfloat16>(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
  }
  return launch_dw_partials<float>(x, g, partials, B, H, W, Cin, Cout, n_blocks, s);
}

// dw (9, Cin, Cout) float32: the n_blocks partials added in order.
int conv3x3_dw_finish(const float* partials, float* dw, int n_blocks, int Cin, int Cout,
                      void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n = 9 * Cin * Cout;
  conv3x3_dw_finish_kernel<<<(n + 255) / 256, 256, 0, s>>>(partials, dw, n_blocks, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
