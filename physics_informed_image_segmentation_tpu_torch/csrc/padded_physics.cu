// Physics sums over the interior of halo-padded blocks, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// physics_informed_image_segmentation_tpu/ops/pallas_physics.py::padded_physics_sums
// (_padded_fwd_kernel, _padded_bwd_kernel, and their pallas_calls in
// _padded_fwd_call/_padded_bwd_call).
//
// Input p (B, h + 2, w + 2) float32: a spatial block whose one-pixel ghost
// ring the caller has already filled (neighbour rows from the halo exchange,
// mirrored rows and columns at the global edges).  With u = p[1:-1, 1:-1]
// and the 5-point stencils reading the ring,
//   r  = D * lap(u) [+ u (1-u) (u-a)],  gx = (E - W) / 2,  gy = (S - N) / 2,
//   sums[b] = [sum r^2, sum (eps/2)(gx^2 + gy^2) + (1/eps) u^2 (1-u)^2].
// Backward, from the (B, 2) cotangents: dp (B, h + 2, w + 2).  Nothing is
// folded here: the ghost ring receives the plain (zero-boundary) transpose
// of the stencils, and the caller's exchange routes it back to the rows it
// came from.  The pointwise terms land on the interior only.  The taps are
// cross-shaped, so the four corners of the ring receive 0.
//
// Bound: memory.  The forward reads p once (4.2 MB for one 1026x1026 block,
// 1.26 us at 3.35 TB/s); the backward reads p and writes dp, twice that.  At
// (8, 130, 130) both are a fraction of a microsecond, and one launch, not the
// bytes, is the floor: so each direction is exactly one launch and touches
// device memory once, for p and for dp.
//
// Design (K1's, csrc/physics_sums.cu, without its mask, target and folds):
// * one block per tile of tile_h x 64 interior pixels of one image (tile_h is
//   the wrapper's choice: 128 blocks at (8, 130, 130), 512 at
//   (1, 1026, 1026)), all of B x tiles in gridDim.x, so any B, h >= 1 and
//   w >= 1 works.  The TPU kernel held a whole block in VMEM.
// * a block brings its tile of p with a halo (one pixel forward, two
//   backward), clipped to the block, into shared memory with cp.async.  The
//   row pitch w + 2 is 2 mod 4 on both of the path's shapes (1026, 130), so
//   every other row starts 8 bytes off a 16-byte boundary: no 16-byte copy
//   and no TMA tensor map (its strides must be multiples of 16 bytes) fits.
//   Where w + 2 is even and p is 8-byte aligned, each row goes in 8-byte
//   copies of column pairs (the shared tile starts on an even padded column:
//   (1, 1026, 1026) and (8, 130, 130) take these); otherwise in 4-byte copies
//   (an odd w + 2 such as 53 or 35, or a misaligned p).
// * a thread owns one column of the tile and walks a quarter of its rows, so
//   a warp reads 32 neighbouring shared words (no bank conflicts) and its
//   stores of dp are coalesced; nothing divides per pixel.
// * forward: the tile's upper and lower halves go in two groups of copies,
//   so the lower half lands while the upper half is computed.  Two partial
//   sums a thread, warp shuffles, one partial per (image, sum, tile).  The
//   last block to finish (a ticket counted with an integer atomic after a
//   __threadfence) adds each image's partials in tile order, up to four warps
//   a sum when there are few images, four loads in flight a lane (or, with
//   fewer than 32 tiles an image, several sums a warp in one pass), and
//   writes (B, 2).  No float atomics, so a run repeats bit for bit; the last block
//   sets the ticket back to 0, so the workspace needs no memset and a CUDA
//   graph can replay the launch.
// * where the forward's time goes at (1, 1026, 1026) on an H100
//   (utils/k3_breakdown.py times variants of this file with a piece taken
//   out): of ~7.3 us, the last block's finish ~1.3, the fence and ticket
//   ~0.6, and a body of launch, load and compute that the instructions (~40
//   a pixel) hold, not the bytes; tiles of 16 rows are slower (9.5 us), 64
//   rows faster for the forward alone (6.6) but past the backward's 48 KB.
// * backward: one pass, no scratch in device memory.  From the two-pixel
//   halo the block computes r, gx, gy on its tile and a one-pixel ring into
//   shared memory, 0 wherever that lies outside the interior.  So every
//   interior pixel gathers the transposed stencils unguarded; only the ghost
//   ring that a block on the image's edge also owns (its adjacent ring rows
//   and columns, the corners with them) reads its taps behind guards.
//   Every padded position is written by exactly one block.
// * arithmetic in float32, the derived constants rounded once from doubles;
//   launches on PyTorch's current stream, never synchronises; each entry
//   point returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 64;                        // interior pixels across a tile
constexpr int kRowGroups = kThreads / kTileW;     // a thread walks a quarter of the rows
constexpr int kMaxTileH = 32;                     // keeps the backward under 48 KB of shared memory
constexpr int kFieldPitch = kTileW + 2;           // a field row: the tile and one column each side

struct Consts {
  float D, a, half_eps, inv_eps, two_inv_eps, eps;
  int use_reaction;
};

// Where the tiles lie: set by the host, the same for every block.
struct Grid {
  int h, w, tile_h, n_ty, n_tx;  // h, w: the interior
  int pairs;                     // w + 2 even and p 8-byte aligned: 8-byte copies
};

// The block's own tile, in interior coordinates.
struct Tile {
  int b, index;    // image, and the tile's number within it (row-major)
  int y0, x0;      // its first pixel
  int rows, cols;  // pixels of it inside the interior
};

__device__ __forceinline__ Tile tile_of_block(const Grid& g) {
  const int per_image = g.n_ty * g.n_tx;
  Tile t;
  t.b = blockIdx.x / per_image;
  t.index = blockIdx.x - t.b * per_image;
  const int ty = t.index / g.n_tx;
  t.y0 = ty * g.tile_h;
  t.x0 = (t.index - ty * g.n_tx) * kTileW;
  t.rows = min(g.tile_h, g.h - t.y0);
  t.cols = min(kTileW, g.w - t.x0);
  return t;
}

// The shared copy of p around a tile with a halo of HALO pixels:
//   sp[i * kPitch + j] = p[row_base + i, col_base + j]   (padded coordinates)
// with row_base = y0 + 1 - HALO and col_base = x0 + 2 - 2 * HALO (even, so
// that a pair of columns starts every 8-byte copy), for i < tile_h + 2 HALO
// and j < kPitch, wherever that lies in the block.  The interior pixel
// (y0, x0) is sp[HALO * kPitch + kLead].
template <int HALO>
struct Halo {
  static constexpr int kPitch = 62 + 4 * HALO;  // 66 forward, 70 backward: even
  static constexpr int kLead = 2 * HALO - 1;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Starts the copies of the shared rows [i_begin, i_end) of the tile; the
// caller commits them and waits.
template <int HALO>
__device__ __forceinline__ void copy_rows(const float* __restrict__ pb, float* sp,
                                          const Tile& tile, const Grid& g, int i_begin,
                                          int i_end) {
  constexpr int kPitch = Halo<HALO>::kPitch;
  const int hp = g.h + 2, wp = g.w + 2;
  const int row_base = tile.y0 + 1 - HALO, col_base = tile.x0 + 2 - 2 * HALO;
  const int i_lo = max(i_begin, -row_base), i_hi = min(i_end, hp - row_base);
  const int j_lo = max(0, -col_base), j_hi = min(kPitch, wp - col_base);
  const int n_rows = i_hi - i_lo;
  if (g.pairs) {
    // col_base, wp and kPitch are even, so j_lo and j_hi are: whole pairs only
    const int n_pairs = (j_hi - j_lo) / 2;
    for (int k = threadIdx.x; k < n_rows * n_pairs; k += kThreads) {
      const int q = k / n_pairs;
      const int i = i_lo + q, j = j_lo + 2 * (k - q * n_pairs);
      __pipeline_memcpy_async(sp + i * kPitch + j,
                              pb + (size_t)(row_base + i) * wp + col_base + j, 8);
    }
  } else {
    const int n_cols = j_hi - j_lo;
    for (int k = threadIdx.x; k < n_rows * n_cols; k += kThreads) {
      const int q = k / n_cols;
      const int i = i_lo + q, j = j_lo + k - q * n_cols;
      __pipeline_memcpy_async(sp + i * kPitch + j,
                              pb + (size_t)(row_base + i) * wp + col_base + j, 4);
    }
  }
}

// Of the tile rows [ra, rb), the ones [r_begin, r_end) that this thread
// walks in its column: a quarter of them.
__device__ __forceinline__ void my_rows(const Tile& tile, int ra, int rb, int& r_begin,
                                        int& r_end) {
  const int per_group = (rb - ra + kRowGroups - 1) / kRowGroups;
  r_begin = ra + threadIdx.x / kTileW * per_group;
  r_end = min(min(rb, tile.rows), r_begin + per_group);
}

// The forward's two sums over this thread's share of the tile rows [ra, rb).
__device__ __forceinline__ void fwd_rows(const float* sp, const Tile& tile, int ra, int rb,
                                         const Consts& c, float& rd, float& pf) {
  constexpr int kPitch = Halo<1>::kPitch;
  const int col = threadIdx.x % kTileW;
  int r_begin, r_end;
  my_rows(tile, ra, rb, r_begin, r_end);
  if (col >= tile.cols || r_begin >= r_end) return;
  const float* at = sp + (r_begin + 1) * kPitch + Halo<1>::kLead + col;  // the centre
  float un = at[-kPitch], uc = at[0];
  for (int r = r_begin; r < r_end; ++r, at += kPitch) {
    const float us = at[kPitch], uw = at[-1], ue = at[1];
    float rr = c.D * (un + us + uw + ue - 4.f * uc);
    if (c.use_reaction) rr += uc * (1.f - uc) * (uc - c.a);
    rd += rr * rr;
    const float gx = 0.5f * (ue - uw);
    const float gy = 0.5f * (us - un);
    const float om = 1.f - uc;
    pf += c.half_eps * (gx * gx + gy * gy) + c.inv_eps * (uc * uc) * (om * om);
    un = uc;
    uc = us;
  }
}

__global__ void __launch_bounds__(kThreads)
padded_fwd(const float* __restrict__ p, float* __restrict__ partials,
           unsigned int* __restrict__ ticket, float* __restrict__ sums, int B, const Grid g,
           const Consts c) {
  extern __shared__ float4 shared4[];
  float* sp = reinterpret_cast<float*>(shared4);  // (tile_h + 2, kPitch)

  // The tile's upper half of rows (with the halo rows around it) and the
  // rest in two groups of copies: the lower half lands while the upper
  // half is computed.
  const Tile tile = tile_of_block(g);
  const float* pb = p + (size_t)tile.b * (g.h + 2) * (g.w + 2);
  const int half = (g.tile_h + 1) / 2;
  copy_rows<1>(pb, sp, tile, g, 0, half + 2);
  __pipeline_commit();
  copy_rows<1>(pb, sp, tile, g, half + 2, g.tile_h + 2);
  __pipeline_commit();
  float rd = 0.f, pf = 0.f;
  __pipeline_wait_prior(1);
  __syncthreads();
  fwd_rows(sp, tile, 0, half, c, rd, pf);
  __pipeline_wait_prior(0);
  __syncthreads();
  fwd_rows(sp, tile, half, g.tile_h, c, rd, pf);

  __shared__ float red[2][kWarps];
  __shared__ int is_last;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per_image = g.n_ty * g.n_tx;
  rd = warp_sum(rd);
  pf = warp_sum(pf);
  if (lane == 0) {
    red[0][warp] = rd;
    red[1][warp] = pf;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float v = warp_sum(lane < kWarps ? red[i][lane] : 0.f);
      // partials are (B, 2, tiles of an image)
      if (lane == 0) partials[((size_t)tile.b * 2 + i) * per_image + tile.index] = v;
    }
    if (lane == 0) {
      // the same thread wrote this block's partials: make them visible, then count
      __threadfence();
      is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
  }
  __syncthreads();
  if (!is_last) return;

  // The last block: every other block's partials are written and visible.
  __threadfence();
  const int n_sums = 2 * B;
  if (per_image < 32) {
    // A sum takes a segment of `lanes` lanes (its tiles' count rounded up to
    // a power of two), one partial a lane, added by a fixed shuffle tree:
    // one pass for (8, 130, 130)'s 16 sums of 16 partials.
    int lanes = 1;
    while (lanes < per_image) lanes <<= 1;
    const int seg = lane / lanes, sub = lane % lanes, per_warp = 32 / lanes;
    for (int k0 = warp * per_warp; k0 < n_sums; k0 += kWarps * per_warp) {
      const int k = k0 + seg;
      float s = k < n_sums && sub < per_image ? __ldcg(partials + (size_t)k * per_image + sub)
                                              : 0.f;
      for (int off = lanes / 2; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off, lanes);
      if (sub == 0 && k < n_sums) sums[k] = s;
    }
    if (threadIdx.x == 0) *ticket = 0u;
    return;
  }
  // Sum k (image k / 2) goes to `group` warps, each over a fixed stride of
  // the tiles, and their results are added in warp order: a fixed order.
  const int group = max(1, kWarps / n_sums);  // 4 warps a sum for one image, 2 for two or three
  const int per_pass = kWarps / group;
  const int slot = warp / group, part = warp % group;
  for (int k0 = 0; k0 < n_sums; k0 += per_pass) {
    const int k = k0 + slot;
    float s = 0.f;
    if (k < n_sums) {
      // four loads in flight at a time, added one after another in tile order
      const float* src = partials + (size_t)k * per_image;
      const int stride = group * 32;
      int j = part * 32 + lane;
      for (; j + 3 * stride < per_image; j += 4 * stride) {
        const float a0 = __ldcg(src + j), a1 = __ldcg(src + j + stride);
        const float a2 = __ldcg(src + j + 2 * stride), a3 = __ldcg(src + j + 3 * stride);
        s += a0;
        s += a1;
        s += a2;
        s += a3;
      }
      for (; j < per_image; j += stride) s += __ldcg(src + j);
    }
    s = warp_sum(s);
    __syncthreads();  // the previous pass has read red
    if (lane == 0) red[0][warp] = s;
    __syncthreads();
    if (threadIdx.x < per_pass && k0 + threadIdx.x < n_sums) {
      float t = 0.f;
      for (int q = 0; q < group; ++q) t += red[0][threadIdx.x * group + q];
      sums[k0 + threadIdx.x] = t;
    }
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// dp at a ghost-ring position (y, x) (interior coordinates: y or x is -1, h
// or w) from the fields in shared memory, whose (y, x) is at `at`.  The
// position is not interior, so it has no centre tap and no pointwise term;
// each of its four taps is read only where it lies in the interior (which
// puts it on the tile's ring of fields).  The corners read nothing: 0.
__device__ __forceinline__ float ring_grad(const float* sr, const float* sgx, const float* sgy,
                                           int at, int y, int x, int h, int w, float k_lap,
                                           float k_pf) {
  const bool row_in = y >= 0 && y < h, col_in = x >= 0 && x < w;
  float lap_t = 0.f, gx_t = 0.f, gy_t = 0.f;
  if (col_in && y + 1 >= 0 && y + 1 < h) {  // the pixel below reads (y, x) as its north tap
    lap_t += sr[at + kFieldPitch];
    gy_t -= 0.5f * sgy[at + kFieldPitch];
  }
  if (col_in && y - 1 >= 0 && y - 1 < h) {  // the pixel above, as its south tap
    lap_t += sr[at - kFieldPitch];
    gy_t += 0.5f * sgy[at - kFieldPitch];
  }
  if (row_in && x + 1 >= 0 && x + 1 < w) {  // the pixel to the right, as its west tap
    lap_t += sr[at + 1];
    gx_t -= 0.5f * sgx[at + 1];
  }
  if (row_in && x - 1 >= 0 && x - 1 < w) {  // the pixel to the left, as its east tap
    lap_t += sr[at - 1];
    gx_t += 0.5f * sgx[at - 1];
  }
  return k_lap * lap_t + k_pf * (gx_t + gy_t);
}

__global__ void __launch_bounds__(kThreads)
padded_bwd(const float* __restrict__ p, const float* __restrict__ cot, float* __restrict__ dp,
           const Grid g, const Consts c) {
  extern __shared__ float4 shared4[];
  constexpr int kPitch = Halo<2>::kPitch;
  const int field = (g.tile_h + 2) * kFieldPitch;
  float* sp = reinterpret_cast<float*>(shared4);  // p: (tile_h + 4, kPitch)
  float* sr = sp + (g.tile_h + 4) * kPitch;       // r, gx, gy: (tile_h + 2, kFieldPitch)
  float* sgx = sr + field;                        // each; field row 0 is interior row y0 - 1,
  float* sgy = sgx + field;                       // field column 0 interior column x0 - 1

  const Tile tile = tile_of_block(g);
  const int h = g.h, w = g.w, wp = w + 2, y0 = tile.y0, x0 = tile.x0;
  const size_t image = (size_t)tile.b * (h + 2) * wp;
  copy_rows<2>(p + image, sp, tile, g, 0, g.tile_h + 4);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // r, gx, gy on the tile and a ring of one pixel; 0 outside the interior.
  // Field (fr, fc) is interior (y0 - 1 + fr, x0 - 1 + fc), padded
  // (y0 + fr, x0 + fc): shared row fr + 1, column fc + 2 of sp.
  for (int k = threadIdx.x; k < field; k += kThreads) {
    const int fr = k / kFieldPitch, fc = k - fr * kFieldPitch;
    const int y = y0 - 1 + fr, x = x0 - 1 + fc;
    float rr = 0.f, gx = 0.f, gy = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float* q = sp + (fr + 1) * kPitch + fc + 2;
      const float uc = q[0], un = q[-kPitch], us = q[kPitch], uw = q[-1], ue = q[1];
      rr = c.D * (un + us + uw + ue - 4.f * uc);
      if (c.use_reaction) rr += uc * (1.f - uc) * (uc - c.a);
      gx = 0.5f * (ue - uw);
      gy = 0.5f * (us - un);
    }
    sr[k] = rr;
    sgx[k] = gx;
    sgy[k] = gy;
  }
  __syncthreads();

  const float c_rd = cot[2 * tile.b], c_pf = cot[2 * tile.b + 1];
  const float k_lap = c_rd * 2.f * c.D;  // d/du sum r^2 = 2 (D Lap^T r + f'(u) r)
  const float k_pf = c_pf * c.eps;       // phase field: eps (Gx^T gx + Gy^T gy) + ...

  // The tile's interior pixels: every tap lies on the fields' ring, where
  // the values outside the interior are 0, so no tap needs a guard.
  const int col = threadIdx.x % kTileW;
  int r_begin, r_end;
  my_rows(tile, 0, g.tile_h, r_begin, r_end);
  if (col < tile.cols) {
    for (int r = r_begin; r < r_end; ++r) {
      const int at = (r + 1) * kFieldPitch + col + 1;
      const float lap_t = -4.f * sr[at] + sr[at + kFieldPitch] + sr[at - kFieldPitch] +
                          sr[at + 1] + sr[at - 1];
      const float gx_t = 0.5f * sgx[at - 1] - 0.5f * sgx[at + 1];
      const float gy_t = 0.5f * sgy[at - kFieldPitch] - 0.5f * sgy[at + kFieldPitch];
      float gr = k_lap * lap_t + k_pf * (gx_t + gy_t);
      const float uc = sp[(r + 2) * kPitch + Halo<2>::kLead + col];
      if (c.use_reaction) {
        const float f_prime = -3.f * uc * uc + 2.f * (1.f + c.a) * uc - c.a;
        gr += c_rd * 2.f * f_prime * sr[at];
      }
      gr += c_pf * c.two_inv_eps * uc * (1.f - uc) * (1.f - 2.f * uc);
      dp[image + (size_t)(y0 + r + 1) * wp + x0 + col + 1] = gr;
    }
  }

  // The ghost ring next to this tile, where the tile touches the image's
  // edge: the ring rows above and below it (with the corners where the tile
  // also touches a side), then the ring columns beside its rows.
  const bool top = y0 == 0, bottom = y0 + tile.rows == h;
  const bool left = x0 == 0, right = x0 + tile.cols == w;
  if (!(top || bottom || left || right)) return;
  const int x_lo = left ? -1 : x0, n_x = (right ? w : x0 + tile.cols - 1) - x_lo + 1;
  const int n_top = top ? n_x : 0, n_bottom = bottom ? n_x : 0;
  const int n_left = left ? tile.rows : 0, n_right = right ? tile.rows : 0;
  const int n_ring = n_top + n_bottom + n_left + n_right;
  for (int k = threadIdx.x; k < n_ring; k += kThreads) {
    int y, x;
    if (k < n_top) {
      y = -1, x = x_lo + k;
    } else if (k < n_top + n_bottom) {
      y = h, x = x_lo + k - n_top;
    } else if (k < n_top + n_bottom + n_left) {
      y = y0 + k - n_top - n_bottom, x = -1;
    } else {
      y = y0 + k - n_top - n_bottom - n_left, x = w;
    }
    const int at = (y - y0 + 1) * kFieldPitch + x - x0 + 1;
    dp[image + (size_t)(y + 1) * wp + x + 1] = ring_grad(sr, sgx, sgy, at, y, x, h, w, k_lap, k_pf);
  }
}

Consts make_consts(double D, double a, double eps, int use_reaction) {
  // derived constants in double, rounded once, as Python computes them
  return Consts{(float)D, (float)a, (float)(eps / 2.0), (float)(1.0 / eps),
                (float)(2.0 / eps), (float)eps, use_reaction};
}

int copy_bytes(const void* p, int wp) {
  return (wp % 2 == 0 && (reinterpret_cast<uintptr_t>(p) & 7) == 0) ? 8 : 4;
}

// The grid of tiles, or false where the kernels do not take the shape.
bool make_grid(int B, int h, int w, int tile_h, const void* p, Grid* g, int* blocks) {
  if (B < 1 || h < 1 || w < 1 || tile_h < 1 || tile_h > kMaxTileH) return false;
  if ((long long)(h + 2) * (w + 2) >= INT_MAX) return false;
  g->h = h;
  g->w = w;
  g->tile_h = tile_h;
  g->n_ty = (h + tile_h - 1) / tile_h;
  g->n_tx = (w + kTileW - 1) / kTileW;
  g->pairs = copy_bytes(p, w + 2) == 8;
  const long long total = (long long)B * g->n_ty * g->n_tx;
  if (total > INT_MAX) return false;
  *blocks = (int)total;
  return true;
}

int shared_bytes(int tile_h, bool bwd) {
  if (!bwd) return (tile_h + 2) * Halo<1>::kPitch * (int)sizeof(float);
  return ((tile_h + 4) * Halo<2>::kPitch + 3 * (tile_h + 2) * kFieldPitch) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// What the wrapper plans with: a tile's width and the largest tile_h.
void padded_physics_layout(int* tile_w, int* max_tile_h) {
  *tile_w = kTileW;
  *max_tile_h = kMaxTileH;
}

// Dynamic shared memory of one block.
int padded_physics_shared_bytes(int tile_h, int bwd) { return shared_bytes(tile_h, bwd != 0); }

// Bytes a copy of p into shared memory moves: 8 or 4.
int padded_physics_copy_bytes(const void* p, int wp) { return copy_bytes(p, wp); }

// sums (B, 2) from p (B, h + 2, w + 2).  partials holds
// B * 2 * ceil(h / tile_h) * ceil(w / 64) floats; ticket is one 32-bit word
// that is 0 before the first launch (the kernel leaves it 0).  Launches that
// share a ticket must run one after another, as launches on one stream do.
int padded_physics_fwd(const float* p, float* partials, unsigned int* ticket, float* sums, int B,
                       int h, int w, int tile_h, double D, double a, double eps,
                       int use_reaction, void* stream) {
  Grid g;
  int blocks;
  if (!make_grid(B, h, w, tile_h, p, &g, &blocks)) return (int)cudaErrorInvalidValue;
  padded_fwd<<<blocks, kThreads, shared_bytes(tile_h, false),
               static_cast<cudaStream_t>(stream)>>>(p, partials, ticket, sums, B, g,
                                                    make_consts(D, a, eps, use_reaction));
  return (int)cudaGetLastError();
}

// dp (B, h + 2, w + 2) from the cotangents cot (B, 2); every position of dp
// is written.
int padded_physics_bwd(const float* p, const float* cot, float* dp, int B, int h, int w,
                       int tile_h, double D, double a, double eps, int use_reaction,
                       void* stream) {
  Grid g;
  int blocks;
  if (!make_grid(B, h, w, tile_h, p, &g, &blocks)) return (int)cudaErrorInvalidValue;
  padded_bwd<<<blocks, kThreads, shared_bytes(tile_h, true),
               static_cast<cudaStream_t>(stream)>>>(p, cot, dp, g,
                                                    make_consts(D, a, eps, use_reaction));
  return (int)cudaGetLastError();
}

}  // extern "C"
