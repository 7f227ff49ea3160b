// Fused physics-loss sums, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// physics_informed_image_segmentation_tpu/ops/pallas_physics.py::fused_physics_sums
// (_fwd_kernel, _bwd_kernel, and their pallas_calls in _fwd_call/_bwd_call).
//
// Forward, per image b of u, t (B, H, W) float32 and mask m (B, 1):
//   with u <- u * m[b], t <- t * m[b], r = D * lap(u) [+ u(1-u)(u-a)] and the
//   5-point Laplacian / central differences on a reflect-padded field,
//   sums[b] = [sum u*t, sum u, sum t, sum BCE(u, t) (logs clamped at -100),
//              sum r^2, sum (eps/2)|grad u|^2 + (1/eps) u^2 (1-u)^2].
// Backward, from the (B, 6) cotangents: du and (optionally) dt, (B, H, W).
// The adjoint of "reflect-pad then stencil" is the zero-boundary transposed
// stencil plus folds: a tap that crossed the top, bottom, left or right
// border re-enters one pixel in, so v[0,:], v[H-1,:], v[:,0], v[:,W-1] are
// added onto rows 1 and H-2 and columns 1 and W-2.
//
// Bound: by the roofline, memory.  The forward reads u and t once
// (2*B*H*W*4 bytes) for ~45 flops a pixel; the backward reads u and t and
// writes du (and dt when the target needs a gradient): 3 or 4 fields.  At
// the training shape, B=8 and 128x128, that is 1 MiB forward and 1.5 to 2 MiB
// backward, a fraction of a microsecond at 3.35 TB/s: there one launch, not
// the bytes, is the floor, so each direction is exactly one launch and
// touches device memory once.  At large images the instructions hold the
// kernels before the bytes do: two accurate logarithms a pixel (logf and
// log1pf stay the accurate ones) forward and for dt, an IEEE division and
// the guarded taps backward.
//
// Design:
// * one block per tile of tile_h x 64 pixels of one image (tile_h is the
//   wrapper's choice, so that the training shape gives 128 blocks for 132
//   SMs), all of B x tiles in gridDim.x, so any B, H >= 2 and W >= 2 works.
//   The TPU kernel held a whole image in VMEM and stopped at 256^2.
// * a block brings its tile of u with a halo (one pixel forward, two
//   backward) and its tile of t into shared memory with cp.async, 16 bytes
//   a copy where W % 4 == 0 and the pointers are aligned, 4 bytes otherwise.
//   The halo is read at the mirrored address, so the reflect pad costs no
//   pass and no branch later.  Shared rows keep the tile 16-byte aligned
//   (the halo sits in the 4 columns before it), a thread computes 4
//   neighbouring pixels from float4 reads, and nothing divides per pixel.
// * forward: six partial sums a thread, warp shuffles, one partial per
//   (image, sum, tile).  The last block to finish (a ticket counted with an
//   integer atomic after a __threadfence) adds each image's partials in tile
//   order, a warp per sum, and writes (B, 6).  No float atomics, so a run
//   repeats bit for bit; the last block sets the ticket back to 0, so the
//   workspace needs no memset and a CUDA graph can replay the launch.
// * backward: one pass, no scratch in device memory.  From the two-pixel
//   halo the block computes r, gx, gy on its tile plus a one-pixel ring
//   into shared memory (only where the ring lies inside the image: values
//   outside do not exist and the guards below never read them), then each
//   pixel gathers the transposed stencils with their border folds (a fold's
//   source is always a direct neighbour, so the ring holds it) and the
//   pointwise terms.  A group of four pixels two or more from every border
//   takes the plain transposed stencils from float4 reads; only groups near a
//   border pay for the guards.  Without dt nothing that only dt needs is
//   computed.
// * launches on PyTorch's current stream, never synchronises; each entry
//   point returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileW = 64;                         // pixels across a tile
constexpr int kGroups = kTileW / 4;                // float4 groups across a tile
constexpr int kRowsPerPass = kThreads / kGroups;   // tile rows the block computes at once
constexpr int kLead = 4;                           // shared columns before the tile's first
constexpr int kPitch = kLead + kTileW + 4;         // floats in a shared row of u or a field
constexpr int kMaxTileH = 32;                      // keeps the backward under 48 KB of shared memory
constexpr float kLogClamp = -100.0f;

struct Consts {
  float D, a, half_eps, inv_eps, two_inv_eps, eps;
  int use_reaction;
};

// Where the tiles lie: set by the host, the same for every block.
struct Grid {
  int H, W, tile_h, n_ty, n_tx;
  int vec;  // W % 4 == 0 and every pointer 16-byte aligned: 16-byte copies and stores
};

// The block's own tile.
struct Tile {
  int b, index;    // image, and the tile's number within it (row-major)
  int y0, x0;      // its first pixel
  int rows, cols;  // pixels of it inside the image
};

__device__ __forceinline__ Tile tile_of_block(const Grid& g) {
  const int per_image = g.n_ty * g.n_tx;
  Tile t;
  t.b = blockIdx.x / per_image;
  t.index = blockIdx.x - t.b * per_image;
  const int ty = t.index / g.n_tx;
  t.y0 = ty * g.tile_h;
  t.x0 = (t.index - ty * g.n_tx) * kTileW;
  t.rows = min(g.tile_h, g.H - t.y0);
  t.cols = min(kTileW, g.W - t.x0);
  return t;
}

__device__ __forceinline__ int mirror(int i, int n) {
  // one-pixel reflect pad, edge not repeated: -1 -> 1, n -> n - 2
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ float clamped_log(float x) {
  return fmaxf(logf(x), kLogClamp);
}

__device__ __forceinline__ float clamped_log1m(float x) {
  return fmaxf(log1pf(-x), kLogClamp);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Brings the block's tiles into shared memory and waits for them.
//   su[(gy - y0 + HALO) * kPitch + kLead + gx - x0] = u[mirror(gy), mirror(gx)]
//     for gy in [y0 - HALO, y0 + tile_h + HALO) and gx in [x0 - HALO,
//     x0 + 64 + HALO), wherever -1 <= gy <= H and -1 <= gx <= W (one step
//     past the image is a mirrored pixel; further out nothing is needed);
//   st[(y - y0) * 64 + x - x0] = t[y, x] for the tile's pixels in the image.
template <int HALO>
__device__ __forceinline__ void load_tiles(const float* __restrict__ ub,
                                           const float* __restrict__ tb, float* su, float* st,
                                           const Tile& tile, const Grid& g) {
  const int H = g.H, W = g.W, y0 = tile.y0, x0 = tile.x0;
  const int row_lo = max(-1, y0 - HALO);
  const int n_rows = min(H, y0 + g.tile_h + HALO - 1) - row_lo + 1;
  if (g.vec) {
    const int groups = tile.cols / 4;  // W % 4 == 0: every group is whole
    for (int k = threadIdx.x; k < n_rows * kGroups; k += kThreads) {
      const int gy = row_lo + k / kGroups, c = (k % kGroups) * 4;
      if (c < 4 * groups)
        __pipeline_memcpy_async(su + (gy - y0 + HALO) * kPitch + kLead + c,
                                ub + (size_t)mirror(gy, H) * W + x0 + c, 16);
    }
    // the halo's columns: HALO before the tile and HALO after its last pixel
    const int x_after = x0 + tile.cols;
    for (int k = threadIdx.x; k < n_rows * 2 * HALO; k += kThreads) {
      const int gy = row_lo + k / (2 * HALO), j = k % (2 * HALO);
      const int gx = j < HALO ? x0 - HALO + j : x_after + j - HALO;
      if (gx >= -1 && gx <= W)
        __pipeline_memcpy_async(su + (gy - y0 + HALO) * kPitch + kLead + gx - x0,
                                ub + (size_t)mirror(gy, H) * W + mirror(gx, W), 4);
    }
    for (int k = threadIdx.x; k < tile.rows * kGroups; k += kThreads) {
      const int r = k / kGroups, c = (k % kGroups) * 4;
      if (c < 4 * groups)
        __pipeline_memcpy_async(st + r * kTileW + c, tb + (size_t)(y0 + r) * W + x0 + c, 16);
    }
  } else {
    constexpr int kSpan = kTileW + 2 * HALO;
    for (int k = threadIdx.x; k < n_rows * kSpan; k += kThreads) {
      const int gy = row_lo + k / kSpan, gx = x0 - HALO + k % kSpan;
      if (gx >= -1 && gx <= W)
        __pipeline_memcpy_async(su + (gy - y0 + HALO) * kPitch + kLead + gx - x0,
                                ub + (size_t)mirror(gy, H) * W + mirror(gx, W), 4);
    }
    for (int k = threadIdx.x; k < tile.rows * kTileW; k += kThreads) {
      const int r = k / kTileW, c = k % kTileW;
      if (c < tile.cols)
        __pipeline_memcpy_async(st + r * kTileW + c, tb + (size_t)(y0 + r) * W + x0 + c, 4);
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// r, gx, gy of the masked field at one pixel from its four neighbours.
__device__ __forceinline__ void fields_at(float uc, float un, float us, float uw, float ue,
                                          const Consts& c, float& r, float& gx, float& gy) {
  r = c.D * (un + uw - 4.f * uc + ue + us);
  if (c.use_reaction) r += uc * (1.f - uc) * (uc - c.a);
  gx = 0.5f * (ue - uw);
  gy = 0.5f * (us - un);
}

__global__ void __launch_bounds__(kThreads)
physics_fwd(const float* __restrict__ u, const float* __restrict__ t,
            const float* __restrict__ m, float* __restrict__ partials,
            unsigned int* __restrict__ ticket, float* __restrict__ sums, int B, const Grid g,
            const Consts c) {
  extern __shared__ float4 shared4[];
  float* su = reinterpret_cast<float*>(shared4);  // (tile_h + 2, kPitch)
  float* st = su + (g.tile_h + 2) * kPitch;       // (tile_h, kTileW)

  const Tile tile = tile_of_block(g);
  const size_t image = (size_t)tile.b * g.H * g.W;
  const float mb = m[tile.b];
  load_tiles<1>(u + image, t + image, su, st, tile, g);

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int c0 = (threadIdx.x % kGroups) * 4;
  if (c0 < tile.cols) {
    for (int r = threadIdx.x / kGroups; r < tile.rows; r += kRowsPerPass) {
      const float* centre = su + (r + 1) * kPitch + kLead + c0;
      const float4 c4 = *reinterpret_cast<const float4*>(centre);
      const float4 n4 = *reinterpret_cast<const float4*>(centre - kPitch);
      const float4 s4 = *reinterpret_cast<const float4*>(centre + kPitch);
      const float4 t4 = *reinterpret_cast<const float4*>(st + r * kTileW + c0);
      // the row from one pixel before the group to one after it, masked
      const float row[6] = {centre[-1] * mb, c4.x * mb, c4.y * mb, c4.z * mb, c4.w * mb,
                            centre[4] * mb};
      const float north[4] = {n4.x * mb, n4.y * mb, n4.z * mb, n4.w * mb};
      const float south[4] = {s4.x * mb, s4.y * mb, s4.z * mb, s4.w * mb};
      const float target[4] = {t4.x * mb, t4.y * mb, t4.z * mb, t4.w * mb};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= tile.cols) continue;
        const float uc = row[j + 1], tc = target[j];
        acc[0] += uc * tc;
        acc[1] += uc;
        acc[2] += tc;
        // clamp before multiplying so 0 * (-inf) cannot give NaN
        acc[3] += -(tc * clamped_log(uc) + (1.f - tc) * clamped_log1m(uc));
        float rr, gx, gy;
        fields_at(uc, north[j], south[j], row[j], row[j + 2], c, rr, gx, gy);
        acc[4] += rr * rr;
        const float om = 1.f - uc;
        acc[5] += c.half_eps * (gx * gx + gy * gy) + c.inv_eps * (uc * uc) * (om * om);
      }
    }
  }

  __shared__ float red[6][kWarps];
  __shared__ int is_last;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int per_image = g.n_ty * g.n_tx;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float v = warp_sum(acc[i]);
    if (lane == 0) red[i][warp] = v;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float v = warp_sum(lane < kWarps ? red[i][lane] : 0.f);
      // partials are (B, 6, tiles of an image)
      if (lane == 0) partials[((size_t)tile.b * 6 + i) * per_image + tile.index] = v;
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
  for (int k = warp; k < B * 6; k += kWarps) {
    const float* src = partials + (size_t)k * per_image;
    float s = 0.f;
    for (int j = lane; j < per_image; j += 32) s += __ldcg(src + j);
    s = warp_sum(s);
    if (lane == 0) sums[k] = s;
  }
  if (threadIdx.x == 0) *ticket = 0u;
}

// The three adjoints below take v at the pixel (y, x) of a field in shared
// memory, rows kPitch apart.  Every tap they read is the pixel itself or a
// direct neighbour inside the image.

// Adjoint of "reflect-pad then 5-point Laplacian".
__device__ __forceinline__ float lap_adjoint(const float* v, int y, int x, int H, int W) {
  float s = -4.f * v[0];
  // tap reading the row above: v[y+1] lands on y; the crossing v[0] folds onto row 1
  if (y + 1 <= H - 1) s += v[kPitch];
  if (y == 1) s += v[-kPitch];
  // tap reading the row below: v[y-1] lands on y; v[H-1] folds onto row H-2
  if (y >= 1) s += v[-kPitch];
  if (y == H - 2) s += v[kPitch];
  // left and right taps, folds onto columns 1 and W-2
  if (x + 1 <= W - 1) s += v[1];
  if (x == 1) s += v[-1];
  if (x >= 1) s += v[-1];
  if (x == W - 2) s += v[1];
  return s;
}

// Adjoint of the reflect-padded central difference along x: taps -0.5 at
// x-1 and +0.5 at x+1.
__device__ __forceinline__ float gx_adjoint(const float* v, int x, int W) {
  float s = 0.f;
  if (x + 1 <= W - 1) s -= 0.5f * v[1];
  if (x == 1) s -= 0.5f * v[-1];
  if (x >= 1) s += 0.5f * v[-1];
  if (x == W - 2) s += 0.5f * v[1];
  return s;
}

// Same along y: taps -0.5 at y-1 and +0.5 at y+1.
__device__ __forceinline__ float gy_adjoint(const float* v, int y, int H) {
  float s = 0.f;
  if (y + 1 <= H - 1) s -= 0.5f * v[kPitch];
  if (y == 1) s -= 0.5f * v[-kPitch];
  if (y >= 1) s += 0.5f * v[-kPitch];
  if (y == H - 2) s += 0.5f * v[kPitch];
  return s;
}

__global__ void __launch_bounds__(kThreads)
physics_bwd(const float* __restrict__ u, const float* __restrict__ t,
            const float* __restrict__ m, const float* __restrict__ cot,
            float* __restrict__ du, float* __restrict__ dt, const Grid g, const Consts c) {
  extern __shared__ float4 shared4[];
  const int field = (g.tile_h + 2) * kPitch;
  float* su = reinterpret_cast<float*>(shared4);  // (tile_h + 4, kPitch)
  float* st = su + (g.tile_h + 4) * kPitch;       // (tile_h, kTileW)
  float* sr = st + g.tile_h * kTileW;             // r, gx, gy: (tile_h + 2, kPitch) each,
  float* sgx = sr + field;                        // row 0 is image row y0 - 1 and column
  float* sgy = sgx + field;                       // kLead is image column x0

  const Tile tile = tile_of_block(g);
  const int H = g.H, W = g.W, y0 = tile.y0, x0 = tile.x0;
  const size_t image = (size_t)tile.b * H * W;
  const float mb = m[tile.b];
  load_tiles<2>(u + image, t + image, su, st, tile, g);

  // r, gx, gy on the tile and a ring of one pixel, where that lies in the image.
  // The tile's own columns go four at a time (a group that ends outside the
  // image computes on what shared memory holds there; nothing reads it) ...
  for (int k = threadIdx.x; k < (g.tile_h + 2) * kGroups; k += kThreads) {
    const int fr = k / kGroups, fc = (k % kGroups) * 4;  // field row; column relative to x0
    const int fy = y0 - 1 + fr;
    if (fy < 0 || fy > H - 1 || fc >= tile.cols) continue;
    const float* p = su + (fr + 1) * kPitch + kLead + fc;
    const float4 c4 = *reinterpret_cast<const float4*>(p);
    const float4 n4 = *reinterpret_cast<const float4*>(p - kPitch);
    const float4 s4 = *reinterpret_cast<const float4*>(p + kPitch);
    const float row[6] = {p[-1] * mb, c4.x * mb, c4.y * mb, c4.z * mb, c4.w * mb, p[4] * mb};
    const float north[4] = {n4.x * mb, n4.y * mb, n4.z * mb, n4.w * mb};
    const float south[4] = {s4.x * mb, s4.y * mb, s4.z * mb, s4.w * mb};
    float rr[4], gx[4], gy[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      fields_at(row[j + 1], north[j], south[j], row[j], row[j + 2], c, rr[j], gx[j], gy[j]);
    const int at = fr * kPitch + kLead + fc;
    *reinterpret_cast<float4*>(sr + at) = make_float4(rr[0], rr[1], rr[2], rr[3]);
    *reinterpret_cast<float4*>(sgx + at) = make_float4(gx[0], gx[1], gx[2], gx[3]);
    *reinterpret_cast<float4*>(sgy + at) = make_float4(gy[0], gy[1], gy[2], gy[3]);
  }
  // ... and the ring's two columns, before the tile and after its last pixel, one by one
  for (int k = threadIdx.x; k < (g.tile_h + 2) * 2; k += kThreads) {
    const int fr = k / 2, fc = (k % 2) ? tile.cols : -1;
    const int fy = y0 - 1 + fr, fx = x0 + fc;
    if (fy < 0 || fy > H - 1 || fx < 0 || fx > W - 1) continue;
    const float* p = su + (fr + 1) * kPitch + kLead + fc;
    const int at = fr * kPitch + kLead + fc;
    fields_at(p[0] * mb, p[-kPitch] * mb, p[kPitch] * mb, p[-1] * mb, p[1] * mb, c, sr[at],
              sgx[at], sgy[at]);
  }
  __syncthreads();

  const float* cb = cot + (size_t)tile.b * 6;
  const float c_inter = cb[0], c_su = cb[1], c_st = cb[2];
  const float c_bce = cb[3], c_rd = cb[4], c_pf = cb[5];
  const int c0 = (threadIdx.x % kGroups) * 4;
  if (c0 >= tile.cols) return;
  for (int r = threadIdx.x / kGroups; r < tile.rows; r += kRowsPerPass) {
    const int y = y0 + r, x = x0 + c0;
    const int at = (r + 1) * kPitch + kLead + c0;  // the group's first pixel in a field
    // the transposed stencils: Lap^T r, Gx^T gx, Gy^T gy at the group's four pixels
    float lap_t[4], gx_t[4], gy_t[4];
    if (y >= 2 && y <= H - 3 && x >= 2 && x + 3 <= W - 3) {
      // two pixels or more from every border: no tap crosses it, no fold lands here
      const float4 rn = *reinterpret_cast<const float4*>(sr + at - kPitch);
      const float4 rc = *reinterpret_cast<const float4*>(sr + at);
      const float4 rs = *reinterpret_cast<const float4*>(sr + at + kPitch);
      const float4 gc = *reinterpret_cast<const float4*>(sgx + at);
      const float4 gn = *reinterpret_cast<const float4*>(sgy + at - kPitch);
      const float4 gs = *reinterpret_cast<const float4*>(sgy + at + kPitch);
      const float r_row[6] = {sr[at - 1], rc.x, rc.y, rc.z, rc.w, sr[at + 4]};
      const float g_row[6] = {sgx[at - 1], gc.x, gc.y, gc.z, gc.w, sgx[at + 4]};
      const float r_n[4] = {rn.x, rn.y, rn.z, rn.w}, r_s[4] = {rs.x, rs.y, rs.z, rs.w};
      const float g_n[4] = {gn.x, gn.y, gn.z, gn.w}, g_s[4] = {gs.x, gs.y, gs.z, gs.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lap_t[j] = -4.f * r_row[j + 1] + r_s[j] + r_n[j] + r_row[j + 2] + r_row[j];
        gx_t[j] = 0.5f * (g_row[j] - g_row[j + 2]);
        gy_t[j] = 0.5f * (g_n[j] - g_s[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lap_t[j] = gx_t[j] = gy_t[j] = 0.f;
        if (c0 + j >= tile.cols) continue;
        lap_t[j] = lap_adjoint(sr + at + j, y, x + j, H, W);
        gx_t[j] = gx_adjoint(sgx + at + j, x + j, W);
        gy_t[j] = gy_adjoint(sgy + at + j, y, H);
      }
    }

    const float4 u4 = *reinterpret_cast<const float4*>(su + at + kPitch);  // u's rows start
    const float4 t4 = *reinterpret_cast<const float4*>(st + r * kTileW + c0);  // one above
    const float4 r4 = *reinterpret_cast<const float4*>(sr + at);
    const float u_at[4] = {u4.x * mb, u4.y * mb, u4.z * mb, u4.w * mb};
    const float t_at[4] = {t4.x * mb, t4.y * mb, t4.z * mb, t4.w * mb};
    const float r_at[4] = {r4.x, r4.y, r4.z, r4.w};
    float gu[4], gt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gu[j] = gt[j] = 0.f;
      if (c0 + j >= tile.cols) continue;
      const float uc = u_at[j], tc = t_at[j];

      // Dice sums
      float gsum = c_inter * tc + c_su;
      // BCE with torch's clamped denominator: finite on saturated pixels
      gsum += c_bce * (uc - tc) / fmaxf(uc * (1.f - uc), 1e-12f);

      // reaction-diffusion: d/du sum r^2 = 2 (D * Lap^T r + f'(u) r)
      float rd = c.D * lap_t[j];
      if (c.use_reaction) {
        const float f_prime = -3.f * uc * uc + 2.f * (1.f + c.a) * uc - c.a;
        rd += f_prime * r_at[j];
      }
      gsum += c_rd * 2.f * rd;

      // phase field: eps (Gx^T gx + Gy^T gy) + (2/eps) u (1-u) (1-2u)
      float pf = c.eps * (gx_t[j] + gy_t[j]);
      pf += c.two_inv_eps * uc * (1.f - uc) * (1.f - 2.f * uc);
      gsum += c_pf * pf;

      // chain through the mask multiply on entry
      gu[j] = gsum * mb;
      if (dt != nullptr)
        gt[j] = (c_inter * uc + c_st + c_bce * (clamped_log1m(uc) - clamped_log(uc))) * mb;
    }
    const size_t out = image + (size_t)y * W + x;
    if (g.vec) {
      *reinterpret_cast<float4*>(du + out) = make_float4(gu[0], gu[1], gu[2], gu[3]);
      if (dt != nullptr)
        *reinterpret_cast<float4*>(dt + out) = make_float4(gt[0], gt[1], gt[2], gt[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j >= tile.cols) continue;
        du[out + j] = gu[j];
        if (dt != nullptr) dt[out + j] = gt[j];
      }
    }
  }
}

Consts make_consts(double D, double a, double eps, int use_reaction) {
  // derived constants in double, rounded once, as Python computes them
  return Consts{(float)D, (float)a, (float)(eps / 2.0), (float)(1.0 / eps),
                (float)(2.0 / eps), (float)eps, use_reaction};
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The grid of tiles, or false where the kernels do not take the shape.
bool make_grid(int B, int H, int W, int tile_h, bool pointers_aligned, Grid* g, int* blocks) {
  if (B < 1 || H < 2 || W < 2 || tile_h < 1 || tile_h > kMaxTileH) return false;
  g->H = H;
  g->W = W;
  g->tile_h = tile_h;
  g->n_ty = (H + tile_h - 1) / tile_h;
  g->n_tx = (W + kTileW - 1) / kTileW;
  g->vec = (W % 4 == 0) && pointers_aligned;
  const long long total = (long long)B * g->n_ty * g->n_tx;
  if (total > INT_MAX) return false;
  *blocks = (int)total;
  return true;
}

int shared_bytes(int tile_h, bool bwd) {
  const int u_rows = tile_h + (bwd ? 4 : 2);
  const int fields = bwd ? 3 * (tile_h + 2) * kPitch : 0;
  return (u_rows * kPitch + tile_h * kTileW + fields) * (int)sizeof(float);
}

}  // namespace

extern "C" {

// What the wrapper plans with: a tile's width and the largest tile_h.
void physics_sums_layout(int* tile_w, int* max_tile_h) {
  *tile_w = kTileW;
  *max_tile_h = kMaxTileH;
}

// Dynamic shared memory of one block.
int physics_sums_shared_bytes(int tile_h, int bwd) { return shared_bytes(tile_h, bwd != 0); }

// sums (B, 6) from u, t (B, H, W) and m (B, 1).  partials holds
// B * 6 * ceil(H / tile_h) * ceil(W / 64) floats; ticket is one 32-bit word
// that is 0 before the first launch (the kernel leaves it 0).  Launches that
// share a ticket must run one after another, as launches on one stream do.
int physics_sums_fwd(const float* u, const float* t, const float* m, float* partials,
                     unsigned int* ticket, float* sums, int B, int H, int W, int tile_h,
                     double D, double a, double eps, int use_reaction, void* stream) {
  Grid g;
  int blocks;
  if (!make_grid(B, H, W, tile_h, aligned16(u) && aligned16(t), &g, &blocks))
    return (int)cudaErrorInvalidValue;
  physics_fwd<<<blocks, kThreads, shared_bytes(tile_h, false),
                static_cast<cudaStream_t>(stream)>>>(u, t, m, partials, ticket, sums, B, g,
                                                     make_consts(D, a, eps, use_reaction));
  return (int)cudaGetLastError();
}

// du (and dt unless it is null) from the cotangents cot (B, 6).
int physics_sums_bwd(const float* u, const float* t, const float* m, const float* cot,
                     float* du, float* dt, int B, int H, int W, int tile_h, double D, double a,
                     double eps, int use_reaction, void* stream) {
  Grid g;
  int blocks;
  const bool aligned = aligned16(u) && aligned16(t) && aligned16(du) && aligned16(dt);
  if (!make_grid(B, H, W, tile_h, aligned, &g, &blocks)) return (int)cudaErrorInvalidValue;
  physics_bwd<<<blocks, kThreads, shared_bytes(tile_h, true),
                static_cast<cudaStream_t>(stream)>>>(u, t, m, cot, du, dt, g,
                                                     make_consts(D, a, eps, use_reaction));
  return (int)cudaGetLastError();
}

}  // extern "C"
