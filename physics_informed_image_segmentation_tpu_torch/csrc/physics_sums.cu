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
// Bound: memory.  The forward reads u and t once (2*B*H*W*4 bytes) and does
// ~40 flops a pixel; the backward reads u, t and writes du, dt (~4*B*H*W*4
// bytes) plus a 3-field scratch.  At the training shape, B=8 and 128x128,
// that is 1 MiB and 2 MiB: well under 1 us at 3.35 TB/s, so there the kernel
// is bound by launch latency, not by the card.
//
// Design (simple and right first):
// * forward: one block per (row tile, image).  Each thread reads its pixels
//   and their four mirrored neighbours straight from global memory (L1/L2
//   serve the reuse), keeps six float partial sums, and the block reduces
//   them with warp shuffles into (B, n_tiles, 6) partials.  A second small
//   launch adds the partials of each image in a fixed order.  No float
//   atomics anywhere, so a run repeats bit for bit.  Rows are tiled, so any
//   H x W works (the TPU kernel held a whole image in VMEM and stopped at
//   256^2).
// * backward: pass 1 writes r, gx, gy to scratch; pass 2 gathers, per pixel,
//   the transposed stencils with their border folds and the pointwise terms.
// * the wrapper launches everything on PyTorch's current stream and never
//   synchronises; each entry point returns cudaGetLastError().
// Left for later work: shared-memory tiles with halos, one fused backward
// pass, and CUDA graphs around the training step to hide launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kLogClamp = -100.0f;

struct Consts {
  float D, a, half_eps, inv_eps, two_inv_eps, eps;
  int use_reaction;
};

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

__global__ void __launch_bounds__(kThreads)
physics_fwd_partials(const float* __restrict__ u, const float* __restrict__ t,
                     const float* __restrict__ m, float* __restrict__ partials,
                     int H, int W, int rows_per_tile, Consts c) {
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int b = blockIdx.y;
  const float mb = m[b];
  const float* ub = u + (size_t)b * H * W;
  const float* tb = t + (size_t)b * H * W;
  const int row0 = tile * rows_per_tile;
  const int row1 = min(H, row0 + rows_per_tile);
  const int npix = (row1 - row0) * W;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int k = threadIdx.x; k < npix; k += kThreads) {
    const int y = row0 + k / W;
    const int x = k % W;
    const float uc = ub[y * W + x] * mb;
    const float tc = tb[y * W + x] * mb;
    const float un = ub[mirror(y - 1, H) * W + x] * mb;
    const float us = ub[mirror(y + 1, H) * W + x] * mb;
    const float uw = ub[y * W + mirror(x - 1, W)] * mb;
    const float ue = ub[y * W + mirror(x + 1, W)] * mb;

    acc[0] += uc * tc;
    acc[1] += uc;
    acc[2] += tc;
    // clamp before multiplying so 0 * (-inf) cannot give NaN
    acc[3] += -(tc * clamped_log(uc) + (1.f - tc) * clamped_log1m(uc));

    float r = c.D * (un + uw - 4.f * uc + ue + us);
    if (c.use_reaction) r += uc * (1.f - uc) * (uc - c.a);
    acc[4] += r * r;

    const float gx = 0.5f * (ue - uw);
    const float gy = 0.5f * (us - un);
    const float om = 1.f - uc;
    acc[5] += c.half_eps * (gx * gx + gy * gy) + c.inv_eps * (uc * uc) * (om * om);
  }

  __shared__ float red[6][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
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
      if (lane == 0) partials[((size_t)b * n_tiles + tile) * 6 + i] = v;
    }
  }
}

__global__ void physics_fwd_finish(const float* __restrict__ partials,
                                   float* __restrict__ sums, int B, int n_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 6) return;
  const int b = i / 6;
  const int k = i % 6;
  float s = 0.f;
  for (int j = 0; j < n_tiles; ++j) s += partials[((size_t)b * n_tiles + j) * 6 + k];
  sums[i] = s;
}

// Pass 1 of the backward: r, gx, gy of the masked field, per pixel.
__global__ void __launch_bounds__(kThreads)
physics_bwd_fields(const float* __restrict__ u, const float* __restrict__ m,
                   float* __restrict__ r_out, float* __restrict__ gx_out,
                   float* __restrict__ gy_out, int B, int H, int W, Consts c) {
  const size_t hw = (size_t)H * W;
  const size_t total = (size_t)B * hw;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int b = (int)(i / hw);
    const int p = (int)(i % hw);
    const int y = p / W;
    const int x = p % W;
    const float mb = m[b];
    const float* ub = u + (size_t)b * hw;
    const float uc = ub[p] * mb;
    const float un = ub[mirror(y - 1, H) * W + x] * mb;
    const float us = ub[mirror(y + 1, H) * W + x] * mb;
    const float uw = ub[y * W + mirror(x - 1, W)] * mb;
    const float ue = ub[y * W + mirror(x + 1, W)] * mb;
    float r = c.D * (un + uw - 4.f * uc + ue + us);
    if (c.use_reaction) r += uc * (1.f - uc) * (uc - c.a);
    r_out[i] = r;
    gx_out[i] = 0.5f * (ue - uw);
    gy_out[i] = 0.5f * (us - un);
  }
}

// Adjoint of "reflect-pad then 5-point Laplacian" applied to v at (y, x).
__device__ __forceinline__ float lap_adjoint(const float* v, int y, int x, int H, int W) {
  float s = -4.f * v[y * W + x];
  // tap reading the row above: v[y+1] lands on y; the crossing v[0] folds onto row 1
  if (y + 1 <= H - 1) s += v[(y + 1) * W + x];
  if (y == 1) s += v[x];
  // tap reading the row below: v[y-1] lands on y; v[H-1] folds onto row H-2
  if (y >= 1) s += v[(y - 1) * W + x];
  if (y == H - 2) s += v[(H - 1) * W + x];
  // left and right taps, folds onto columns 1 and W-2
  if (x + 1 <= W - 1) s += v[y * W + x + 1];
  if (x == 1) s += v[y * W];
  if (x >= 1) s += v[y * W + x - 1];
  if (x == W - 2) s += v[y * W + W - 1];
  return s;
}

// Adjoint of the reflect-padded central difference along x: taps -0.5 at
// x-1 and +0.5 at x+1.
__device__ __forceinline__ float gx_adjoint(const float* v, int y, int x, int W) {
  float s = 0.f;
  if (x + 1 <= W - 1) s -= 0.5f * v[y * W + x + 1];
  if (x == 1) s -= 0.5f * v[y * W];
  if (x >= 1) s += 0.5f * v[y * W + x - 1];
  if (x == W - 2) s += 0.5f * v[y * W + W - 1];
  return s;
}

// Same along y: taps -0.5 at y-1 and +0.5 at y+1.
__device__ __forceinline__ float gy_adjoint(const float* v, int y, int x, int H, int W) {
  float s = 0.f;
  if (y + 1 <= H - 1) s -= 0.5f * v[(y + 1) * W + x];
  if (y == 1) s -= 0.5f * v[x];
  if (y >= 1) s += 0.5f * v[(y - 1) * W + x];
  if (y == H - 2) s += 0.5f * v[(H - 1) * W + x];
  return s;
}

// Pass 2 of the backward: du, dt per pixel from the cotangents and scratch.
__global__ void __launch_bounds__(kThreads)
physics_bwd_grads(const float* __restrict__ u, const float* __restrict__ t,
                  const float* __restrict__ m, const float* __restrict__ cot,
                  const float* __restrict__ r, const float* __restrict__ gx,
                  const float* __restrict__ gy, float* __restrict__ du,
                  float* __restrict__ dt, int B, int H, int W, Consts c) {
  const size_t hw = (size_t)H * W;
  const size_t total = (size_t)B * hw;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int b = (int)(i / hw);
    const int p = (int)(i % hw);
    const int y = p / W;
    const int x = p % W;
    const float mb = m[b];
    const float uc = u[i] * mb;
    const float tc = t[i] * mb;
    const float* cb = cot + (size_t)b * 6;
    const float c_inter = cb[0], c_su = cb[1], c_st = cb[2];
    const float c_bce = cb[3], c_rd = cb[4], c_pf = cb[5];
    const float* rb = r + (size_t)b * hw;
    const float* gxb = gx + (size_t)b * hw;
    const float* gyb = gy + (size_t)b * hw;

    // Dice sums
    float g = c_inter * tc + c_su;
    // BCE with torch's clamped denominator: finite on saturated pixels
    g += c_bce * (uc - tc) / fmaxf(uc * (1.f - uc), 1e-12f);

    // reaction-diffusion: d/du sum r^2 = 2 (D * Lap^T r + f'(u) r)
    float rd = c.D * lap_adjoint(rb, y, x, H, W);
    if (c.use_reaction) {
      const float f_prime = -3.f * uc * uc + 2.f * (1.f + c.a) * uc - c.a;
      rd += f_prime * rb[p];
    }
    g += c_rd * 2.f * rd;

    // phase field: eps (Gx^T gx + Gy^T gy) + (2/eps) u (1-u) (1-2u)
    float pf = c.eps * (gx_adjoint(gxb, y, x, W) + gy_adjoint(gyb, y, x, H, W));
    pf += c.two_inv_eps * uc * (1.f - uc) * (1.f - 2.f * uc);
    g += c_pf * pf;

    // chain through the mask multiply on entry
    du[i] = g * mb;
    if (dt != nullptr) {
      const float dtv = c_inter * uc + c_st + c_bce * (clamped_log1m(uc) - clamped_log(uc));
      dt[i] = dtv * mb;
    }
  }
}

Consts make_consts(double D, double a, double eps, int use_reaction) {
  // derived constants in double, rounded once, as Python computes them
  return Consts{(float)D, (float)a, (float)(eps / 2.0), (float)(1.0 / eps),
                (float)(2.0 / eps), (float)eps, use_reaction};
}

int grid_for(size_t total) {
  const size_t blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < 65535 * 16 ? blocks : 65535 * 16);
}

}  // namespace

extern "C" {

// sums (B, 6) from u, t (B, H, W) and m (B, 1); partials holds
// B * n_tiles * 6 floats with n_tiles = ceil(H / rows_per_tile).
int physics_sums_fwd(const float* u, const float* t, const float* m, float* partials,
                     float* sums, int B, int H, int W, int rows_per_tile, double D,
                     double a, double eps, int use_reaction, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (H + rows_per_tile - 1) / rows_per_tile;
  const Consts c = make_consts(D, a, eps, use_reaction);
  physics_fwd_partials<<<dim3(n_tiles, B), kThreads, 0, s>>>(u, t, m, partials, H, W,
                                                            rows_per_tile, c);
  physics_fwd_finish<<<(B * 6 + 127) / 128, 128, 0, s>>>(partials, sums, B, n_tiles);
  return (int)cudaGetLastError();
}

// du (and dt unless it is null) from the cotangents cot (B, 6); scratch
// holds 3 * B * H * W floats.
int physics_sums_bwd(const float* u, const float* t, const float* m, const float* cot,
                     float* scratch, float* du, float* dt, int B, int H, int W, double D,
                     double a, double eps, int use_reaction, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t total = (size_t)B * H * W;
  const Consts c = make_consts(D, a, eps, use_reaction);
  float* r = scratch;
  float* gx = scratch + total;
  float* gy = scratch + 2 * total;
  const int grid = grid_for(total);
  physics_bwd_fields<<<grid, kThreads, 0, s>>>(u, m, r, gx, gy, B, H, W, c);
  physics_bwd_grads<<<grid, kThreads, 0, s>>>(u, t, m, cot, r, gx, gy, du, dt, B, H, W, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
