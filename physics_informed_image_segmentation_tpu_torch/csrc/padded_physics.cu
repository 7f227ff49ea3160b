// Physics sums over the interior of halo-padded blocks, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// physics_informed_image_segmentation_tpu/ops/pallas_physics.py::padded_physics_sums
// (_padded_fwd_kernel, _padded_bwd_kernel, and their pallas_calls in
// _padded_fwd_call/_padded_bwd_call).
//
// Input p (B, Hp, Wp) float32 with Hp = h + 2, Wp = w + 2: a spatial block
// whose one-pixel ghost ring the caller has already filled (neighbour rows
// from the halo exchange, mirrored rows and columns at the global edges).
// With u = p[1:-1, 1:-1] and the 5-point stencils reading the ring,
//   r  = D * lap(u) [+ u (1-u) (u-a)],  gx = (E - W) / 2,  gy = (S - N) / 2,
//   sums[b] = [sum r^2, sum (eps/2)(gx^2 + gy^2) + (1/eps) u^2 (1-u)^2].
// Backward, from the (B, 2) cotangents: dp (B, Hp, Wp).  Nothing is folded
// here: the ghost ring receives the plain (zero-boundary) transpose of the
// stencils, and the caller's exchange routes it back to the rows it came
// from.  The pointwise terms land on the interior only.  The taps are
// cross-shaped, so the four corners of the ring receive 0.
//
// Bound: memory.  The forward reads p once (B*Hp*Wp*4 bytes: 4.2 MB for one
// 1026x1026 block, 1.26 us at 3.35 TB/s); the backward reads p and writes
// dp (twice that) plus a 3-field scratch.  At (8, 130, 130) both are well
// under a microsecond, so there the kernel is bound by launch latency.
//
// Design (simple and right first; it shares K1's structure,
// csrc/physics_sums.cu):
// * forward: one block per (row tile, image) walks the tile's interior
//   pixels; each thread reads its five taps straight from global memory
//   (L1/L2 serve the reuse), keeps two float partials, and the block reduces
//   them with warp shuffles into (B, n_tiles, 2) partials; a second small
//   launch adds each image's partials in a fixed order.  No atomics, so a run
//   repeats bit for bit, and rows are tiled, so a 1026x1026 block works (the
//   TPU kernel held one whole image per grid step in VMEM).
// * backward: pass 1 writes r, gx, gy of the interior to scratch; pass 2
//   gathers, for every padded position, the flipped taps of the interior
//   neighbours that read it (a gather: no scatter, no atomics), and adds the
//   pointwise terms on the interior.
// * the wrapper launches on PyTorch's current stream and never
//   synchronises; each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Consts {
  float D, a, half_eps, inv_eps, two_inv_eps, eps;
  int use_reaction;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
padded_fwd_partials(const float* __restrict__ p, float* __restrict__ partials, int h, int w,
                    int rows_per_tile, Consts c) {
  const int tile = blockIdx.x;
  const int n_tiles = gridDim.x;
  const int b = blockIdx.y;
  const int wp = w + 2;
  const float* pb = p + (size_t)b * (h + 2) * wp;
  const int row0 = tile * rows_per_tile;
  const int row1 = min(h, row0 + rows_per_tile);
  const int npix = (row1 - row0) * w;

  float rd = 0.f, pf = 0.f;
  for (int k = threadIdx.x; k < npix; k += kThreads) {
    // interior pixel (y, x) sits at padded (y + 1, x + 1)
    const int y = row0 + k / w + 1;
    const int x = k % w + 1;
    const float uc = pb[y * wp + x];
    const float un = pb[(y - 1) * wp + x];
    const float us = pb[(y + 1) * wp + x];
    const float uw = pb[y * wp + x - 1];
    const float ue = pb[y * wp + x + 1];

    float r = c.D * (un + us + uw + ue - 4.f * uc);
    if (c.use_reaction) r += uc * (1.f - uc) * (uc - c.a);
    rd += r * r;

    const float gx = 0.5f * (ue - uw);
    const float gy = 0.5f * (us - un);
    const float om = 1.f - uc;
    pf += c.half_eps * (gx * gx + gy * gy) + c.inv_eps * (uc * uc) * (om * om);
  }

  __shared__ float red[2][kWarps];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  rd = warp_sum(rd);
  pf = warp_sum(pf);
  if (lane == 0) {
    red[0][warp] = rd;
    red[1][warp] = pf;
  }
  __syncthreads();
  if (warp == 0) {
    const float s0 = warp_sum(lane < kWarps ? red[0][lane] : 0.f);
    const float s1 = warp_sum(lane < kWarps ? red[1][lane] : 0.f);
    if (lane == 0) {
      partials[((size_t)b * n_tiles + tile) * 2] = s0;
      partials[((size_t)b * n_tiles + tile) * 2 + 1] = s1;
    }
  }
}

__global__ void padded_fwd_finish(const float* __restrict__ partials, float* __restrict__ sums,
                                  int B, int n_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * 2) return;
  const int b = i / 2;
  const int k = i % 2;
  float s = 0.f;
  for (int j = 0; j < n_tiles; ++j) s += partials[((size_t)b * n_tiles + j) * 2 + k];
  sums[i] = s;
}

// Pass 1 of the backward: r, gx, gy on the (B, h, w) interior.
__global__ void __launch_bounds__(kThreads)
padded_bwd_fields(const float* __restrict__ p, float* __restrict__ r_out,
                  float* __restrict__ gx_out, float* __restrict__ gy_out, int B, int h, int w,
                  Consts c) {
  const size_t hw = (size_t)h * w;
  const size_t total = (size_t)B * hw;
  const int wp = w + 2;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int b = (int)(i / hw);
    const int q = (int)(i % hw);
    const int y = q / w + 1;
    const int x = q % w + 1;
    const float* pb = p + (size_t)b * (h + 2) * wp;
    const float uc = pb[y * wp + x];
    const float un = pb[(y - 1) * wp + x];
    const float us = pb[(y + 1) * wp + x];
    const float uw = pb[y * wp + x - 1];
    const float ue = pb[y * wp + x + 1];
    float r = c.D * (un + us + uw + ue - 4.f * uc);
    if (c.use_reaction) r += uc * (1.f - uc) * (uc - c.a);
    r_out[i] = r;
    gx_out[i] = 0.5f * (ue - uw);
    gy_out[i] = 0.5f * (us - un);
  }
}

// Interior field value at interior (y, x), 0 outside [0, h) x [0, w).
__device__ __forceinline__ float at(const float* v, int y, int x, int h, int w) {
  return (y >= 0 && y < h && x >= 0 && x < w) ? v[y * w + x] : 0.f;
}

// Pass 2 of the backward: dp at every padded position (i, j).  The interior
// pixel (y, x) reads padded (y+1+dy, x+1+dx) for each tap (dy, dx), so
// padded (i, j) gathers tap (dy, dx) from interior (i-1-dy, j-1-dx).
__global__ void __launch_bounds__(kThreads)
padded_bwd_grads(const float* __restrict__ p, const float* __restrict__ cot,
                 const float* __restrict__ r, const float* __restrict__ gx,
                 const float* __restrict__ gy, float* __restrict__ dp, int B, int h, int w,
                 Consts c) {
  const int hp = h + 2;
  const int wp = w + 2;
  const size_t hwp = (size_t)hp * wp;
  const size_t total = (size_t)B * hwp;
  const size_t hw = (size_t)h * w;
  for (size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * kThreads) {
    const int b = (int)(idx / hwp);
    const int q = (int)(idx % hwp);
    const int i = q / wp;
    const int j = q % wp;
    const float c_rd = cot[2 * b];
    const float c_pf = cot[2 * b + 1];
    const float* rb = r + (size_t)b * hw;
    const float* gxb = gx + (size_t)b * hw;
    const float* gyb = gy + (size_t)b * hw;
    // interior coordinates of this position's centre tap
    const int y = i - 1;
    const int x = j - 1;

    // Laplacian: centre -4, and the four unit taps (flipped)
    const float lap_t = -4.f * at(rb, y, x, h, w) + at(rb, y + 1, x, h, w) +
                        at(rb, y - 1, x, h, w) + at(rb, y, x + 1, h, w) + at(rb, y, x - 1, h, w);
    // gx taps: +0.5 at (0, +1) and -0.5 at (0, -1); gy likewise along rows
    const float gx_t = 0.5f * at(gxb, y, x - 1, h, w) - 0.5f * at(gxb, y, x + 1, h, w);
    const float gy_t = 0.5f * at(gyb, y - 1, x, h, w) - 0.5f * at(gyb, y + 1, x, h, w);
    float g = c_rd * 2.f * c.D * lap_t + c_pf * c.eps * (gx_t + gy_t);

    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float uc = p[idx];
      if (c.use_reaction) {
        const float f_prime = -3.f * uc * uc + 2.f * (1.f + c.a) * uc - c.a;
        g += c_rd * 2.f * f_prime * rb[y * w + x];
      }
      g += c_pf * c.two_inv_eps * uc * (1.f - uc) * (1.f - 2.f * uc);
    }
    dp[idx] = g;
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

// sums (B, 2) from p (B, h+2, w+2); partials holds B * n_tiles * 2 floats
// with n_tiles = ceil(h / rows_per_tile).
int padded_physics_fwd(const float* p, float* partials, float* sums, int B, int h, int w,
                       int rows_per_tile, double D, double a, double eps, int use_reaction,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (h + rows_per_tile - 1) / rows_per_tile;
  const Consts c = make_consts(D, a, eps, use_reaction);
  padded_fwd_partials<<<dim3(n_tiles, B), kThreads, 0, s>>>(p, partials, h, w, rows_per_tile, c);
  padded_fwd_finish<<<(B * 2 + 127) / 128, 128, 0, s>>>(partials, sums, B, n_tiles);
  return (int)cudaGetLastError();
}

// dp (B, h+2, w+2) from the cotangents cot (B, 2); scratch holds
// 3 * B * h * w floats.
int padded_physics_bwd(const float* p, const float* cot, float* scratch, float* dp, int B,
                       int h, int w, double D, double a, double eps, int use_reaction,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t interior = (size_t)B * h * w;
  const Consts c = make_consts(D, a, eps, use_reaction);
  float* r = scratch;
  float* gx = scratch + interior;
  float* gy = scratch + 2 * interior;
  padded_bwd_fields<<<grid_for(interior), kThreads, 0, s>>>(p, r, gx, gy, B, h, w, c);
  const size_t padded = (size_t)B * (h + 2) * (w + 2);
  padded_bwd_grads<<<grid_for(padded), kThreads, 0, s>>>(p, cot, r, gx, gy, dp, B, h, w, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
