// LayerNorm over the last dimension, forward and backward, for Hopper
// (sm_90a):
//   y = (x - mu) * rstd * gamma + beta
// over rows of C contiguous elements, with mu and rstd = 1 / sqrt(var + eps)
// per row.
//
// Replaces no TPU kernel: the JAX package has no Swin-Unet, and XLA fuses
// the norms it has.  On the card PyTorch runs Swin-Unet's 38 LayerNorms
// (models/swin_unet.py) under bf16 autocast as float32 native_layer_norm:
// a bf16 input (the patch embedding's convolution, PatchExpand's linear) is
// first cast to a float32 copy, which autograd keeps for the backward; a
// float32 output that only a linear reads is cast to bf16 after it; and the
// backward runs in float32 with the casts' mirrors.
//
// Bound: memory.  A forward reads x and writes y; a backward reads the
// gradient of y and x and writes the gradient of x: a few flops an element.
// At 896^2, batch 8, the 38 norms hold 1.39 G elements a forward, 617 M of
// them at the x4 expand's norm (6.4 M rows of 96).
//
// Design:
// * one launch forward, two backward (the rows, then the parameters'
//   gradients).  x's type (bf16 or float32) and y's (bf16 or float32) are
//   separate: y is bf16 where only a linear or the output convolution reads
//   it (they would cast it to bf16 first), float32 where it becomes the
//   residual stream.  The gradient of y has y's type, dx x's.  No float32
//   copy of a bf16 input is made or kept.
// * a row is held in registers after one read: each thread of a group of
//   TPR threads takes kPacks 16-byte packs of x (8 bf16 or 4 float32
//   elements), neighbouring threads on neighbouring packs.  TPR follows C
//   and x's type (4 threads for 96 bf16 elements, 128 for 1536 float32),
//   so a row of 96 shares its warp with seven others instead of idling a
//   block.  Sums over the row: warp shuffles within the group, and shared
//   memory where a group spans warps.
// * float32 statistics, two passes over the registers: the mean, then the
//   sum of squared deviations.  Saved for the backward: the input in its
//   own type, mean and rstd per row in float32.
// * backward: dx = rstd (g gamma - mean(g gamma) - xhat mean(g gamma xhat))
//   from one read of dy and x.  dgamma and dbeta: each thread sums g xhat
//   and g over the rows it visits (a fixed grid of blocks walks the rows),
//   each block sums its threads' columns in a fixed order into a (blocks,
//   2, C) float32 scratch, and a second kernel adds the blocks in a fixed
//   order in double.  No atomics: the same inputs give the same bits.
// * widths: C = 96 * 2^k up to 1536, Swin-T's at every site; a width the
//   library was not built for is refused (cudaErrorInvalidValue).
// * launches on PyTorch's current stream, never synchronises, allocates
//   nothing (the wrapper gives the outputs and the scratch), and returns
//   cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPacks = 3;  // 16-byte packs of x a thread holds of each row

typedef __nv_bfloat16 bf16;

template <typename T> struct Pack { static constexpr int N = 16 / sizeof(T); };

// How a row of C elements of type Tin is spread over a group of TPR threads.
template <typename Tin, int C> struct Shape {
  static constexpr int P = Pack<Tin>::N;
  static constexpr int TPR = C / (P * kPacks);
  static constexpr int RG = kThreads / TPR;  // rows a block holds at once
  static_assert(C % (P * kPacks) == 0, "a row is a whole number of packs a thread");
  static_assert(TPR >= 2 && TPR <= kThreads && (TPR & (TPR - 1)) == 0,
                "threads a row: a power of two within the block");
};

// E consecutive elements at p (aligned to E elements) as floats, and back
template <int E>
__device__ __forceinline__ void load(const float* p, float (&v)[E]) {
  static_assert(E % 4 == 0, "float32 in 16-byte vectors");
#pragma unroll
  for (int i = 0; i < E; i += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}
template <int E>
__device__ __forceinline__ void load(const bf16* p, float (&v)[E]) {
  static_assert(E == 4 || E % 8 == 0, "bf16 in 8- or 16-byte vectors");
  if constexpr (E == 4) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E; i += 8) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p + i));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        v[i + 2 * j] = f.x;
        v[i + 2 * j + 1] = f.y;
      }
    }
  }
}
template <int E>
__device__ __forceinline__ void store(float* p, const float (&v)[E]) {
  static_assert(E % 4 == 0, "float32 in 16-byte vectors");
#pragma unroll
  for (int i = 0; i < E; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int E>
__device__ __forceinline__ void store(bf16* p, const float (&v)[E]) {
  static_assert(E == 4 || E % 8 == 0, "bf16 in 8- or 16-byte vectors");
  if constexpr (E == 4) {
    uint2 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
    h[0] = __floats2bfloat162_rn(v[0], v[1]);
    h[1] = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = q;
  } else {
#pragma unroll
    for (int i = 0; i < E; i += 8) {
      uint4 q;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
      *reinterpret_cast<uint4*>(p + i) = q;
    }
  }
}

// The sums of s[0..N) over the TPR threads of each row group, the same bits
// in every thread of the group: a butterfly of shuffles within the warp,
// then, where the group spans warps, the warps' sums through shared memory
// (red: N * kWarps floats) added in warp order.  Every thread of the block
// must call it (it may synchronise the block).
template <int TPR, int N>
__device__ __forceinline__ void row_sum(float (&s)[N], float* red) {
  constexpr int W = TPR < 32 ? TPR : 32;
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) {
#pragma unroll
    for (int k = 0; k < N; ++k) s[k] += __shfl_xor_sync(0xffffffffu, s[k], o);
  }
  if constexpr (TPR > 32) {
    constexpr int K = TPR / 32;  // warps a row
    const int w = threadIdx.x >> 5;
    __syncthreads();  // red may still be read from the last call
    if ((threadIdx.x & 31) == 0) {
#pragma unroll
      for (int k = 0; k < N; ++k) red[k * kWarps + w] = s[k];
    }
    __syncthreads();
    const int first = w / K * K;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) t += red[k * kWarps + first + j];
      s[k] = t;
    }
  }
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// ---- forward -------------------------------------------------------------

// Each block walks rows RG at a time, blockIdx.x * RG + k * gridDim.x * RG
// (every thread of the block takes every step, a row past the end as
// zeros, so that row_sum may synchronise).
template <typename Tin, typename Tout, int C>
__global__ void __launch_bounds__(kThreads)
layer_norm_fwd(const Tin* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, Tout* __restrict__ y, float* __restrict__ mean_out,
               float* __restrict__ rstd_out, long long rows, float eps) {
  using S = Shape<Tin, C>;
  constexpr int P = S::P, TPR = S::TPR, RG = S::RG;
  __shared__ float red[kWarps];
  const int lane = threadIdx.x % TPR;
  const long long step = (long long)gridDim.x * RG;
  for (long long base = (long long)blockIdx.x * RG; base < rows; base += step) {
    const long long row = base + threadIdx.x / TPR;
    const bool live = row < rows;
    float v[kPacks][P];
    float s[1] = {0.f};
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
      if (live) {
        load<P>(x + row * C + (j * TPR + lane) * P, v[j]);
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) v[j][i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < P; ++i) s[0] += v[j][i];
    }
    row_sum<TPR>(s, red);
    const float mean = s[0] / (float)C;
    float q[1] = {0.f};
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const float d = v[j][i] - mean;
        q[0] = fmaf(d, d, q[0]);
      }
    }
    row_sum<TPR>(q, red);
    const float rstd = rsqrtf(q[0] / (float)C + eps);
    if (live) {
#pragma unroll
      for (int j = 0; j < kPacks; ++j) {
        const int col = (j * TPR + lane) * P;
        float g[P], b[P], o[P];
        load<P>(gamma + col, g);
        load<P>(beta + col, b);
#pragma unroll
        for (int i = 0; i < P; ++i) o[i] = fmaf((v[j][i] - mean) * rstd, g[i], b[i]);
        store<P>(y + row * C + col, o);
      }
      if (lane == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
  }
}

// ---- backward ------------------------------------------------------------

// dx of each row the block visits (as the forward walks them), and the
// block's sums of dy * xhat and of dy per column into
// partials[blockIdx.x][0 or 1][C].
template <typename Tin, typename Tout, int C>
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd(const Tout* __restrict__ dy, const Tin* __restrict__ x,
               const float* __restrict__ mean, const float* __restrict__ rstd,
               const float* __restrict__ gamma, Tin* __restrict__ dx,
               float* __restrict__ partials, long long rows) {
  using S = Shape<Tin, C>;
  constexpr int P = S::P, TPR = S::TPR, RG = S::RG;
  __shared__ float red[2 * kWarps];
  __shared__ float cols[RG * C];  // each row group's column sums
  const int lane = threadIdx.x % TPR, grp = threadIdx.x / TPR;
  float dg[kPacks][P], db[kPacks][P];
#pragma unroll
  for (int j = 0; j < kPacks; ++j) {
#pragma unroll
    for (int i = 0; i < P; ++i) dg[j][i] = db[j][i] = 0.f;
  }
  const long long step = (long long)gridDim.x * RG;
  for (long long base = (long long)blockIdx.x * RG; base < rows; base += step) {
    const long long row = base + grp;
    const bool live = row < rows;
    const float m = live ? __ldg(mean + row) : 0.f, rs = live ? __ldg(rstd + row) : 0.f;
    float t[kPacks][P], d[kPacks][P];
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
      const int col = (j * TPR + lane) * P;
      if (live) {
        load<P>(x + row * C + col, t[j]);
        load<P>(dy + row * C + col, d[j]);
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) t[j][i] = d[j][i] = 0.f;
      }
      float g[P];
      load<P>(gamma + col, g);
#pragma unroll
      for (int i = 0; i < P; ++i) {
        t[j][i] = (t[j][i] - m) * rs;  // xhat
        const float a = d[j][i] * g[i];
        s[0] += a;
        s[1] = fmaf(a, t[j][i], s[1]);
        dg[j][i] = fmaf(d[j][i], t[j][i], dg[j][i]);
        db[j][i] += d[j][i];
      }
    }
    row_sum<TPR>(s, red);
    const float c1 = s[0] / (float)C, c2 = s[1] / (float)C;
    if (live) {
#pragma unroll
      for (int j = 0; j < kPacks; ++j) {
        const int col = (j * TPR + lane) * P;
        float g[P], o[P];
        load<P>(gamma + col, g);
#pragma unroll
        for (int i = 0; i < P; ++i) o[i] = rs * (fmaf(d[j][i], g[i], -c1) - t[j][i] * c2);
        store<P>(dx + row * C + col, o);
      }
    }
  }
  // the block's column sums: row groups added in order, dgamma's then dbeta's
#pragma unroll
  for (int which = 0; which < 2; ++which) {
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPacks; ++j) {
#pragma unroll
      for (int i = 0; i < P; ++i)
        cols[grp * C + (j * TPR + lane) * P + i] = which ? db[j][i] : dg[j][i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float acc = 0.f;
      for (int r = 0; r < RG; ++r) acc += cols[r * C + c];
      partials[((long long)blockIdx.x * 2 + which) * C + c] = acc;
    }
  }
}

// dgamma and dbeta: the blocks' partial sums added in double, one warp a
// (parameter, column), in a fixed order.
__global__ void __launch_bounds__(kThreads)
layer_norm_bwd_params(const float* __restrict__ partials, int blocks, int c,
                      float* __restrict__ dgamma, float* __restrict__ dbeta) {
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5), l = threadIdx.x & 31;
  if (w >= 2 * c) return;  // the whole warp
  const int which = w / c, col = w % c;
  double s = 0.0;
  for (int b = l; b < blocks; b += 32) s += partials[((long long)b * 2 + which) * c + col];
  s = warp_sum(s);
  if (l == 0) (which ? dbeta : dgamma)[col] = (float)s;
}

// ---- dispatch ------------------------------------------------------------

struct Args {
  const void *x, *dy;
  const float *gamma, *beta, *mean_in, *rstd_in;
  void *y, *dx;
  float *mean, *rstd, *dgamma, *dbeta, *partials;
  long long rows;
  float eps;
  cudaStream_t stream;
};

// Blocks of `kernel` the card holds at once.
int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

// Blocks a launch walks `rows` with: every row group of the grid busy, and
// no more blocks than the card holds at once (the backward's scratch is
// sized by it, so it depends on the shape and the card alone).
template <typename Tin, int C>
int grid_for(int resident, long long rows) {
  const long long need = (rows + Shape<Tin, C>::RG - 1) / Shape<Tin, C>::RG;
  return (int)(need < resident ? need : resident);
}

template <typename Tin, typename Tout, int C>
struct Fwd {
  static int run(const Args& a) {
    static const int resident =
        resident_blocks(reinterpret_cast<const void*>(&layer_norm_fwd<Tin, Tout, C>));
    layer_norm_fwd<Tin, Tout, C><<<grid_for<Tin, C>(resident, a.rows), kThreads, 0, a.stream>>>(
        static_cast<const Tin*>(a.x), a.gamma, a.beta, static_cast<Tout*>(a.y), a.mean, a.rstd,
        a.rows, a.eps);
    return 0;
  }
};

template <typename Tin, typename Tout, int C>
struct BwdBlocks {
  static int run(const Args& a) {
    static const int resident =
        resident_blocks(reinterpret_cast<const void*>(&layer_norm_bwd<Tin, Tout, C>));
    return grid_for<Tin, C>(resident, a.rows);
  }
};

template <typename Tin, typename Tout, int C>
struct Bwd {
  static int run(const Args& a) {
    const int blocks = BwdBlocks<Tin, Tout, C>::run(a);
    layer_norm_bwd<Tin, Tout, C><<<blocks, kThreads, 0, a.stream>>>(
        static_cast<const Tout*>(a.dy), static_cast<const Tin*>(a.x), a.mean_in, a.rstd_in,
        a.gamma, static_cast<Tin*>(a.dx), a.partials, a.rows);
    layer_norm_bwd_params<<<(2 * C + kWarps - 1) / kWarps, kThreads, 0, a.stream>>>(
        a.partials, blocks, C, a.dgamma, a.dbeta);
    return 0;
  }
};

template <template <typename, typename, int> class L, int C>
int by_types(int in_bf16, int out_bf16, const Args& a) {
  if (in_bf16 && out_bf16) return L<bf16, bf16, C>::run(a);
  if (in_bf16) return L<bf16, float, C>::run(a);
  if (out_bf16) return L<float, bf16, C>::run(a);
  return L<float, float, C>::run(a);
}

// L<Tin, Tout, C>::run(a) for the operands' types and width; -1 for a width
// the library was not built for.
template <template <typename, typename, int> class L>
int dispatch(int c, int in_bf16, int out_bf16, const Args& a) {
  switch (c) {
    case 96: return by_types<L, 96>(in_bf16, out_bf16, a);
    case 192: return by_types<L, 192>(in_bf16, out_bf16, a);
    case 384: return by_types<L, 384>(in_bf16, out_bf16, a);
    case 768: return by_types<L, 768>(in_bf16, out_bf16, a);
    case 1536: return by_types<L, 1536>(in_bf16, out_bf16, a);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// Blocks layer_norm_bwd walks `rows` rows of width c with: its scratch
// `partials` holds blocks * 2 * c float32.  0 for a width not built.
int layer_norm_bwd_blocks(long long rows, int c, int in_bf16, int out_bf16) {
  Args a = {};
  a.rows = rows;
  const int blocks = rows >= 1 ? dispatch<BwdBlocks>(c, in_bf16, out_bf16, a) : -1;
  return blocks < 0 ? 0 : blocks;
}

// Forward over `rows` rows of c contiguous elements of x (bf16 or float32,
// 16-byte aligned): y (bf16 or float32), mean and rstd (rows float32 each).
// gamma, beta: c float32, 16-byte aligned.
int layer_norm_fwd(const void* x, const float* gamma, const float* beta, void* y, float* mean,
                   float* rstd, long long rows, int c, float eps, int in_bf16, int out_bf16,
                   void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x; a.gamma = gamma; a.beta = beta; a.y = y; a.mean = mean; a.rstd = rstd;
  a.rows = rows; a.eps = eps;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dispatch<Fwd>(c, in_bf16, out_bf16, a) < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Backward of layer_norm_fwd: dx (x's type), dgamma and dbeta (c float32)
// from dy (y's type, rows contiguous, 16-byte aligned) and what the forward
// saved.  partials: layer_norm_bwd_blocks(rows, c, ...) * 2 * c float32.
int layer_norm_bwd(const void* dy, const void* x, const float* mean, const float* rstd,
                   const float* gamma, void* dx, float* dgamma, float* dbeta, float* partials,
                   long long rows, int c, int in_bf16, int out_bf16, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.dy = dy; a.x = x; a.mean_in = mean; a.rstd_in = rstd; a.gamma = gamma; a.dx = dx;
  a.dgamma = dgamma; a.dbeta = dbeta; a.partials = partials; a.rows = rows;
  a.stream = static_cast<cudaStream_t>(stream);
  if (dispatch<Bwd>(c, in_bf16, out_bf16, a) < 0) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
