// GroupNorm, an optional residual add and an optional ReLU, forward and
// backward, for Hopper (sm_90a):
//   y = act((x - mu_g) * rstd_g * gamma_c + beta_c [+ r])
// over an NCHW-contiguous x, with mu_g and rstd_g = 1 / sqrt(var_g + eps)
// over each (sample, group): C / G channels of H * W elements, one
// contiguous run of the tensor.
//
// Replaces no TPU kernel: the JAX package's TransUNet has none; XLA fuses
// its GroupNorm.  On the card PyTorch runs TransUNet's ResNetV2 norms
// (models/transunet.py: the root, gn1, gn2, gn3 with the unit's residual,
// gn_proj) under bf16 autocast as float32 group_norm with the conv output
// cast up, a float32 ReLU, a float32 add and a cast back before the next
// convolution, and their float32 mirrors backward; autograd keeps a float32
// copy of every norm's input and every ReLU's output.
//
// Bound: memory.  A forward reads x and writes y; a backward reads the
// gradient of y and x and writes the gradient of x: a few flops an element.
// At 1024^2, batch 8, the 52 norms hold 1.90 G elements.
//
// Design:
// * two launches each way.  The forward's first kernel sums x and x^2 over
//   a slice of a group (each group is split over several blocks, so that a
//   few hundred groups fill 132 SMs; the split follows the group's size);
//   the second combines a group's partial sums in a fixed order, and
//   normalises.  The backward's first kernel sums, per (sample, channel),
//   the masked gradient g and g * xhat; the second combines them into each
//   group's two means and writes dx, the residual's gradient, and (blocks of
//   sample 0) dgamma and dbeta.  No atomics: the same inputs give the same
//   bits.
// * x's type (bf16 or float32) and y's (bf16 or float32) are separate:
//   y is bf16 where every consumer casts it to bf16 first (the next
//   convolution), float32 on the residual stream.  The gradient of y has
//   y's type, dx x's; the residual and its gradient are float32.
// * 16-byte vector loads of x: a "pack" of 16 / sizeof(x) elements (8 bf16,
//   4 float32) starting at a multiple of the pack in the tensor.  A group
//   or a row need not start on one (H * W = 255^2 is odd), so its first
//   and last few elements take a scalar path.
// * partial sums: each pack summed in float32, then added in double; the
//   variance is E[x^2] - E[x]^2 in double.  Saved for the backward: the
//   input (its own type), mu and rstd per (sample, group) in float32, and,
//   with both a residual and a ReLU, one byte an element saying whether the
//   ReLU passed it.  Without a residual the backward recomputes that from
//   x, mu and rstd by the forward's own operations (the same intrinsics,
//   so the same bits).
// * every pre-activation is (x - mu) * rstd * gamma + beta in that order,
//   each step rounded on its own (__fsub_rn, __fmul_rn, __fmaf_rn), so the
//   forward and the backward agree bit for bit on which elements the ReLU
//   passed.  ReLU keeps NaN, as torch.relu does.
// * on the residual stream (bf16 x, float32 y) the forward may also write y
//   rounded to bf16, for the convolutions that read it (they would cast it
//   to bf16 first), and the backward then takes that copy's gradient too
//   and adds it to y's: no cast kernel forward, no cast and add backward.
// * launches on PyTorch's current stream, never synchronises, allocates
//   nothing (the wrapper gives the outputs and the partial sums), and
//   returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockElems = 16384;  // elements of a segment one block aims at
constexpr int kMaxSplits = 64;      // most blocks one segment is split over

typedef __nv_bfloat16 bf16;

template <typename T> struct Pack { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

// P consecutive elements at p (aligned to P elements of the pack's type) as floats
template <int P>
__device__ __forceinline__ void load(const float* p, float (&v)[P]) {
#pragma unroll
  for (int i = 0; i < P; i += 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
    v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
  }
}
template <int P>
__device__ __forceinline__ void load(const bf16* p, float (&v)[P]) {
  static_assert(P % 8 == 0, "bf16 packs are 8 elements");
#pragma unroll
  for (int i = 0; i < P; i += 8) {
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
template <int P>
__device__ __forceinline__ void store(float* p, const float (&v)[P]) {
#pragma unroll
  for (int i = 0; i < P; i += 4)
    *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
template <int P>
__device__ __forceinline__ void store(bf16* p, const float (&v)[P]) {
  static_assert(P % 8 == 0, "bf16 packs are 8 elements");
#pragma unroll
  for (int i = 0; i < P; i += 8) {
    uint4 q;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = q;
  }
}
template <int P>
__device__ __forceinline__ void load_mask(const uint8_t* p, bool (&m)[P]) {
  static_assert(P == 4 || P == 8, "a pack's mask is 4 or 8 bytes");
  if constexpr (P == 8) {
    const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = (q.x >> (8 * i)) & 0xff;
      m[4 + i] = (q.y >> (8 * i)) & 0xff;
    }
  } else {
    const uint32_t q = __ldg(reinterpret_cast<const uint32_t*>(p));
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = (q >> (8 * i)) & 0xff;
  }
}
template <int P>
__device__ __forceinline__ void store_mask(uint8_t* p, const bool (&m)[P]) {
  static_assert(P == 4 || P == 8, "a pack's mask is 4 or 8 bytes");
  uint32_t lo = 0, hi = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) lo |= uint32_t(m[i]) << (8 * i);
  if constexpr (P == 8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) hi |= uint32_t(m[4 + i]) << (8 * i);
    *reinterpret_cast<uint2*>(p) = make_uint2(lo, hi);
  } else {
    *reinterpret_cast<uint32_t*>(p) = lo;
  }
}

// xhat and the pre-activation, each step rounded on its own (file comment)
__device__ __forceinline__ float xhat(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}
__device__ __forceinline__ float affine(float t, float gamma, float beta) {
  return __fmaf_rn(t, gamma, beta);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's sums of a and of b, in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum2(double& a, double& b) {
  __shared__ double sa[kWarps], sb[kWarps];
  a = warp_sum(a);
  b = warp_sum(b);
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  __syncthreads();  // the arrays may still be read from an earlier call
  if (l == 0) {
    sa[w] = a;
    sb[w] = b;
  }
  __syncthreads();
  if (w == 0) {
    a = l < kWarps ? sa[l] : 0.0;
    b = l < kWarps ? sb[l] : 0.0;
    a = warp_sum(a);
    b = warp_sum(b);
  }
}

// A segment [b, e) of the flat tensor cut for packs of P: a scalar head
// [b, a0), packs [a0, a1), a scalar tail [a1, e); and the packs of split s
// of `splits`.
struct Cut {
  long long a0, a1, p0, p1;  // packs of this split: [p0, p1) counted from a0
};
template <int P>
__device__ __forceinline__ Cut cut(long long b, long long e, int s, int splits) {
  Cut c;
  c.a0 = min((b + P - 1) / P * P, e);
  c.a1 = max(e / P * P, c.a0);
  const long long packs = (c.a1 - c.a0) / P;
  c.p0 = packs * s / splits;
  c.p1 = packs * (s + 1) / splits;
  return c;
}

// The channel (within its group) of element i of a group segment that
// starts at b, tracked along increasing i: moves on at each multiple of hw.
struct Channel {
  long long next;  // first element of the next channel
  int c;
  __device__ __forceinline__ Channel(long long b, long long i, long long hw) {
    c = (int)((i - b) / hw);
    next = b + (c + 1) * hw;
  }
  __device__ __forceinline__ int at(long long i, long long hw) {
    while (i >= next) {
      ++c;
      next += hw;
    }
    return c;
  }
};

// ---- forward -------------------------------------------------------------

// Per (group, split): the split's sum of x and of x^2, in double.
template <typename Tin>
__global__ void __launch_bounds__(kThreads)
group_norm_fwd_stats(const Tin* __restrict__ x, double2* __restrict__ partials,
                     long long group_len, int splits) {
  constexpr int P = Pack<Tin>::N;
  const int seg = blockIdx.x / splits, s = blockIdx.x % splits;
  const long long b = seg * group_len, e = b + group_len;
  const Cut c = cut<P>(b, e, s, splits);
  double sum = 0.0, sq = 0.0;
#pragma unroll 4
  for (long long p = c.p0 + threadIdx.x; p < c.p1; p += kThreads) {
    float v[P];
    load<P>(x + c.a0 + p * P, v);
    float ps = 0.f, pq = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      ps += v[i];
      pq = fmaf(v[i], v[i], pq);
    }
    sum += ps;
    sq += pq;
  }
  if (s == 0) {  // the scalar head and tail
    const long long head = c.a0 - b;
    for (long long k = threadIdx.x; k < head + (e - c.a1); k += kThreads) {
      const float v = to_f(x[k < head ? b + k : c.a1 + (k - head)]);
      sum += v;
      sq += (double)v * v;
    }
  }
  block_sum2(sum, sq);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_double2(sum, sq);
}

// mean and rstd of group `seg` from its `splits` partial sums, summed by the
// first warp in a fixed order.
__device__ __forceinline__ void group_stats(const double2* partials, int seg, int splits,
                                            long long group_len, float eps, float& mean,
                                            float& rstd) {
  __shared__ float st[2];
  if (threadIdx.x < 32) {
    double sum = 0.0, sq = 0.0;
    for (int s = threadIdx.x; s < splits; s += 32) {
      sum += partials[seg * splits + s].x;
      sq += partials[seg * splits + s].y;
    }
    sum = warp_sum(sum);
    sq = warp_sum(sq);
    if (threadIdx.x == 0) {
      const double m = sum / (double)group_len;
      const double var = fmax(sq / (double)group_len - m * m, 0.0);
      st[0] = (float)m;
      st[1] = (float)(1.0 / sqrt(var + (double)eps));
    }
  }
  __syncthreads();
  mean = st[0];
  rstd = st[1];
}

template <bool RES, bool RELU>
__device__ __forceinline__ float fwd_element(float xv, float mean, float rstd, float gamma,
                                             float beta, float rv, bool& pass) {
  float z = affine(xhat(xv, mean, rstd), gamma, beta);
  if (RES) z = __fadd_rn(z, rv);
  if (RELU) {
    pass = z > 0.f;
    return z <= 0.f ? 0.f : z;
  }
  return z;
}

// Per (group, split): normalise the split's elements.  Split 0 of each
// group also writes the group's mean and rstd, and does the scalar head and
// tail.  mask: one byte an element (RES and RELU only).
template <typename Tin, typename Tout, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
group_norm_fwd_apply(const Tin* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const float* __restrict__ r,
                     Tout* __restrict__ y, bf16* __restrict__ y_low, uint8_t* __restrict__ mask,
                     const double2* __restrict__ partials, float* __restrict__ mean_out,
                     float* __restrict__ rstd_out, int groups, int cpg, long long hw,
                     float eps, int splits) {
  constexpr int P = Pack<Tin>::N;
  const int seg = blockIdx.x / splits, s = blockIdx.x % splits;
  const long long group_len = cpg * hw;
  const long long b = seg * group_len, e = b + group_len;
  float mean, rstd;
  group_stats(partials, seg, splits, group_len, eps, mean, rstd);
  if (s == 0 && threadIdx.x == 0) {
    mean_out[seg] = mean;
    rstd_out[seg] = rstd;
  }
  const float* gam = gamma + (seg % groups) * cpg;
  const float* bet = beta + (seg % groups) * cpg;
  const bool keep_mask = RES && RELU && mask != nullptr;
  const Cut c = cut<P>(b, e, s, splits);
#pragma unroll 2
  for (long long p = c.p0 + threadIdx.x; p < c.p1; p += kThreads) {
    const long long i0 = c.a0 + p * P;
    float v[P], rv[P], out[P];
    bool pass[P];
    load<P>(x + i0, v);
    if (RES) load<P>(r + i0, rv);
    Channel ch(b, i0, hw);
    int cur = ch.c;
    float g = __ldg(gam + cur), bb = __ldg(bet + cur);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = ch.at(i0 + i, hw);
      if (k != cur) {
        cur = k;
        g = __ldg(gam + cur);
        bb = __ldg(bet + cur);
      }
      out[i] = fwd_element<RES, RELU>(v[i], mean, rstd, g, bb, RES ? rv[i] : 0.f,
                                                 pass[i]);
    }
    store<P>(y + i0, out);
    if constexpr (P % 8 == 0) {
      if (y_low != nullptr) store<P>(y_low + i0, out);
    }
    if (keep_mask) store_mask<P>(mask + i0, pass);
  }
  if (s == 0) {
    const long long head = c.a0 - b;
    for (long long k = threadIdx.x; k < head + (e - c.a1); k += kThreads) {
      const long long i = k < head ? b + k : c.a1 + (k - head);
      const int ci = (int)((i - b) / hw);
      bool pass = false;
      const float out = fwd_element<RES, RELU>(
          to_f(x[i]), mean, rstd, __ldg(gam + ci), __ldg(bet + ci), RES ? r[i] : 0.f, pass);
      y[i] = from_f<Tout>(out);
      if (y_low != nullptr) y_low[i] = __float2bfloat16_rn(out);
      if (keep_mask) mask[i] = pass;
    }
  }
}

// ---- backward ------------------------------------------------------------

// The gradient of y plus, where the forward also wrote y's bf16 copy, that
// copy's gradient: one float32 add, as autograd would sum the two.
template <int P>
__device__ __forceinline__ void add_low(const bf16* dy_low, long long i0, float (&d)[P]) {
  if constexpr (P % 8 == 0) {
    if (dy_low != nullptr) {
      float l[P];
      load<P>(dy_low + i0, l);
#pragma unroll
      for (int i = 0; i < P; ++i) d[i] = __fadd_rn(d[i], l[i]);
    }
  }
}
template <typename Tout>
__device__ __forceinline__ float grad_at(const Tout* dy, const bf16* dy_low, long long i) {
  const float d = to_f(dy[i]);
  return dy_low != nullptr ? __fadd_rn(d, to_f(dy_low[i])) : d;
}

// The upstream gradient where the ReLU passed the element, else 0.
template <bool RES, bool RELU>
__device__ __forceinline__ float masked(float dy, float t, float gamma, float beta, bool pass) {
  if (!RELU) return dy;
  if (!RES) pass = affine(t, gamma, beta) > 0.f;
  return pass ? dy : 0.f;
}

// Per ((sample, channel) row, split): the split's sums of g and of g * xhat.
template <typename Tin, typename Tout, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_sums(const Tout* __restrict__ dy, const bf16* __restrict__ dy_low,
                    const Tin* __restrict__ x,
                    const uint8_t* __restrict__ mask, const float* __restrict__ mean,
                    const float* __restrict__ rstd, const float* __restrict__ gamma,
                    const float* __restrict__ beta, double2* __restrict__ partials, int channels,
                    int cpg, long long hw, int splits) {
  constexpr int P = Pack<Tin>::N;
  const int row = blockIdx.x / splits, s = blockIdx.x % splits;
  const int ch = row % channels, grp = (row / channels) * (channels / cpg) + ch / cpg;
  const float m = __ldg(mean + grp), rs = __ldg(rstd + grp);
  const float g = __ldg(gamma + ch), bb = __ldg(beta + ch);
  const long long b = row * hw, e = b + hw;
  const Cut c = cut<P>(b, e, s, splits);
  double s1 = 0.0, s2 = 0.0;
#pragma unroll 4
  for (long long p = c.p0 + threadIdx.x; p < c.p1; p += kThreads) {
    const long long i0 = c.a0 + p * P;
    float v[P], d[P];
    bool pass[P];
    load<P>(x + i0, v);
    load<P>(dy + i0, d);
    add_low<P>(dy_low, i0, d);
    if (RES && RELU) load_mask<P>(mask + i0, pass);
    float a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const float t = xhat(v[i], m, rs);
      const float gi = masked<RES, RELU>(d[i], t, g, bb, RES && RELU ? pass[i] : true);
      a1 += gi;
      a2 = fmaf(gi, t, a2);
    }
    s1 += a1;
    s2 += a2;
  }
  if (s == 0) {
    const long long head = c.a0 - b;
    for (long long k = threadIdx.x; k < head + (e - c.a1); k += kThreads) {
      const long long i = k < head ? b + k : c.a1 + (k - head);
      const float t = xhat(to_f(x[i]), m, rs);
      const bool pass = RES && RELU ? mask[i] != 0 : true;
      const float gi = masked<RES, RELU>(grad_at(dy, dy_low, i), t, g, bb, pass);
      s1 += gi;
      s2 += (double)gi * t;
    }
  }
  block_sum2(s1, s2);
  if (threadIdx.x == 0) partials[blockIdx.x] = make_double2(s1, s2);
}

// Per (group, split): dx = rstd * (g gamma - mean(g gamma) - xhat mean(g gamma xhat))
// over the group, and dr = g.  Blocks of split 0 of sample 0 also write
// dgamma and dbeta of the group's channels (sums over the samples).
template <typename Tin, typename Tout, bool RES, bool RELU>
__global__ void __launch_bounds__(kThreads)
group_norm_bwd_apply(const Tout* __restrict__ dy, const bf16* __restrict__ dy_low,
                     const Tin* __restrict__ x,
                     const uint8_t* __restrict__ mask, const float* __restrict__ mean,
                     const float* __restrict__ rstd, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const double2* __restrict__ row_partials,
                     Tin* __restrict__ dx, float* __restrict__ dr, float* __restrict__ dgamma,
                     float* __restrict__ dbeta, int samples, int groups, int cpg, long long hw,
                     int row_splits, int splits) {
  constexpr int P = Pack<Tin>::N;
  const int seg = blockIdx.x / splits, s = blockIdx.x % splits;
  const int n = seg / groups, grp = seg % groups, channels = groups * cpg;
  const float* gam = gamma + grp * cpg;
  const float* bet = beta + grp * cpg;
  // the group's sums of g gamma and of g gamma xhat, from its rows' partials
  double a = 0.0, bsum = 0.0;
  for (int k = threadIdx.x; k < cpg; k += kThreads) {
    const double2* rp = row_partials + (long long)(n * channels + grp * cpg + k) * row_splits;
    double s1 = 0.0, s2 = 0.0;
    for (int j = 0; j < row_splits; ++j) {
      s1 += rp[j].x;
      s2 += rp[j].y;
    }
    a += (double)gam[k] * s1;
    bsum += (double)gam[k] * s2;
  }
  block_sum2(a, bsum);
  __shared__ float coef[2];
  const long long group_len = cpg * hw;
  if (threadIdx.x == 0) {
    coef[0] = (float)(a / (double)group_len);
    coef[1] = (float)(bsum / (double)group_len);
  }
  __syncthreads();
  const float c1 = coef[0], c2 = coef[1];
  const float m = __ldg(mean + seg), rs = __ldg(rstd + seg);
  if (s == 0 && n == 0) {
    for (int k = threadIdx.x; k < cpg; k += kThreads) {
      double s1 = 0.0, s2 = 0.0;
      for (int nn = 0; nn < samples; ++nn) {
        const double2* rp = row_partials + (long long)(nn * channels + grp * cpg + k) * row_splits;
        for (int j = 0; j < row_splits; ++j) {
          s1 += rp[j].x;
          s2 += rp[j].y;
        }
      }
      dbeta[grp * cpg + k] = (float)s1;
      dgamma[grp * cpg + k] = (float)s2;
    }
  }
  const long long b = seg * group_len, e = b + group_len;
  const Cut c = cut<P>(b, e, s, splits);
#pragma unroll 2
  for (long long p = c.p0 + threadIdx.x; p < c.p1; p += kThreads) {
    const long long i0 = c.a0 + p * P;
    float v[P], d[P], gx[P], gr[P];
    bool pass[P];
    load<P>(x + i0, v);
    load<P>(dy + i0, d);
    add_low<P>(dy_low, i0, d);
    if (RES && RELU) load_mask<P>(mask + i0, pass);
    Channel ch(b, i0, hw);
    int cur = ch.c;
    float g = __ldg(gam + cur), bb = __ldg(bet + cur);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int k = ch.at(i0 + i, hw);
      if (k != cur) {
        cur = k;
        g = __ldg(gam + cur);
        bb = __ldg(bet + cur);
      }
      const float t = xhat(v[i], m, rs);
      const float gi = masked<RES, RELU>(d[i], t, g, bb, RES && RELU ? pass[i] : true);
      gr[i] = gi;
      gx[i] = rs * (fmaf(gi, g, -c1) - t * c2);
    }
    store<P>(dx + i0, gx);
    if (RES) store<P>(dr + i0, gr);
  }
  if (s == 0) {
    const long long head = c.a0 - b;
    for (long long k = threadIdx.x; k < head + (e - c.a1); k += kThreads) {
      const long long i = k < head ? b + k : c.a1 + (k - head);
      const int ci = (int)((i - b) / hw);
      const float g = __ldg(gam + ci), bb = __ldg(bet + ci);
      const float t = xhat(to_f(x[i]), m, rs);
      const bool pass = RES && RELU ? mask[i] != 0 : true;
      const float gi = masked<RES, RELU>(grad_at(dy, dy_low, i), t, g, bb, pass);
      dx[i] = from_f<Tin>(rs * (fmaf(gi, g, -c1) - t * c2));
      if (RES) dr[i] = gi;
    }
  }
}

// ---- dispatch ------------------------------------------------------------

struct Args {
  const void *x, *dy;
  const float* r;
  const float *gamma, *beta;
  void *y, *dx;
  bf16* y_low;
  const bf16* dy_low;
  float* dr;
  uint8_t* mask;
  float *mean, *rstd, *dgamma, *dbeta;
  double2 *partials, *row_partials;
  int n, c, groups, splits, row_splits;
  long long hw;
  float eps;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, bool RES, bool RELU>
void launch_fwd(const Args& a) {
  const int cpg = a.c / a.groups;
  const int segs = a.n * a.groups;
  group_norm_fwd_stats<Tin><<<segs * a.splits, kThreads, 0, a.stream>>>(
      static_cast<const Tin*>(a.x), a.partials, cpg * a.hw, a.splits);
  group_norm_fwd_apply<Tin, Tout, RES, RELU><<<segs * a.splits, kThreads, 0, a.stream>>>(
      static_cast<const Tin*>(a.x), a.gamma, a.beta, a.r,
      static_cast<Tout*>(a.y), a.y_low, a.mask, a.partials, a.mean, a.rstd, a.groups, cpg, a.hw,
      a.eps,
      a.splits);
}

template <typename Tin, typename Tout, bool RES, bool RELU>
void launch_bwd(const Args& a) {
  const int cpg = a.c / a.groups;
  group_norm_bwd_sums<Tin, Tout, RES, RELU><<<a.n * a.c * a.row_splits, kThreads, 0, a.stream>>>(
      static_cast<const Tout*>(a.dy), a.dy_low, static_cast<const Tin*>(a.x), a.mask, a.mean,
      a.rstd, a.gamma, a.beta, a.row_partials, a.c, cpg, a.hw, a.row_splits);
  group_norm_bwd_apply<Tin, Tout, RES, RELU>
      <<<a.n * a.groups * a.splits, kThreads, 0, a.stream>>>(
          static_cast<const Tout*>(a.dy), a.dy_low, static_cast<const Tin*>(a.x), a.mask, a.mean,
          a.rstd, a.gamma, a.beta, a.row_partials, static_cast<Tin*>(a.dx), a.dr,
          a.dgamma, a.dbeta, a.n, a.groups, cpg, a.hw, a.row_splits, a.splits);
}

// One of the twelve instantiations of `launch` by the operands' types and
// the residual and ReLU flags; false for a pairing the library does not have
// (float32 x with bf16 y).
template <template <typename, typename, bool, bool> class L>
bool dispatch(int in_bf16, int out_bf16, bool res, bool relu, const Args& a) {
#define PIIS_GN_FLAGS(TI, TO)                             \
  if (res && relu) L<TI, TO, true, true>::run(a);         \
  else if (res) L<TI, TO, true, false>::run(a);           \
  else if (relu) L<TI, TO, false, true>::run(a);          \
  else L<TI, TO, false, false>::run(a);
  if (in_bf16 && out_bf16) {
    PIIS_GN_FLAGS(bf16, bf16)
  } else if (in_bf16) {
    PIIS_GN_FLAGS(bf16, float)
  } else if (!out_bf16) {
    PIIS_GN_FLAGS(float, float)
  } else {
    return false;
  }
#undef PIIS_GN_FLAGS
  return true;
}

template <typename Tin, typename Tout, bool RES, bool RELU>
struct Fwd { static void run(const Args& a) { launch_fwd<Tin, Tout, RES, RELU>(a); } };
template <typename Tin, typename Tout, bool RES, bool RELU>
struct Bwd { static void run(const Args& a) { launch_bwd<Tin, Tout, RES, RELU>(a); } };

int splits_for(long long len) {
  const long long s = (len + kBlockElems - 1) / kBlockElems;
  return (int)(s < 1 ? 1 : (s > kMaxSplits ? kMaxSplits : s));
}

bool shape_ok(int n, int c, long long hw, int groups) {
  return n >= 1 && c >= 1 && hw >= 1 && groups >= 1 && c % groups == 0 &&
         (long long)n * c * hw < (1LL << 40);
}

}  // namespace

extern "C" {

// Blocks a segment of `len` elements is split over (a group in the forward
// and in the backward's second pass, a (sample, channel) row in its first):
// the wrapper sizes the partial sums with it.
int group_norm_splits(long long len) { return splits_for(len); }

// Forward over x (n, c, hw) NCHW-contiguous, 16-byte aligned, with `groups`
// groups: y (and, with a residual r and a ReLU, mask, one byte an element,
// or null to keep none), mean and rstd (n * groups float32 each).  y_low
// (bf16 x, float32 y only; or null): y rounded to bf16 as well.  partials:
// n * groups * group_norm_splits(c / groups * hw) double2.  r: float32.
int group_norm_fwd(const void* x, const float* gamma, const float* beta, const float* r, void* y,
                   void* y_low, uint8_t* mask, float* mean, float* rstd, void* partials, int n,
                   int c, long long hw, int groups, float eps, int in_bf16, int out_bf16, int relu,
                   void* stream) {
  if (!shape_ok(n, c, hw, groups) || (y_low != nullptr && (!in_bf16 || out_bf16)))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = x; a.r = r; a.gamma = gamma; a.beta = beta; a.y = y; a.mask = mask;
  a.y_low = static_cast<bf16*>(y_low);
  a.mean = mean; a.rstd = rstd; a.partials = static_cast<double2*>(partials);
  a.n = n; a.c = c; a.hw = hw; a.groups = groups; a.eps = eps;
  a.splits = splits_for(c / groups * hw);
  a.stream = static_cast<cudaStream_t>(stream);
  if (!dispatch<Fwd>(in_bf16, out_bf16, r != nullptr, relu != 0, a))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// Backward of group_norm_fwd: dx (x's type), dr (float32; null without a
// residual), dgamma and dbeta (c float32) from dy (y's type, NCHW-contiguous),
// plus dy_low (bf16, the gradient of y_low; or null), and what the forward
// saved.  row_partials: n * c * group_norm_splits(hw)
// double2.
int group_norm_bwd(const void* dy, const void* dy_low, const void* x, const uint8_t* mask,
                   const float* mean, const float* rstd, const float* gamma, const float* beta,
                   void* dx, float* dr, float* dgamma, float* dbeta, void* row_partials, int n,
                   int c, long long hw, int groups, int in_bf16, int out_bf16, int res, int relu,
                   void* stream) {
  if (!shape_ok(n, c, hw, groups) || (res && relu && mask == nullptr) || (res && dr == nullptr) ||
      (dy_low != nullptr && (!in_bf16 || out_bf16)))
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.dy_low = static_cast<const bf16*>(dy_low);
  a.dy = dy; a.x = x; a.mask = const_cast<uint8_t*>(mask); a.mean = const_cast<float*>(mean);
  a.rstd = const_cast<float*>(rstd); a.gamma = gamma; a.beta = beta; a.dx = dx; a.dr = dr;
  a.dgamma = dgamma; a.dbeta = dbeta; a.row_partials = static_cast<double2*>(row_partials);
  a.n = n; a.c = c; a.hw = hw; a.groups = groups;
  a.splits = splits_for(c / groups * hw);
  a.row_splits = splits_for(hw);
  a.stream = static_cast<cudaStream_t>(stream);
  if (!dispatch<Bwd>(in_bf16, out_bf16, res != 0, relu != 0, a))
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // extern "C"
