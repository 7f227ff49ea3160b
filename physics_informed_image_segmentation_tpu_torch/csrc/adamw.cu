// Fused AdamW over many float32 tensors, in place, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// physics_informed_image_segmentation_tpu/train/pallas_optim.py::pallas_adamw
// (_make_bucket_kernel, launched by _fused_update's pallas_call per bucket,
// plus the plain-XLA branch for leaves above the bucket cap).  One AdamW
// step in optax's order, with b1 = 0.9, b2 = 0.999, eps = 1e-8:
//   m <- (1-b1) g + b1 m
//   v <- (1-b2) g^2 + b2 v
//   u <- (m / bc1) / (sqrt(v / bc2) + eps)
//   p <- p + (-lr) (u + wd p)
// bc1 and bc2 are computed on the host in float32, as optax does.
//
// Bound: memory.  Per element it reads p, g, m, v and writes p, m, v: 28
// bytes for ~15 flops.  For the U-Net at base 64 (20,543,809 parameters in
// 46 tensors) that is 575 MB, 0.172 ms at 3.35 TB/s.
//
// Design (this first version is simple and right; making it fast is later
// work):
// * the TPU kernel packed leaves into 1.5 MiB buckets because of its 16 MiB
//   scoped VMEM, and left bigger leaves to XLA.  Here one launch walks every
//   tensor through a chunk table, as PyTorch's multi_tensor_apply does: the
//   tensors' pointers and a prefix sum of their chunk counts travel by value
//   in the kernel's argument (under 4 KB), and each block updates one chunk
//   of kChunk elements of one tensor, so the big tensors spread over all
//   SMs.  More than kMaxTensors tensors take several launches.  Pointers are
//   read at every call: autograd hands out new gradient tensors every step.
// * 16-byte vector loads when all four of a tensor's pointers are 16-byte
//   aligned (chunks start at multiples of kChunk elements), a scalar tail for
//   sizes that are not multiples of 4, and a scalar path otherwise.
// * every operation is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
//   __fsqrt_rn are never contracted into FMAs), so the result is bit-equal to
//   the plain version, whose separate PyTorch kernels each round once.
// * launches on PyTorch's current stream, never synchronises, and returns
//   cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = kThreads * 4 * 4;  // elements a block updates: 4 float4 a thread
constexpr int kMaxTensors = 64;           // the table stays under the 4 KB argument limit

// The plain version's constants: Python doubles rounded to float.
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-8);

struct Table {
  float* p[kMaxTensors];
  const float* g[kMaxTensors];
  float* m[kMaxTensors];
  float* v[kMaxTensors];
  int n[kMaxTensors];
  int chunk_start[kMaxTensors + 1];  // first chunk of each tensor; [count] = total
  int count;
  float bc1, bc2, neg_lr, wd;
};
static_assert(sizeof(Table) <= 4096, "kernel argument too large");

__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              const Table& t) {
  m = __fadd_rn(__fmul_rn(m, kB1), __fmul_rn(g, kOneMinusB1));
  v = __fadd_rn(__fmul_rn(v, kB2), __fmul_rn(__fmul_rn(g, g), kOneMinusB2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, t.bc2)), kEps);
  float u = __fdiv_rn(__fdiv_rn(m, t.bc1), denom);
  u = __fadd_rn(u, __fmul_rn(p, t.wd));
  p = __fadd_rn(p, __fmul_rn(u, t.neg_lr));
}

__global__ void __launch_bounds__(kThreads) adamw_kernel(const __grid_constant__ Table t) {
  const int chunk = blockIdx.x;
  // the tensor whose chunks hold this one: last i with chunk_start[i] <= chunk
  int lo = 0, hi = t.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.chunk_start[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const int begin = (chunk - t.chunk_start[i]) * kChunk;
  const int len = min(t.n[i] - begin, kChunk);
  float* p = t.p[i] + begin;
  const float* g = t.g[i] + begin;
  float* m = t.m[i] + begin;
  float* v = t.v[i] + begin;

  const bool aligned = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v)) &
                        15) == 0;
  int tail = 0;
  if (aligned) {
    const int n_vec = len / 4;
    float4* p4 = reinterpret_cast<float4*>(p);
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int k = threadIdx.x; k < n_vec; k += kThreads) {
      float4 pp = p4[k], mm = m4[k], vv = v4[k];
      const float4 gg = g4[k];
      adamw_element(pp.x, gg.x, mm.x, vv.x, t);
      adamw_element(pp.y, gg.y, mm.y, vv.y, t);
      adamw_element(pp.z, gg.z, mm.z, vv.z, t);
      adamw_element(pp.w, gg.w, mm.w, vv.w, t);
      p4[k] = pp;
      m4[k] = mm;
      v4[k] = vv;
    }
    tail = 4 * n_vec;
  }
  for (int k = tail + threadIdx.x; k < len; k += kThreads) {
    float pp = p[k], mm = m[k], vv = v[k];
    adamw_element(pp, g[k], mm, vv, t);
    p[k] = pp;
    m[k] = mm;
    v[k] = vv;
  }
}

}  // namespace

extern "C" {

// One AdamW step over n_tensors tensors; p[i], g[i], m[i], v[i] each hold
// n[i] float32 values (0 < n[i] < 2^31; zero-size tensors are skipped).
// Writes the number of kernel launches to *launches.
int adamw_step(float* const* p, const float* const* g, float* const* m, float* const* v,
               const long long* n, int n_tensors, float bc1, float bc2, float lr, float wd,
               void* stream, int* launches) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Table t;
  t.bc1 = bc1;
  t.bc2 = bc2;
  t.neg_lr = -lr;
  t.wd = wd;
  t.count = 0;
  t.chunk_start[0] = 0;
  *launches = 0;
  for (int i = 0; i <= n_tensors; ++i) {
    const bool last = i == n_tensors;
    if (t.count > 0 && (last || t.count == kMaxTensors)) {
      adamw_kernel<<<t.chunk_start[t.count], kThreads, 0, s>>>(t);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      ++*launches;
      t.count = 0;
    }
    if (last) break;
    if (n[i] <= 0) continue;
    const int c = t.count;
    t.p[c] = p[i];
    t.g[c] = g[i];
    t.m[c] = m[i];
    t.v[c] = v[i];
    t.n[c] = (int)n[i];
    t.chunk_start[c + 1] = t.chunk_start[c] + (int)((n[i] + kChunk - 1) / kChunk);
    t.count = c + 1;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
