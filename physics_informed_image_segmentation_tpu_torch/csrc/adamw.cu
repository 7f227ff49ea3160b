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
// 46 tensors) that is 575 MB, 0.172 ms at 3.35 TB/s.  The kernel runs near
// that bound; what a step costs beyond it is the host's work before the
// launch, so the design keeps that work to what changes from step to step.
//
// Design:
// * the TPU kernel packed leaves into 1.5 MiB buckets because of its 16 MiB
//   scoped VMEM, and left bigger leaves to XLA.  Here one launch walks every
//   tensor, as PyTorch's multi_tensor_apply does: each block updates one
//   chunk of kChunk elements of one tensor, so the big tensors spread over
//   all SMs.
// * a plan that lives on the card.  Parameters and moments belong to the
//   optimizer and keep their addresses from step to step, so their pointers
//   and sizes (`table`) and the list of chunks (`chunks`: for every block its
//   tensor and its chunk within that tensor) are written to device memory
//   once, by the wrapper (train/adamw_kernel.py builds both and rebuilds
//   them when a tensor was replaced).  A block finds its work with one load
//   from `chunks` and four from `table`; no search, nothing rebuilt a step.
// * only what changes travels with the launch, by value in the kernel's
//   arguments: the gradients' pointers (autograd hands out new tensors every
//   step; up to kMaxTensors of them, 512 bytes) and bc1, bc2, -lr, wd.  More
//   than kMaxTensors tensors take several launches, a plan each.
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
constexpr int kMaxTensors = 64;           // gradient pointers one launch carries by value

// The plain version's constants: Python doubles rounded to float.
constexpr float kB1 = static_cast<float>(0.9);
constexpr float kOneMinusB1 = static_cast<float>(1.0 - 0.9);
constexpr float kB2 = static_cast<float>(0.999);
constexpr float kOneMinusB2 = static_cast<float>(1.0 - 0.999);
constexpr float kEps = static_cast<float>(1e-8);

// What one launch carries by value.
struct Step {
  const float* g[kMaxTensors];
  float bc1, bc2, neg_lr, wd;
};

__device__ __forceinline__ void adamw_element(float& p, float g, float& m, float& v,
                                              const Step& t) {
  m = __fadd_rn(__fmul_rn(m, kB1), __fmul_rn(g, kOneMinusB1));
  v = __fadd_rn(__fmul_rn(v, kB2), __fmul_rn(__fmul_rn(g, g), kOneMinusB2));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, t.bc2)), kEps);
  float u = __fdiv_rn(__fdiv_rn(m, t.bc1), denom);
  u = __fadd_rn(u, __fmul_rn(p, t.wd));
  p = __fadd_rn(p, __fmul_rn(u, t.neg_lr));
}

// table: (4, count) 64-bit words on the card: the pointers of p, of m and of
// v, then the sizes.  chunks: one (tensor, chunk within it) a block.
__global__ void __launch_bounds__(kThreads)
adamw_kernel(const long long* __restrict__ table, const int2* __restrict__ chunks, int count,
             const __grid_constant__ Step t) {
  const int2 work = chunks[blockIdx.x];
  const int i = work.x;
  const int begin = work.y * kChunk;
  const int len = min((int)table[3 * count + i] - begin, kChunk);
  float* p = reinterpret_cast<float*>(table[i]) + begin;
  float* m = reinterpret_cast<float*>(table[count + i]) + begin;
  float* v = reinterpret_cast<float*>(table[2 * count + i]) + begin;
  const float* g = t.g[i] + begin;

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

// The two numbers a plan is built from: the elements a block updates and the
// most tensors one launch takes.  The wrapper checks its own against them.
void adamw_plan_layout(int* chunk, int* max_tensors) {
  *chunk = kChunk;
  *max_tensors = kMaxTensors;
}

// One AdamW step over the `count` (1..kMaxTensors) tensors of a plan on the
// card: `table` (4, count) and `chunks` (n_chunks, 2) as adamw_kernel reads
// them.  g[i] is this step's gradient of tensor i (host array of device
// pointers), each as large as its parameter.
int adamw_step(const long long* table, const int* chunks, int count, int n_chunks,
               const float* const* g, float bc1, float bc2, float lr, float wd, void* stream) {
  if (count < 1 || count > kMaxTensors || n_chunks < 1) return (int)cudaErrorInvalidValue;
  Step t;
  for (int i = 0; i < count; ++i) t.g[i] = g[i];
  for (int i = count; i < kMaxTensors; ++i) t.g[i] = nullptr;
  t.bc1 = bc1;
  t.bc2 = bc2;
  t.neg_lr = -lr;
  t.wd = wd;
  adamw_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, reinterpret_cast<const int2*>(chunks), count, t);
  return (int)cudaGetLastError();
}

}  // extern "C"
