// Top-k softmax MoE router for Hopper (sm_90a), plain C launchers bound
// with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/moe_router/moe_router.py::_router_kernel
// (moe_router_pallas).  Per token row of logits (T, E):
//
//   p = softmax(x)                       fp32, max-subtracted
//   k rounds: w_j = max p, i_j = argmax p (the lower index on ties),
//             then p[i_j] = -1e30
//   w_j /= max(w_0 + ... + w_{k-1}, 1e-20)   (summed in j order)
//
// logits (T, E) fp32 or bf16, contiguous, 1 <= k <= E <= 512; weights
// (T, k) fp32 and indices (T, k) int32 out, in the order chosen.
//
// What bounds it: bytes.  At qwen3-moe-30b-a3b's prefill (T = 3000,
// E = 128, k = 8) it reads 1.5 MB of fp32 logits and writes 0.19 MB
// (0.5 us at 3.35 TB/s) for ~5 operations per logit; at decode (T = 1) a
// launch moves 0.6 KB and is bound by its latency.  The Pallas kernel
// takes a (256, E) block per program and reduces along the lanes of a
// vector register; here a token row is one warp's: lane l holds experts
// l, l + 32, ... in registers (E / 32 of them, padded with -inf when E is
// no multiple of 32), so the loads are coalesced, nothing goes through
// shared memory, and every max, sum and argmax is a 5-step
// __shfl_xor_sync butterfly.  The argmax compares (value, index) pairs:
// the larger value wins, the lower index on equal values, so every lane
// ends with the same winner, whose owner masks it.  Four rows per block
// of 128 threads; T = 3000 gives 750 blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;    // one warp per token row
constexpr float kNegInf = -1e30f;   // NEG_INF of the Pallas body
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// (v, i) becomes (v2, i2) if that is larger, or equal with a lower index
__device__ __forceinline__ void take_better(float& v, int& i, float v2,
                                            int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// V logits per lane: E <= 32 * V
template <typename T, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    router_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                  int* __restrict__ idx_out, int tokens, int experts,
                  int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= tokens) return;  // the whole warp leaves together
  const T* x = logits + (size_t)row * experts;
  float* w = w_out + (size_t)row * k;
  int* idx = idx_out + (size_t)row * k;

  float p[V];
  float m = -INFINITY;
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const int e = r * 32 + lane;
    p[r] = e < experts ? to_f(x[e]) : -INFINITY;
    m = fmaxf(m, p[r]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFullMask, m, o));
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < V; ++r) {
    p[r] = expf(p[r] - m);  // padding: expf(-inf) = 0
    s += p[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
#pragma unroll
  for (int r = 0; r < V; ++r)
    p[r] = r * 32 + lane < experts ? p[r] / s : -INFINITY;

  float total = 0.f;
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = INT32_MAX;
#pragma unroll
    for (int r = 0; r < V; ++r) take_better(bv, bi, p[r], r * 32 + lane);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFullMask, bv, o);
      const int i2 = __shfl_xor_sync(kFullMask, bi, o);
      take_better(bv, bi, v2, i2);
    }
    if (lane == (j & 31)) {  // the same lane rescales it below
      w[j] = bv;
      idx[j] = bi;
    }
#pragma unroll
    for (int r = 0; r < V; ++r)
      if (r * 32 + lane == bi) p[r] = kNegInf;
    total += bv;
  }
  const float denom = fmaxf(total, 1e-20f);
  for (int j = lane; j < k; j += 32) w[j] = w[j] / denom;
}

template <typename T, int V>
int launch_v(const void* logits, void* w, void* idx, int tokens,
             int experts, int k, void* stream) {
  const unsigned blocks =
      (unsigned)((tokens + kRowsPerBlock - 1) / kRowsPerBlock);
  router_kernel<T, V><<<blocks, kRowsPerBlock * 32, 0,
                        (cudaStream_t)stream>>>(
      (const T*)logits, (float*)w, (int*)idx, tokens, experts, k);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* logits, void* w, void* idx, int tokens, int experts,
           int k, void* stream) {
  if (tokens <= 0 || k < 1 || k > experts || experts > 512)
    return (int)cudaErrorInvalidValue;
  if (experts <= 32)
    return launch_v<T, 1>(logits, w, idx, tokens, experts, k, stream);
  if (experts <= 64)
    return launch_v<T, 2>(logits, w, idx, tokens, experts, k, stream);
  if (experts <= 128)
    return launch_v<T, 4>(logits, w, idx, tokens, experts, k, stream);
  if (experts <= 256)
    return launch_v<T, 8>(logits, w, idx, tokens, experts, k, stream);
  return launch_v<T, 16>(logits, w, idx, tokens, experts, k, stream);
}

}  // namespace

// Each launches the kernel and returns cudaGetLastError() (0 = launched).
// The caller guarantees tokens >= 1, 1 <= k <= experts <= 512 and
// contiguous tensors: logits (tokens, experts), w fp32 and idx int32
// (tokens, k).
extern "C" int moe_router_f32(const void* logits, void* w, void* idx,
                              int tokens, int experts, int k, void* stream) {
  return launch<float>(logits, w, idx, tokens, experts, k, stream);
}

extern "C" int moe_router_bf16(const void* logits, void* w, void* idx,
                               int tokens, int experts, int k,
                               void* stream) {
  return launch<__nv_bfloat16>(logits, w, idx, tokens, experts, k, stream);
}
