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
// What bounds it: bytes at prefill, latency at decode.  At
// qwen3-moe-30b-a3b's prefill (T = 3000, E = 128, k = 8) it reads 1.5 MB
// of fp32 logits and writes 0.19 MB (0.5 us at 3.35 TB/s); at decode
// (T = 1) a launch moves 0.6 KB, and what it waits on is the chain of
// dependent steps in one warp.  The Pallas kernel takes a (256, E) block
// per program and reduces along the lanes of a vector register; here a
// token row is one warp's: lane l holds experts l, l + 32, ... in
// registers (E / 32 of them), loads coalesced, nothing through shared
// memory.  The chain is kept short:
//
//   * the row max is one __reduce_max_sync (redux.sync) over the logits'
//     bits mapped to unsigned integers that order as the floats; the sum
//     of exp is a 5-step shuffle butterfly (no integer form);
//   * every p is >= 0, so its fp32 bits order as unsigned integers: an
//     expert ranks by bits(p) + 1 and padding past E by 0, so an
//     underflowed p = 0 still ranks above anything no longer in play, as
//     the reference's -1e30 mask does.  Each lane sorts its experts once
//     (the higher rank first, then the lower index); a round is then one
//     __reduce_max_sync over the lanes' heads and one __reduce_min_sync
//     over the indices of the heads that hold it (the lower index on
//     ties), not 10 dependent shuffles, and the winner's lane drops its
//     head.  Every lane learns the winner's weight from the rank itself;
//   * lane j keeps w_j and i_j in registers and writes them once, already
//     divided by the sum.
//
// A block holds min(T, 4) rows, so one decoded token launches one warp.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRowsPerBlock = 4;    // one warp per token row
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// fp32 -> unsigned integer in the floats' order, and back
__device__ __forceinline__ unsigned ordered(float x) {
  const unsigned u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// V logits per lane: E <= 32 * V; k <= E, so a lane keeps at most V of
// the chosen (weight, index) pairs
template <typename T, int V>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
    router_kernel(const T* __restrict__ logits, float* __restrict__ w_out,
                  int* __restrict__ idx_out, int tokens, int experts,
                  int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (row >= tokens) return;  // the whole warp leaves together
  const T* x = logits + (size_t)row * experts;

  float p[V];
  unsigned mk = 0u;
#pragma unroll
  for (int r = 0; r < V; ++r) {
    const int e = r * 32 + lane;
    p[r] = e < experts ? to_f(x[e]) : -INFINITY;
    mk = max(mk, ordered(p[r]));
  }
  const float m = from_ordered(__reduce_max_sync(kFullMask, mk));
  float s = 0.f;
#pragma unroll
  for (int r = 0; r < V; ++r) {
    p[r] = expf(p[r] - m);  // padding: expf(-inf) = 0
    s += p[r];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFullMask, s, o);
  // each lane's experts as (rank, index), sorted best first: the higher
  // rank, then the lower index; a round's winner is some lane's head
  unsigned rank[V], eid[V];
#pragma unroll
  for (int r = 0; r < V; ++r) {
    eid[r] = r * 32 + lane;
    rank[r] = (int)eid[r] < experts ? __float_as_uint(p[r] / s) + 1u : 0u;
  }
#pragma unroll
  for (int i = 1; i < V; ++i)      // insertion sort: stable, so the lower
#pragma unroll                     // index stays first among equal ranks
    for (int j = i; j > 0; --j) {
      const bool sw = rank[j] > rank[j - 1];
      const unsigned r0 = rank[j - 1], e0 = eid[j - 1];
      rank[j - 1] = sw ? rank[j] : r0;
      eid[j - 1] = sw ? eid[j] : e0;
      rank[j] = sw ? r0 : rank[j];
      eid[j] = sw ? e0 : eid[j];
    }

  float my_w[V] = {};
  int my_i[V] = {};
  float total = 0.f;
  for (int j = 0; j < k; ++j) {
    const unsigned best = __reduce_max_sync(kFullMask, rank[0]);
    const unsigned bi = __reduce_min_sync(
        kFullMask, rank[0] == best ? eid[0] : 0xffffffffu);
    const float wj = __uint_as_float(best - 1u);
    if (eid[0] == bi) {            // the winner's lane drops its head
#pragma unroll
      for (int r = 0; r + 1 < V; ++r) {
        rank[r] = rank[r + 1];
        eid[r] = eid[r + 1];
      }
      rank[V - 1] = 0u;
      eid[V - 1] = 0xffffffffu;
    }
#pragma unroll
    for (int t = 0; t < V; ++t) {
      if (t * 32 + lane == j) {
        my_w[t] = wj;
        my_i[t] = (int)bi;
      }
    }
    total += wj;
  }
  const float denom = fmaxf(total, 1e-20f);
  float* w = w_out + (size_t)row * k;
  int* idx = idx_out + (size_t)row * k;
#pragma unroll
  for (int t = 0; t < V; ++t) {
    const int j = t * 32 + lane;
    if (j < k) {
      w[j] = my_w[t] / denom;
      idx[j] = my_i[t];
    }
  }
}

template <typename T, int V>
int launch_v(const void* logits, void* w, void* idx, int tokens,
             int experts, int k, void* stream) {
  const int rows = tokens < kRowsPerBlock ? tokens : kRowsPerBlock;
  const unsigned blocks = (unsigned)((tokens + rows - 1) / rows);
  router_kernel<T, V><<<blocks, rows * 32, 0, (cudaStream_t)stream>>>(
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
