// Mamba-1 selective scan for Hopper (sm_90a), plain C launchers bound
// with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/mamba_scan/mamba_scan.py::_scan_kernel
// (mamba_scan_pallas).  Per batch row b and channel d, with N states:
//
//   h_t = exp(delta_t * A[d]) * h_{t-1} + (delta_t * u_t) * B_t   (N-vector)
//   y_t = <C_t, h_t> + skip[d] * u_t
//
// u, delta, y (B, L, D) and B, C (B, L, N) in fp32 or bf16, A (D, N) and
// skip (D,) fp32, all contiguous; math and state in fp32, y rounded to
// nearest even.  1 <= N <= 32; any L and D, ragged edges masked, no
// padding.  The backward is not a kernel: the wrapper differentiates
// the plain version, as the JAX package does.
//
// Design.  The Pallas kernel walks time chunks as a sequential grid axis
// and carries the (block_d, N) state in VMEM scratch.  Blocks of a CUDA
// grid run in no order, so here the time loop lives inside the block:
// one thread per (batch row, channel) keeps its N states in registers;
// a block holds 128 channels of one batch row (grid D/128 x B).  For
// each chunk of 32 steps the block stages u and delta (coalesced across
// channels, all 32 loads of a thread in flight) and the chunk's B and C
// rows, which every channel of the row shares, in shared memory, then
// steps through it; y is stored coalesced.  The state update is
// computed as the plain version computes it on the card (one rounding
// per multiply and add, no FMA contraction, expf of the rounded
// product), so the states agree bit for bit; only the order of the
// N-sum of y differs.
//
// What bounds it: operations.  At falcon-mamba-7b's training shape
// (B = 4, L = 512, D = 8192, N = 16, bf16) it moves 100.7 MB (u, delta,
// y; B, C, A and skip are small): 0.030 ms at 3.35 TB/s.  It takes
// 268 M exponentials, one special-function (ex2) result each at 16 per
// clock per SM, 4.18 T/s at 132 SMs and 1.98 GHz: 0.064 ms; its 1.6
// GFLOP of fp32 multiplies and adds are 0.024 ms at 67 TFLOP/s.  The
// bound is 0.064 ms.  This first design leaves time on the table: 256
// blocks are ~2 per SM, each thread runs its 512 steps in order, and
// the staging waits on memory between chunks.  A chunked parallel scan
// or 16 lanes per channel (a shuffle reduction of y) are later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 32;     // time steps staged per round

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// kN: N rounded up to 8, 16 or 32; the states past N stay 0 (their B,
// C and A are staged as 0, so exp(0) * 0 + du * 0 = 0 and they add 0).
template <typename T, int kN>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ skip,
                T* __restrict__ y, int len, int dim, int n) {
  __shared__ float s_u[kChunk][kThreads];
  __shared__ float s_dt[kChunk][kThreads];
  __shared__ float s_b[kChunk][kN];
  __shared__ float s_c[kChunk][kN];

  const int tid = threadIdx.x;
  const int d = blockIdx.x * kThreads + tid;
  const bool live = d < dim;
  const size_t row0 = (size_t)blockIdx.y * len;  // row (b, t = 0)

  float av[kN], h[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    av[i] = live && i < n ? a[(size_t)d * n + i] : 0.f;
    h[i] = 0.f;
  }
  const float dskip = live ? skip[d] : 0.f;

  for (int t0 = 0; t0 < len; t0 += kChunk) {
    const int steps = min(kChunk, len - t0);
    __syncthreads();  // every thread is done with the previous chunk
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      float uv = 0.f, dv = 0.f;
      if (live && tt < steps) {
        const size_t off = (row0 + t0 + tt) * dim + d;
        uv = to_f(u[off]);
        dv = to_f(delta[off]);
      }
      s_u[tt][tid] = uv;
      s_dt[tt][tid] = dv;
    }
    for (int k = tid; k < kChunk * kN; k += kThreads) {
      const int tt = k / kN, i = k % kN;
      float bv = 0.f, cv = 0.f;
      if (tt < steps && i < n) {
        const size_t off = (row0 + t0 + tt) * n + i;
        bv = to_f(bm[off]);
        cv = to_f(cm[off]);
      }
      s_b[tt][i] = bv;
      s_c[tt][i] = cv;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float dt = s_dt[tt][tid];
      const float uv = s_u[tt][tid];
      const float du = __fmul_rn(dt, uv);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        const float decay = expf(__fmul_rn(dt, av[i]));
        h[i] = __fadd_rn(__fmul_rn(decay, h[i]), __fmul_rn(du, s_b[tt][i]));
        acc = fmaf(h[i], s_c[tt][i], acc);
      }
      if (live)
        store(y + (row0 + t0 + tt) * dim + d,
              __fadd_rn(acc, __fmul_rn(dskip, uv)));
    }
  }
}

template <typename T>
int launch(const void* u, const void* delta, const void* a, const void* b,
           const void* c, const void* skip, void* y, int batch, int len,
           int dim, int n, void* stream) {
  if (batch <= 0 || batch > 65535 || len <= 0 || dim <= 0 || n < 1 ||
      n > 32)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((dim + kThreads - 1) / kThreads),
                  (unsigned)batch);
  const cudaStream_t s = (cudaStream_t)stream;
#define SCAN_ARGS                                                       \
  (const T*)u, (const T*)delta, (const float*)a, (const T*)b,          \
      (const T*)c, (const float*)skip, (T*)y, len, dim, n
  if (n <= 8)
    scan_kernel<T, 8><<<grid, kThreads, 0, s>>>(SCAN_ARGS);
  else if (n <= 16)
    scan_kernel<T, 16><<<grid, kThreads, 0, s>>>(SCAN_ARGS);
  else
    scan_kernel<T, 32><<<grid, kThreads, 0, s>>>(SCAN_ARGS);
#undef SCAN_ARGS
  return (int)cudaGetLastError();
}

}  // namespace

// Each launches the kernel and returns cudaGetLastError() (0 = launched).
// The caller guarantees 1 <= batch <= 65535, len, dim >= 1,
// 1 <= n <= 32, and contiguous tensors: u, delta, y (batch, len, dim);
// b, c (batch, len, n) of the entry's dtype; a (dim, n) and skip (dim,)
// fp32.
extern "C" int mamba_scan_f32(const void* u, const void* delta,
                              const void* a, const void* b, const void* c,
                              const void* skip, void* y, int batch, int len,
                              int dim, int n, void* stream) {
  return launch<float>(u, delta, a, b, c, skip, y, batch, len, dim, n,
                       stream);
}

extern "C" int mamba_scan_bf16(const void* u, const void* delta,
                               const void* a, const void* b, const void* c,
                               const void* skip, void* y, int batch, int len,
                               int dim, int n, void* stream) {
  return launch<__nv_bfloat16>(u, delta, a, b, c, skip, y, batch, len, dim,
                               n, stream);
}
