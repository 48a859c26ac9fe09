// Mamba-1 selective scan for Hopper (sm_90a): the forward and its
// backward, plain C launchers bound with ctypes.
//
// Forward.  Replaces the Pallas TPU kernel
// src/repro/kernels/mamba_scan/mamba_scan.py::_scan_kernel
// (mamba_scan_pallas).  Per batch row b and channel d, with N states:
//
//   a_t = exp(delta_t * A[d])                                     (N-vector)
//   h_t = a_t * h_{t-1} + (delta_t * u_t) * B_t
//   y_t = <C_t, h_t> + skip[d] * u_t
//
// Backward.  Replaces no TPU kernel: the JAX package differentiates the
// plain version (src/repro/kernels/mamba_scan/ops.py::_bwd, jax.vjp of
// mamba_scan_ref).  With lambda_t = dLoss/dh_t, swept in reverse,
//
//   lambda_t = g_t * C_t + a_{t+1} * lambda_{t+1}
//   dC_t = sum_d g_t h_t            dB_t = sum_d lambda_t delta_t u_t
//   du_t = sum_n lambda_t delta_t B_t + skip g_t
//   ddelta_t = sum_n lambda_t (A a_t h_{t-1} + u_t B_t)
//   dA = sum_{b,t} lambda_t a_t h_{t-1} delta_t    dskip = sum_{b,t} g_t u_t
//
// u, delta, y, g, du, ddelta (B, L, D) and B, C, dB, dC (B, L, N) in fp32
// or bf16; A, dA (D, N) and skip, dskip (D,) fp32; all contiguous.  Math
// and states in fp32, outputs rounded to nearest even.  1 <= N <= 32; any
// L and D, ragged edges masked, no padding.
//
// The exponential.  fp32 I/O steps the state as the plain version does
// on the card (expf of the rounded product, one rounding per multiply and
// add, no FMA contraction), so the states agree bit for bit and only the
// order of y's N-sum differs.  bf16 I/O, whose y keeps 8 bits, takes one
// special-function ex2.approx of delta * (A log2 e) instead of expf's ~10
// instructions around its one ex2.  (ex2.approx in fp32 would move y by up
// to 1.7x the fp32 check's 1e-5 where <C, h> cancels to near 0.)
//
// Forward design.  The Pallas kernel walks time chunks as a sequential
// grid axis and carries the (block_d, N) state in VMEM.  Here the time
// loop lives inside the block.  A block holds 32 channels of one batch
// row in 8 warps: warp g steps states g * N/8 .. (g + 1) * N/8 - 1 of all
// 32 channels (2 each at N = 16), so the B_t and C_t a warp reads are the
// same for all its lanes (one broadcast), and y's sum over the 8 groups
// goes through shared memory once per chunk.  At falcon-mamba-7b's
// training shape (B = 4, L = 512, D = 8192, N = 16) that is 1024 blocks
// of 256 threads, 4 per SM at 64 registers.  Each chunk of 32 steps is
// staged in shared memory (u and delta coalesced across channels, B and
// C once for the row, zero past L) and stepped fully unrolled.  The grid
// is flat over (batch row, channel block), so B is not held to 65535.
// Measured on the card (chip_smoke.py): a channel's states spread over
// lanes of one warp, with shuffles for y, ran 0.27 ms bf16 (its lanes read
// different B and C rows and shuffled every step); warp-uniform groups
// 0.16 ms; the next chunk's loads in flight in registers or by cp.async
// did not move it.  When a backward will follow, the forward also writes
// the state entering each chunk, (B, ceil(L / 32), D, N) fp32 (33.6 MB at
// the training shape, ~0.02 ms of writes).
//
// Backward design.  The sweep needs h_{t-1} in reverse order, and
// h_{t-1} = (h_t - delta u B) / a_t is useless where a_t underflows.  So
// for each chunk, last first, a block loads the chunk's entering state,
// steps the chunk's 32 steps forward again (keeping h_{t-1} and a_t in
// registers, with the forward's arithmetic, so the states are the
// forward's bit for bit), then sweeps it backward.  Taking the saved
// states costs 33.6 MB of writes in the forward and reads here; a
// backward that found them itself would repeat the whole forward first.
// One thread holds one state (b, d, n): a block is 512 threads, 512 / N'
// channels (N' = N rounded up to 8, 16 or 32).  du and ddelta sum over n:
// shuffles across the channel's lanes.  dB and dC sum over d: shuffles
// across the warp's channels, then the block's warps in order in shared
// memory, one partial per (block, t, n) to device memory; dA and dskip
// sum over t in the thread and leave one partial per batch row.  A second
// launch adds the partials in a fixed order (blocks, then batch rows) and
// rounds dB and dC to their dtype: the gradients are the same from run to
// run, with no atomics.  Its 10 shuffles per state per step are its
// largest cost (see PERF.md).
//
// What bounds them: operations.  At the training shape the forward
// moves 100.7 MB (u, delta, y; B, C, A and skip are small), 0.030 ms at
// 3.35 TB/s, and takes 268 M exponentials, one special-function (ex2)
// result each at 16 per clock per SM (4.18 T/s at 132 SMs and 1.98 GHz):
// 0.064 ms.  The backward takes the same 268 M exponentials and ~5.2
// GFLOP of fp32 multiplies and adds (19 per state per step, 8 per channel
// per step), 0.078 ms at 67 TFLOP/s, against 0.06 ms of bf16 bytes (u,
// delta, g, du, ddelta, B, C, dB, dC and the saved states).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;       // steps per staged chunk = state interval
constexpr int kGroups = 8;       // forward: state groups (warps) per block
constexpr int kChannels = 32;    // forward: channels per block
constexpr int kBwdThreads = 512;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// bf16 I/O takes the special-function exponential; see the note above.
template <typename T>
struct Exp {
  static constexpr bool kFast = sizeof(T) == 2;
  // what a thread keeps of A[d, n]
  __device__ static float coef(float a) { return kFast ? a * kLog2e : a; }
  // a_t = exp(delta_t * A[d, n])
  __device__ static float decay(float dt, float coef) {
    if (kFast) {
      float r;
      asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(dt * coef));
      return r;
    }
    return expf(__fmul_rn(dt, coef));
  }
};

// h_t = a_t * h_{t-1} + (delta_t * u_t) * B_t, rounded as the plain version
__device__ __forceinline__ float step(float a, float h, float du, float b) {
  return __fadd_rn(__fmul_rn(a, h), __fmul_rn(du, b));
}

// kM floats of shared memory, 8 bytes for two, else 16 at a time
template <int kM>
__device__ __forceinline__ void load_row(const float* p, float* out) {
  if constexpr (kM == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    static_assert(kM % 4 == 0, "rows of 2 or a multiple of 4 floats");
#pragma unroll
    for (int s = 0; s < kM; s += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + s);
      out[s] = v.x;
      out[s + 1] = v.y;
      out[s + 2] = v.z;
      out[s + 3] = v.w;
    }
  }
}

// One thread per (channel, group of kN / kGroups states): a warp holds 32
// channels of one group, so the B and C it reads are the same for all its
// lanes, and y's sum over the groups goes through shared memory.  kN: N
// rounded up to 8, 16 or 32; the states past N stay 0 (their A, B and C
// are staged as 0, so exp(0) * 0 + du * 0 = 0 and they add 0).
template <typename T, int kN>
__global__ void __launch_bounds__(kChannels * kGroups,
                                  1024 / (kChannels * kGroups))
    scan_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ skip,
                T* __restrict__ y, float* __restrict__ states, int len,
                int dim, int n, int d_blocks) {
  constexpr int kS = kN / kGroups;              // states per thread
  constexpr int kThreads = kChannels * kGroups;
  constexpr int kUD = kChunk / kGroups;         // steps a thread stages
  constexpr int kBC = (kChunk * kN + kThreads - 1) / kThreads;
  __shared__ float s_u[kChunk][kChannels];
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_y[kGroups][kChunk][kChannels];  // each group's <C, h>
  // B and C side by side for each group: [t][group][B's kS, C's kS]
  __shared__ __align__(16) float s_bc[kChunk][kGroups][2 * kS];

  const int tid = threadIdx.x;
  const int row = blockIdx.x / d_blocks;                 // batch row
  const int d0 = (blockIdx.x - row * d_blocks) * kChannels;
  const int ch = tid % kChannels, grp = tid / kChannels, n0 = grp * kS;
  const int d = d0 + ch;
  const bool live = d < dim;
  const size_t row0 = (size_t)row * len;                 // row (b, t = 0)
  const int n_chunks = (len + kChunk - 1) / kChunk;

  float coef[kS], h[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    coef[s] = Exp<T>::coef(live && n0 + s < n ? a[(size_t)d * n + n0 + s]
                                              : 0.f);
    h[s] = 0.f;
  }
  const float dskip = live ? skip[d] : 0.f;

  for (int k = 0; k < n_chunks; ++k) {
    const int t0 = k * kChunk;
    // stage the chunk's u and delta (steps grp, grp + kGroups, ... of
    // this thread's channel) and B and C, zero past L
#pragma unroll
    for (int i = 0; i < kUD; ++i) {
      const int tt = grp + i * kGroups;
      const bool ok = t0 + tt < len && live;
      const size_t off = (row0 + t0 + tt) * dim + d;
      s_u[tt][ch] = ok ? to_f(u[off]) : 0.f;
      s_dt[tt][ch] = ok ? to_f(delta[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      const int tt = e / kN, kn = e % kN;
      const bool ok = t0 + tt < len && kn < n;
      const size_t off = (row0 + t0 + tt) * n + kn;
      if (e < kChunk * kN) {
        s_bc[tt][kn / kS][kn % kS] = ok ? to_f(bm[off]) : 0.f;
        s_bc[tt][kn / kS][kS + kn % kS] = ok ? to_f(cm[off]) : 0.f;
      }
    }
    if (states != nullptr && live) {
      float* sp = states + (((size_t)row * n_chunks + k) * dim + d) * n;
#pragma unroll
      for (int s = 0; s < kS; ++s)
        if (n0 + s < n) sp[n0 + s] = h[s];
    }
    __syncthreads();
    // every step of the chunk: past L, delta = 0 leaves h as it is
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const float dt = s_dt[tt][ch];
      const float du = __fmul_rn(dt, s_u[tt][ch]);
      float bc[2 * kS];
      load_row<2 * kS>(&s_bc[tt][grp][0], bc);
      float acc = 0.f;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        h[s] = step(Exp<T>::decay(dt, coef[s]), h[s], du, bc[s]);
        acc = fmaf(h[s], bc[kS + s], acc);
      }
      s_y[grp][tt][ch] = acc;
    }
    __syncthreads();  // s_y complete
#pragma unroll
    for (int i = 0; i < kUD; ++i) {
      const int tt = grp + i * kGroups;
      float acc = 0.f;
#pragma unroll
      for (int g = 0; g < kGroups; ++g) acc += s_y[g][tt][ch];
      if (t0 + tt < len && live)
        store(y + (row0 + t0 + tt) * dim + d,
              __fadd_rn(acc, __fmul_rn(dskip, s_u[tt][ch])));
    }
    __syncthreads();  // s_u, s_dt, s_bc free
  }
}

template <int kN>
__host__ __device__ constexpr int bwd_channels() { return kBwdThreads / kN; }

int bwd_channels(int n) {
  return kBwdThreads / (n <= 8 ? 8 : (n <= 16 ? 16 : 32));
}

// One thread per state (b, d, n < kN); kBwdThreads / kN channels of one
// batch row per block.  Dynamic shared memory: the warps' dB and dC sums,
// [warp][t][2][kN] floats.
template <typename T, int kN>
__global__ void __launch_bounds__(kBwdThreads, 1)
    scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ skip,
                    const T* __restrict__ g,
                    const float* __restrict__ states, T* __restrict__ du_out,
                    T* __restrict__ dd_out, float* __restrict__ part_bc,
                    float* __restrict__ part_a,
                    float* __restrict__ part_skip, int len, int dim, int n,
                    int d_blocks) {
  constexpr int kCh = bwd_channels<kN>();
  constexpr int kWarps = kBwdThreads / 32;
  constexpr int kUD = kChunk * kCh / kBwdThreads;  // per thread, chunk
  constexpr int kBC = (kChunk * kN + kBwdThreads - 1) / kBwdThreads;
  __shared__ float s_u[kChunk][kCh];
  __shared__ float s_dt[kChunk][kCh];
  __shared__ float s_g[kChunk][kCh];
  __shared__ float s_du[kChunk][kCh];
  __shared__ float s_dd[kChunk][kCh];
  __shared__ float s_b[kChunk][kN];
  __shared__ float s_c[kChunk][kN];
  extern __shared__ float s_part[];               // [kWarps][kChunk][2][kN]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int row = blockIdx.x / d_blocks;
  const int blk = blockIdx.x - row * d_blocks;
  const int d0 = blk * kCh;
  const int ch = tid / kN, k = tid % kN;
  const int d = d0 + ch;
  const bool live = d < dim && k < n;
  const size_t row0 = (size_t)row * len;
  const int n_chunks = (len + kChunk - 1) / kChunk;

  const float av = live ? a[(size_t)d * n + k] : 0.f;
  const float coef = Exp<T>::coef(av);
  const float skv = d < dim ? skip[d] : 0.f;

  float ru[kUD], rd[kUD], rg[kUD], rb[kBC], rc[kBC], rs;
  auto fetch = [&](int kk) {
    const int t0 = kk * kChunk;
#pragma unroll
    for (int i = 0; i < kUD; ++i) {
      const int e = tid + i * kBwdThreads;
      const int t = t0 + e / kCh, dd = d0 + e % kCh;
      const bool ok = t < len && dd < dim;
      const size_t off = (row0 + t) * dim + dd;
      ru[i] = ok ? to_f(u[off]) : 0.f;
      rd[i] = ok ? to_f(delta[off]) : 0.f;
      rg[i] = ok ? to_f(g[off]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kBwdThreads;
      const int t = t0 + e / kN, kn = e % kN;
      const bool ok = e < kChunk * kN && t < len && kn < n;
      const size_t off = (row0 + t) * n + kn;
      rb[i] = ok ? to_f(bm[off]) : 0.f;
      rc[i] = ok ? to_f(cm[off]) : 0.f;
    }
    rs = live ? states[(((size_t)row * n_chunks + kk) * dim + d) * n + k]
              : 0.f;
  };
  auto commit = [&]() {
#pragma unroll
    for (int i = 0; i < kUD; ++i) {
      const int e = tid + i * kBwdThreads;
      s_u[e / kCh][e % kCh] = ru[i];
      s_dt[e / kCh][e % kCh] = rd[i];
      s_g[e / kCh][e % kCh] = rg[i];
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kBwdThreads;
      if (e < kChunk * kN) {
        s_b[e / kN][e % kN] = rb[i];
        s_c[e / kN][e % kN] = rc[i];
      }
    }
  };

  float lam = 0.f, a_next = 1.f, da = 0.f, dskip = 0.f;
  float h_prev[kChunk], decay[kChunk];
  fetch(n_chunks - 1);
  commit();
  __syncthreads();
  for (int kk = n_chunks - 1; kk >= 0; --kk) {
    const int t0 = kk * kChunk;
    float h = rs;
    if (kk > 0) fetch(kk - 1);
    // the chunk forward again, from its entering state (zero past L)
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const float dt = s_dt[tt][ch];
      decay[tt] = Exp<T>::decay(dt, coef);
      h_prev[tt] = h;
      h = step(decay[tt], h, __fmul_rn(dt, s_u[tt][ch]), s_b[tt][k]);
    }
    // and backward; h is h_t
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      const float dt = s_dt[tt][ch], uv = s_u[tt][ch], gv = s_g[tt][ch];
      const float bv = s_b[tt][k];
      lam = fmaf(a_next, lam, gv * s_c[tt][k]);
      const float q = lam * decay[tt] * h_prev[tt];
      da = fmaf(q, dt, da);
      float r1 = lam * bv, r2 = av * q;
      float pb = lam * (dt * uv), pc = gv * h;
#pragma unroll
      for (int off = kN / 2; off > 0; off /= 2) {   // over the states
        r1 += __shfl_xor_sync(0xffffffffu, r1, off);
        r2 += __shfl_xor_sync(0xffffffffu, r2, off);
      }
#pragma unroll
      for (int off = kN; off < 32; off *= 2) {      // over the channels
        pb += __shfl_xor_sync(0xffffffffu, pb, off);
        pc += __shfl_xor_sync(0xffffffffu, pc, off);
      }
      if (lane < kN) {
        float* sp = s_part + ((warp * kChunk + tt) * 2) * kN + lane;
        sp[0] = pb;
        sp[kN] = pc;
      }
      if (k == 0) {
        s_du[tt][ch] = fmaf(dt, r1, skv * gv);
        s_dd[tt][ch] = fmaf(uv, r1, r2);
      }
      dskip = fmaf(gv, uv, dskip);
      a_next = decay[tt];
      h = h_prev[tt];
    }
    __syncthreads();  // s_du, s_dd, s_part complete; s_u .. s_c free
#pragma unroll
    for (int i = 0; i < kUD; ++i) {
      const int e = tid + i * kBwdThreads;
      const int tt = e / kCh, dd = d0 + e % kCh;
      if (t0 + tt < len && dd < dim) {
        const size_t off = (row0 + t0 + tt) * dim + dd;
        store(du_out + off, s_du[tt][e % kCh]);
        store(dd_out + off, s_dd[tt][e % kCh]);
      }
    }
    for (int e = tid; e < kChunk * 2 * kN; e += kBwdThreads) {
      const int tt = e / (2 * kN), qk = e % (2 * kN);
      const int q = qk / kN, kn = qk % kN;
      if (t0 + tt < len && kn < n) {
        float sum = 0.f;
        for (int w = 0; w < kWarps; ++w)
          sum += s_part[(w * kChunk + tt) * 2 * kN + qk];
        part_bc[(((size_t)row * d_blocks + blk) * len + t0 + tt) * 2 * n +
                q * n + kn] = sum;
      }
    }
    if (kk > 0) commit();
    __syncthreads();
  }
  if (live) part_a[((size_t)row * dim + d) * n + k] = da;
  if (k == 0 && d < dim) part_skip[(size_t)row * dim + d] = dskip;
}

// dB, dC: the blocks' partials added in block order, rounded to T; dA,
// dskip: the batch rows' partials added in row order.
template <typename T>
__global__ void scan_bwd_reduce_kernel(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    const float* __restrict__ part_skip, T* __restrict__ db,
    T* __restrict__ dc, float* __restrict__ da, float* __restrict__ dskip,
    int batch, int len, int dim, int n, int d_blocks) {
  size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t n_bc = (size_t)batch * len * 2 * n;
  if (i < n_bc) {                        // i = ((b * len + t) * 2 + q) * n + k
    const size_t per_row = (size_t)len * 2 * n;
    const size_t b = i / per_row, r = i - b * per_row;
    const float* p = part_bc + b * d_blocks * per_row + r;
    float sum = 0.f;
    for (int blk = 0; blk < d_blocks; ++blk) sum += p[blk * per_row];
    const size_t t = r / (2 * n), q = (r / n) % 2, k = r % n;
    store((q == 0 ? db : dc) + (b * len + t) * n + k, sum);
    return;
  }
  i -= n_bc;
  const size_t n_a = (size_t)dim * n;
  if (i < n_a) {                         // i = d * n + k
    float sum = 0.f;
    for (int b = 0; b < batch; ++b) sum += part_a[b * n_a + i];
    da[i] = sum;
  } else if (i < n_a + dim) {            // i = n_a + d
    float sum = 0.f;
    for (int b = 0; b < batch; ++b)
      sum += part_skip[b * (size_t)dim + i - n_a];
    dskip[i - n_a] = sum;
  }
}

bool shape_ok(int batch, int len, int dim, int n) {
  return batch > 0 && len > 0 && dim > 0 && n >= 1 && n <= 32;
}

template <typename T>
int launch(const void* u, const void* delta, const void* a, const void* b,
           const void* c, const void* skip, void* y, void* states,
           int batch, int len, int dim, int n, void* stream) {
  if (!shape_ok(batch, len, dim, n)) return (int)cudaErrorInvalidValue;
  const int d_blocks = (dim + kChannels - 1) / kChannels;
  if ((long long)batch * d_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SCAN_ARGS                                                       \
  (const T*)u, (const T*)delta, (const float*)a, (const T*)b,          \
      (const T*)c, (const float*)skip, (T*)y, (float*)states, len, dim, \
      n, d_blocks
  const unsigned grid = (unsigned)(batch * d_blocks);
  constexpr int kThreads = kChannels * kGroups;
  if (n <= 8)
    scan_kernel<T, 8><<<grid, kThreads, 0, s>>>(SCAN_ARGS);
  else if (n <= 16)
    scan_kernel<T, 16><<<grid, kThreads, 0, s>>>(SCAN_ARGS);
  else
    scan_kernel<T, 32><<<grid, kThreads, 0, s>>>(SCAN_ARGS);
#undef SCAN_ARGS
  return (int)cudaGetLastError();
}

template <typename T, int kN>
int launch_bwd_n(const void* u, const void* delta, const void* a,
                 const void* b, const void* c, const void* skip,
                 const void* g, const void* states, void* du, void* ddelta,
                 float* part_bc, float* part_a, float* part_skip, int batch,
                 int len, int dim, int n, int d_blocks, cudaStream_t s) {
  const int smem = (kBwdThreads / 32) * kChunk * 2 * kN * (int)sizeof(float);
  const cudaError_t rc = cudaFuncSetAttribute(
      scan_bwd_kernel<T, kN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (rc != cudaSuccess) return (int)rc;
  scan_bwd_kernel<T, kN><<<(unsigned)(batch * d_blocks), kBwdThreads, smem,
                           s>>>(
      (const T*)u, (const T*)delta, (const float*)a, (const T*)b,
      (const T*)c, (const float*)skip, (const T*)g, (const float*)states,
      (T*)du, (T*)ddelta, part_bc, part_a, part_skip, len, dim, n, d_blocks);
  return (int)cudaGetLastError();
}

long long bwd_workspace(int batch, int len, int dim, int n) {
  const long long d_blocks = (dim + bwd_channels(n) - 1) / bwd_channels(n);
  return (long long)batch * (d_blocks * len * 2 * n + (long long)dim * n +
                             dim);
}

template <typename T>
int launch_bwd(const void* u, const void* delta, const void* a,
               const void* b, const void* c, const void* skip,
               const void* g, const void* states, void* du, void* ddelta,
               void* da, void* db, void* dc, void* dskip, void* workspace,
               int batch, int len, int dim, int n, void* stream) {
  if (!shape_ok(batch, len, dim, n)) return (int)cudaErrorInvalidValue;
  const int d_blocks = (dim + bwd_channels(n) - 1) / bwd_channels(n);
  if ((long long)batch * d_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* part_bc = (float*)workspace;
  float* part_a = part_bc + (size_t)batch * d_blocks * len * 2 * n;
  float* part_skip = part_a + (size_t)batch * dim * n;
  const cudaStream_t s = (cudaStream_t)stream;
#define BWD_ARGS                                                          \
  u, delta, a, b, c, skip, g, states, du, ddelta, part_bc, part_a,       \
      part_skip, batch, len, dim, n, d_blocks, s
  int rc;
  if (n <= 8)
    rc = launch_bwd_n<T, 8>(BWD_ARGS);
  else if (n <= 16)
    rc = launch_bwd_n<T, 16>(BWD_ARGS);
  else
    rc = launch_bwd_n<T, 32>(BWD_ARGS);
#undef BWD_ARGS
  if (rc != 0) return rc;
  const long long total = (long long)batch * len * 2 * n +
                          (long long)dim * n + dim;
  const int threads = 256;
  scan_bwd_reduce_kernel<T><<<(unsigned)((total + threads - 1) / threads),
                              threads, 0, s>>>(
      part_bc, part_a, part_skip, (T*)db, (T*)dc, (float*)da, (float*)dskip,
      batch, len, dim, n, d_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The forward launches one kernel, the backward two (the sweep, then the
// sum of its partials); each returns cudaGetLastError() after its last
// launch (0 = launched).  The caller guarantees batch, len, dim >= 1,
// 1 <= n <= 32 and contiguous tensors: u, delta, y, g, du, ddelta
// (batch, len, dim) and b, c, db, dc (batch, len, n) of the entry's dtype;
// a, da (dim, n), skip, dskip (dim,) fp32; states (batch, ceil(len / 32),
// dim, n) fp32, which the forward writes unless it is null and the
// backward reads; workspace mamba_scan_bwd_workspace(...) floats.
extern "C" int mamba_scan_f32(const void* u, const void* delta,
                              const void* a, const void* b, const void* c,
                              const void* skip, void* y, void* states,
                              int batch, int len, int dim, int n,
                              void* stream) {
  return launch<float>(u, delta, a, b, c, skip, y, states, batch, len, dim,
                       n, stream);
}

extern "C" int mamba_scan_bf16(const void* u, const void* delta,
                               const void* a, const void* b, const void* c,
                               const void* skip, void* y, void* states,
                               int batch, int len, int dim, int n,
                               void* stream) {
  return launch<__nv_bfloat16>(u, delta, a, b, c, skip, y, states, batch,
                               len, dim, n, stream);
}

extern "C" long long mamba_scan_bwd_workspace(int batch, int len, int dim,
                                              int n) {
  return bwd_workspace(batch, len, dim, n);
}

extern "C" int mamba_scan_bwd_f32(const void* u, const void* delta,
                                  const void* a, const void* b,
                                  const void* c, const void* skip,
                                  const void* g, const void* states,
                                  void* du, void* ddelta, void* da, void* db,
                                  void* dc, void* dskip, void* workspace,
                                  int batch, int len, int dim, int n,
                                  void* stream) {
  return launch_bwd<float>(u, delta, a, b, c, skip, g, states, du, ddelta,
                           da, db, dc, dskip, workspace, batch, len, dim, n,
                           stream);
}

extern "C" int mamba_scan_bwd_bf16(const void* u, const void* delta,
                                   const void* a, const void* b,
                                   const void* c, const void* skip,
                                   const void* g, const void* states,
                                   void* du, void* ddelta, void* da,
                                   void* db, void* dc, void* dskip,
                                   void* workspace, int batch, int len,
                                   int dim, int n, void* stream) {
  return launch_bwd<__nv_bfloat16>(u, delta, a, b, c, skip, g, states, du,
                                   ddelta, da, db, dc, dskip, workspace,
                                   batch, len, dim, n, stream);
}
