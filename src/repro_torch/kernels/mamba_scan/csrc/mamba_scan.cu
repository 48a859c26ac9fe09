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
// the training shape, ~0.02 ms of writes).  For serving (the prefill that
// hands its recurrent state to decode) it writes instead, or as well, the
// state after the last step, (B, D, N) fp32, once per (b, d, n): 8 MB at
// falcon-mamba-7b's D = 8192, N = 16 and B = 1.
//
// Backward design.  The sweep needs h_{t-1} in reverse order, and
// h_{t-1} = (h_t - delta u B) / a_t is useless where a_t underflows.  So
// for each chunk, last first, a block loads the chunk's entering state,
// steps the chunk forward again with the forward's arithmetic (so the
// states are the forward's bit for bit), then sweeps it backward.  Taking
// the saved states costs 33.6 MB of writes in the forward and reads here;
// a backward that found them itself would repeat the whole forward first.
// The threads lie as in the forward: a block holds 32 channels of one batch
// row in 8 warps, warp g the states g * N/8 .. (g + 1) * N/8 - 1 of all 32
// channels, so B_t and C_t are the same for all lanes of a warp.  du and
// ddelta sum over n: adds in the thread, then the 8 groups in order
// through shared memory every 16 steps.  dB and dC sum over d: every few
// steps the warp sums 16 values of each lane over its 32 lanes by halving
// exchanges (16 shuffles for 16 sums, warp_sum16), one partial per (block,
// t, n) to device memory.  A thread keeps h_{t-1} and a_t of 16 / (N/8)
// steps in registers, so that 2 blocks fit an SM: each chunk is stepped
// again in such sub-chunks, last first, from the states a first pass over
// the chunk kept (1.75 exponentials per state per step at N = 16).  While
// a chunk is swept, the next one's u, delta, g and states copy into shared
// memory by cp.async, and its B and C load into registers.  dA and dskip
// sum over t in the thread and leave one partial per batch row.  A second
// launch adds the partials in a fixed order (blocks, then batch rows) and
// rounds dB and dC to their dtype: the gradients are the same from run to
// run, with no atomics.  What holds the sweep (PERF.md): instruction
// issue, at the cap of 128 registers that 2 blocks per SM allow.
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
constexpr int kGroups = 8;       // state groups (warps) per block
constexpr int kChannels = 32;    // channels per block
constexpr int kMaxDevices = 64;
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
                T* __restrict__ y, float* __restrict__ states,
                float* __restrict__ h_last, int len, int dim, int n,
                int d_blocks) {
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
  // past L every step kept h as it was: h is the state after step L - 1
  if (h_last != nullptr && live) {
    float* hp = h_last + ((size_t)row * dim + d) * n;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (n0 + s < n) hp[n0 + s] = h[s];
  }
}

// Backward geometry: a block holds kChannels channels of one batch row in
// kGroups warps, as the forward does; warp g holds states g * kS .. (g +
// 1) * kS - 1 of all 32 channels.  A thread keeps h_{t-1} and a_t of kSub
// steps in registers (2 * kSub * kS = 32 floats), so a chunk is stepped
// again in kSubs sub-chunks, last first, each from a state that a first
// pass over the chunk kept.  dB and dC are summed over the warp's channels
// every kPeriod steps, 16 values (2 kS per step) at a time; du and ddelta
// over the groups every kSpan steps.
template <int kN>
struct Bwd {
  static constexpr int kS = kN / kGroups;
  static constexpr int kSub = 16 / kS;
  static constexpr int kSubs = kChunk / kSub;
  static constexpr int kPeriod = 8 / kS;
  static constexpr int kSpan = kS == 4 ? 8 : 16;
  static_assert(2 * kS * kPeriod == 16 && kSub % kPeriod == 0 &&
                    kSpan % kSub == 0 && kSpan % kGroups == 0,
                "geometry");
};

// Sums each of v[0..15] over the warp's 32 lanes.  Each stage sends half
// of a lane's values to the lane kOff away and keeps the sums of the other
// half, so lane l ends with the sum of v[l / 2] (lanes 2i and 2i + 1 hold
// the same bits): 16 shuffles for 16 sums, the adds in a fixed order.
template <int kCount, int kOff>
__device__ __forceinline__ void warp_sum16(float (&v)[16], int lane) {
  if constexpr (kOff > 0) {
    if constexpr (kCount > 1) {
      constexpr int kHalf = kCount / 2;
      const bool up = (lane & kOff) != 0;
#pragma unroll
      for (int i = 0; i < kHalf; ++i) {
        const float send = up ? v[i] : v[i + kHalf];
        const float keep = up ? v[i + kHalf] : v[i];
        v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
      }
      warp_sum16<kHalf, kOff / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], kOff);
      warp_sum16<1, kOff / 2>(v, lane);
    }
  }
}

// 16-byte (or 4-byte) copy from device to shared memory, not waited on
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// Dynamic shared memory of the backward: the next chunk's u, delta and g
// as they lie in device memory, and its entering states.
template <typename T, int kN>
struct BwdRaw {
  T u[kChunk][kChannels], dt[kChunk][kChannels], g[kChunk][kChannels];
  float st[kGroups * kChannels][kN / kGroups];
};

// One thread per (channel, group of kS states), as in the forward.  Per
// chunk, last first: keep the state entering each sub-chunk, then per
// sub-chunk, last first, step it again (keeping h_{t-1} and a_t) and sweep
// it in reverse.  Meanwhile the next chunk's u, delta, g and states copy
// into shared memory by cp.async (kAsync: rows of 16-byte pieces; else
// plain loads once the chunk is done) and its B and C load into registers.
// du and ddelta sum over n: in the thread, then over the groups through
// shared memory every kSpan steps.  dB and dC sum over d: warp_sum16 over
// the lanes, one partial per (block, t, n) to device memory.  dA and dskip
// sum over t in the thread and leave one partial per batch row.
template <typename T, int kN, bool kAsync>
__global__ void __launch_bounds__(kChannels * kGroups, 2)
    scan_bwd_kernel(const T* __restrict__ u, const T* __restrict__ delta,
                    const float* __restrict__ a, const T* __restrict__ bm,
                    const T* __restrict__ cm, const float* __restrict__ skip,
                    const T* __restrict__ g,
                    const float* __restrict__ states, T* __restrict__ du_out,
                    T* __restrict__ dd_out, float* __restrict__ part_bc,
                    float* __restrict__ part_a,
                    float* __restrict__ part_skip, int len, int dim, int n,
                    int d_blocks) {
  using G = Bwd<kN>;
  constexpr int kS = G::kS, kSub = G::kSub, kSubs = G::kSubs;
  constexpr int kP = G::kPeriod, kSpan = G::kSpan;
  constexpr int kThreads = kChannels * kGroups;
  constexpr int kUD = kChunk / kGroups;
  constexpr int kBC = (kChunk * kN + kThreads - 1) / kThreads;
  constexpr int kPiece = 16 / sizeof(T);           // elements per piece
  constexpr int kPieces = kChunk * kChannels / kPiece;
  __shared__ float s_u[kChunk][kChannels];
  __shared__ float s_dt[kChunk][kChannels];
  __shared__ float s_g[kChunk][kChannels];
  __shared__ __align__(16) float s_bc[kChunk][kGroups][2 * kS];
  // each group's sums over its states of lambda B and A q, per step
  __shared__ float s_r[2][kGroups][kSpan][kChannels];
  extern __shared__ __align__(16) char s_dyn[];
  BwdRaw<T, kN>& raw = *reinterpret_cast<BwdRaw<T, kN>*>(s_dyn);

  const int tid = threadIdx.x;
  const int lane = tid % kChannels, grp = tid / kChannels, n0 = grp * kS;
  const int row = blockIdx.x / d_blocks;
  const int blk = blockIdx.x - row * d_blocks;
  const int d0 = blk * kChannels, d = d0 + lane;
  const bool live = d < dim;
  const size_t row0 = (size_t)row * len;
  const int n_chunks = (len + kChunk - 1) / kChunk;
  // after warp_sum16, lane l holds element l / 2 of a period's terms:
  // step ws_j of the period, B or C (ws_q), state n0 + ws_s; even lanes
  // store it
  const int ws_e = lane >> 1, ws_s = ws_e % kS;
  const int ws_j = ws_e / (2 * kS), ws_q = ws_e / kS % 2;
  const bool ws_on = (lane & 1) == 0 && n0 + ws_s < n;
  float* part = part_bc + ((size_t)row * d_blocks + blk) * len * 2 * n +
                (size_t)ws_j * 2 * n + ws_q * n + n0 + ws_s;

  float av[kS], coef[kS], lam[kS], a_next[kS], da[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    av[s] = live && n0 + s < n ? a[(size_t)d * n + n0 + s] : 0.f;
    coef[s] = Exp<T>::coef(av[s]);
    lam[s] = da[s] = 0.f;
    a_next[s] = 1.f;
  }
  const float skv = live ? skip[d] : 0.f;
  float dskip = 0.f;

  // a chunk's u, delta, g and states: copied into raw (kAsync), else loaded
  // and stored to shared memory directly; then (stage) zero past L and D
  auto copy = [&](int kk) {
    const int t0 = kk * kChunk;
    for (int i = tid; i < kPieces; i += kThreads) {
      const int tt = i / (kChannels / kPiece);
      const int c0 = i % (kChannels / kPiece) * kPiece;
      if (t0 + tt < len && d0 + c0 < dim) {
        const size_t off = (row0 + t0 + tt) * dim + d0 + c0;
        cp_async16(&raw.u[tt][c0], u + off);
        cp_async16(&raw.dt[tt][c0], delta + off);
        cp_async16(&raw.g[tt][c0], g + off);
      }
    }
    const float* sp = states + (((size_t)row * n_chunks + kk) * dim + d) * n;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      if (live && n0 + s < n) cp_async4(&raw.st[tid][s], sp + n0 + s);
  };
  float rs[kS];  // the chunk's entering states
  auto stage = [&](int kk) {
    const int t0 = kk * kChunk;
#pragma unroll
    for (int i = 0; i < kUD; ++i) {
      const int tt = grp + i * kGroups;
      const bool ok = t0 + tt < len && live;
      const size_t off = (row0 + t0 + tt) * dim + d;
      s_u[tt][lane] = !ok ? 0.f : to_f(kAsync ? raw.u[tt][lane] : u[off]);
      s_dt[tt][lane] = !ok ? 0.f
                           : to_f(kAsync ? raw.dt[tt][lane] : delta[off]);
      s_g[tt][lane] = !ok ? 0.f : to_f(kAsync ? raw.g[tt][lane] : g[off]);
    }
    const float* sp = states + (((size_t)row * n_chunks + kk) * dim + d) * n;
#pragma unroll
    for (int s = 0; s < kS; ++s)
      rs[s] = !(live && n0 + s < n) ? 0.f
                                    : (kAsync ? raw.st[tid][s] : sp[n0 + s]);
  };
  // B and C, zero past L and N: into registers, then to shared memory
  float rb[kBC], rc[kBC];
  auto fetch_bc = [&](int kk) {
    const int t0 = kk * kChunk;
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      const int tt = e / kN, kn = e % kN;
      const bool ok = e < kChunk * kN && t0 + tt < len && kn < n;
      const size_t off = (row0 + t0 + tt) * n + kn;
      rb[i] = ok ? to_f(bm[off]) : 0.f;
      rc[i] = ok ? to_f(cm[off]) : 0.f;
    }
  };
  auto commit_bc = [&]() {
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * kThreads;
      const int tt = e / kN, kn = e % kN;
      if (e < kChunk * kN) {
        s_bc[tt][kn / kS][kn % kS] = rb[i];
        s_bc[tt][kn / kS][kS + kn % kS] = rc[i];
      }
    }
  };

  if (kAsync) {
    copy(n_chunks - 1);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  stage(n_chunks - 1);
  fetch_bc(n_chunks - 1);
  commit_bc();
  for (int kk = n_chunks - 1; kk >= 0; --kk) {
    const int t0 = kk * kChunk;
    float ck[kSubs][kS];  // the state entering each sub-chunk
#pragma unroll
    for (int s = 0; s < kS; ++s) ck[0][s] = rs[s];
    __syncthreads();      // the chunk is staged, raw is free
    if (kk > 0) {
      if (kAsync) copy(kk - 1);
      fetch_bc(kk - 1);
    }
#pragma unroll
    for (int sc = 1; sc < kSubs; ++sc) {
#pragma unroll
      for (int s = 0; s < kS; ++s) ck[sc][s] = ck[sc - 1][s];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = (sc - 1) * kSub + j;
        const float dt = s_dt[tt][lane];
        const float du = __fmul_rn(dt, s_u[tt][lane]);
        float bc[2 * kS];
        load_row<2 * kS>(&s_bc[tt][grp][0], bc);
#pragma unroll
        for (int s = 0; s < kS; ++s)
          ck[sc][s] = step(Exp<T>::decay(dt, coef[s]), ck[sc][s], du, bc[s]);
      }
    }
#pragma unroll
    for (int sc = kSubs - 1; sc >= 0; --sc) {
      const int s0 = sc * kSub;
      // the sub-chunk forward again (zero past L), then backward; h is h_t
      float hp[kSub][kS], dec[kSub][kS], h[kS];
#pragma unroll
      for (int s = 0; s < kS; ++s) h[s] = ck[sc][s];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float dt = s_dt[s0 + j][lane];
        const float du = __fmul_rn(dt, s_u[s0 + j][lane]);
        float bc[2 * kS];
        load_row<2 * kS>(&s_bc[s0 + j][grp][0], bc);
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          dec[j][s] = Exp<T>::decay(dt, coef[s]);
          hp[j][s] = h[s];
          h[s] = step(dec[j][s], h[s], du, bc[s]);
        }
      }
      float v[16];  // dB and dC terms of one period: [step][B or C][state]
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        const int tt = s0 + j, p = j % kP;
        const float dt = s_dt[tt][lane], uv = s_u[tt][lane];
        const float gv = s_g[tt][lane], dtu = dt * uv;
        float bc[2 * kS];
        load_row<2 * kS>(&s_bc[tt][grp][0], bc);
        float r1 = 0.f, r2 = 0.f;
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          lam[s] = fmaf(a_next[s], lam[s], gv * bc[kS + s]);
          const float q = lam[s] * dec[j][s] * hp[j][s];
          da[s] = fmaf(q, dt, da[s]);
          r1 = fmaf(lam[s], bc[s], r1);
          r2 = fmaf(av[s], q, r2);
          v[2 * p * kS + s] = lam[s] * dtu;
          v[(2 * p + 1) * kS + s] = gv * h[s];
          a_next[s] = dec[j][s];
          h[s] = hp[j][s];
        }
        s_r[0][grp][tt % kSpan][lane] = r1;
        s_r[1][grp][tt % kSpan][lane] = r2;
        dskip = fmaf(gv, uv, dskip);  // every group: no branch
        if (p == 0) {  // steps tt .. tt + kP - 1 are in v
          warp_sum16<16, 16>(v, lane);
          if (ws_on && t0 + tt + ws_j < len)
            part[(size_t)(t0 + tt) * 2 * n] = v[0];
        }
      }
      if (s0 % kSpan == 0) {  // du and ddelta of steps s0 .. s0 + kSpan - 1
        __syncthreads();      // s_r complete
#pragma unroll
        for (int i = 0; i < kSpan / kGroups; ++i) {
          const int j = grp + i * kGroups, tt = s0 + j;
          float r1 = 0.f, r2 = 0.f;
#pragma unroll
          for (int gg = 0; gg < kGroups; ++gg) {
            r1 += s_r[0][gg][j][lane];
            r2 += s_r[1][gg][j][lane];
          }
          if (t0 + tt < len && live) {
            const size_t off = (row0 + t0 + tt) * dim + d;
            store(du_out + off,
                  fmaf(s_dt[tt][lane], r1, skv * s_g[tt][lane]));
            store(dd_out + off, fmaf(s_u[tt][lane], r1, r2));
          }
        }
        __syncthreads();  // s_r free; after step 0, the chunk's arrays
      }
    }
    if (kk > 0) {
      if (kAsync) {
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        __syncthreads();  // every thread's pieces have landed
      }
      stage(kk - 1);
      commit_bc();
    }
  }
#pragma unroll
  for (int s = 0; s < kS; ++s)
    if (live && n0 + s < n) part_a[((size_t)row * dim + d) * n + n0 + s] = da[s];
  if (grp == 0 && live) part_skip[(size_t)row * dim + d] = dskip;
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
    // unrolled so that many loads are in flight; the adds stay in order
#pragma unroll 16
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
           void* h_last, int batch, int len, int dim, int n, void* stream) {
  if (!shape_ok(batch, len, dim, n)) return (int)cudaErrorInvalidValue;
  const int d_blocks = (dim + kChannels - 1) / kChannels;
  if ((long long)batch * d_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define SCAN_ARGS                                                       \
  (const T*)u, (const T*)delta, (const float*)a, (const T*)b,          \
      (const T*)c, (const float*)skip, (T*)y, (float*)states,         \
      (float*)h_last, len, dim, n, d_blocks
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

// Launches the sweep; with kAsync its dynamic shared memory (the next
// chunk's raw inputs, past the 48 KB it holds statically) is opted in
// once per device.
template <typename T, int kN, bool kAsync, typename... Args>
int launch_bwd_n(int batch, int d_blocks, cudaStream_t s, Args... args) {
  auto kernel = scan_bwd_kernel<T, kN, kAsync>;
  constexpr int smem = kAsync ? (int)sizeof(BwdRaw<T, kN>) : 0;
  if (kAsync) {
    static bool opted[kMaxDevices] = {};
    int dev = 0;
    int rc = (int)cudaGetDevice(&dev);
    if (rc != 0) return rc;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted[dev]) {
      rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (rc != 0) return rc;
      opted[dev] = true;
    }
  }
  kernel<<<(unsigned)(batch * d_blocks), kChannels * kGroups, smem, s>>>(
      args...);
  return (int)cudaGetLastError();
}

long long bwd_workspace(int batch, int len, int dim, int n) {
  const long long d_blocks = (dim + kChannels - 1) / kChannels;
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
  const int d_blocks = (dim + kChannels - 1) / kChannels;
  if ((long long)batch * d_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  float* part_bc = (float*)workspace;
  float* part_a = part_bc + (size_t)batch * d_blocks * len * 2 * n;
  float* part_skip = part_a + (size_t)batch * dim * n;
  const cudaStream_t s = (cudaStream_t)stream;
#define BWD_ARGS                                                           \
  (const T*)u, (const T*)delta, (const float*)a, (const T*)b, (const T*)c, \
      (const float*)skip, (const T*)g, (const float*)states, (T*)du,       \
      (T*)ddelta, part_bc, part_a, part_skip, len, dim, n, d_blocks
  // the next chunk copies in 16-byte pieces where rows of u, delta and g
  // are 16-byte aligned; else it loads once the chunk is done
  const bool async =
      (size_t)dim * sizeof(T) % 16 == 0 &&
      (((uintptr_t)u | (uintptr_t)delta | (uintptr_t)g) & 15) == 0;
  int rc;
  if (n <= 8)
    rc = async ? launch_bwd_n<T, 8, true>(batch, d_blocks, s, BWD_ARGS)
               : launch_bwd_n<T, 8, false>(batch, d_blocks, s, BWD_ARGS);
  else if (n <= 16)
    rc = async ? launch_bwd_n<T, 16, true>(batch, d_blocks, s, BWD_ARGS)
               : launch_bwd_n<T, 16, false>(batch, d_blocks, s, BWD_ARGS);
  else
    rc = async ? launch_bwd_n<T, 32, true>(batch, d_blocks, s, BWD_ARGS)
               : launch_bwd_n<T, 32, false>(batch, d_blocks, s, BWD_ARGS);
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
// backward reads; h_last (batch, dim, n) fp32, the state after the last
// step, which the forward writes unless it is null; workspace
// mamba_scan_bwd_workspace(...) floats.
extern "C" int mamba_scan_f32(const void* u, const void* delta,
                              const void* a, const void* b, const void* c,
                              const void* skip, void* y, void* states,
                              void* h_last, int batch, int len, int dim,
                              int n, void* stream) {
  return launch<float>(u, delta, a, b, c, skip, y, states, h_last, batch,
                       len, dim, n, stream);
}

extern "C" int mamba_scan_bf16(const void* u, const void* delta,
                               const void* a, const void* b, const void* c,
                               const void* skip, void* y, void* states,
                               void* h_last, int batch, int len, int dim,
                               int n, void* stream) {
  return launch<__nv_bfloat16>(u, delta, a, b, c, skip, y, states, h_last,
                               batch, len, dim, n, stream);
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
