// Decode attention (one new token against a KV cache, GQA) for Hopper
// (sm_90a), plain C launchers bound with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/decode_attention.py::_decode_kernel
// (decode_attention_pallas).
//
//   o[b,h] = sum_{j < kv_len} softmax_j(sm_scale * q[b,h] . k[b,h/G,j])
//            v[b,h/G,j]
//
// q (B, H, D), k and v (B, Hkv, S, D), o (B, H, D), contiguous, G = H/Hkv;
// only the first kv_len <= S keys are read (the serving cache is max_len
// long).  I/O is fp32 or bf16; scores, softmax statistics and P @ V are
// fp32.
//
// kv_len comes in one of two ways.  decode_attention_{f32,bf16} take it by
// value: the split follows it and the TMA maps end at row kv_len, so rows
// past it load as zeros.  decode_attention_dev_{f32,bf16} read it from
// device memory (an int32 the graph of a decode step writes, one launch
// for every position): the split and the maps follow the cache's length
// S, and a split that starts at or past kv_len holds no key.  Rows past
// kv_len then hold a slot's stale keys and values, which must be finite:
// their scores become -1e30 and their probabilities 0, so they add
// exactly nothing.
//
// What bounds it: bytes.  At yi-6b's shapes (Hkv = 4, G = 8, D = 128) and
// kv_len = 4096, one call reads 2 * 4 * 4096 * 128 * 2 B = 8.4 MB of bf16
// K/V (2.5 us at 3.35 TB/s) for 67 MFLOP.  The Pallas kernel walks the
// keys of one (b, KV head) in order on one core; here they are split over
// n_splits <= 16 blocks that form one thread block cluster, so the card
// fills at B = 1.  A block's 8 warps each keep an online softmax (m, l,
// acc) over their share of the block's keys; keys at or past kv_len
// weigh 0.  Keys and values arrive as TMA boxes into a 2-stage ring
// of swizzled shared memory (Ring); the types differ in the arithmetic
// of a step:
//
//   * bf16 (WarpBf16): rounds of 128 keys, 16 per warp; QK^T and P @ V on
//     the tensor cores, mma.sync m16n8k16 with fp32 accumulation, fed by
//     ldmatrix;
//   * fp32 (WarpF32): rounds of 64 keys, 8 per warp; IEEE fp32 on the
//     CUDA cores (no TF32).
//
// Why these choices, measured on an NVIDIA H100 80GB HBM3 at 700 W
// (PERF.md): on the CUDA cores bf16 took ~100 warp instructions per key
// (issue-bound); loads into registers moved only ~35 GB/s per SM; one
// TMA copy per 256-byte row was slower still; TMA boxes into a swizzled
// ring are what is left.
//
// Merge: the warps' (m, l, acc) go to shared memory and each thread
// merges its outputs over the 8 warps in warp order; block r of the
// cluster then merges the r-th slice of the outputs, which every block
// has pushed into its shared memory (remote stores, then one cluster
// barrier), the splits in rank order.  One launch per call, no global
// scratch and no atomics, so the result is the same from run to run.  Why
// not a last-arriving block merging the splits from global memory: one
// block reading 64 KB that lies in L2 took 2.0 us and 256 KB 5.1 us on
// that card, against 0.84 us for an empty launch.  Dynamic shared memory
// passes 48 KB (the ring, the warps' acc); its opt-in, which cost nothing
// measurable there, is set once per device and instantiation.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;                     // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxGridY = 65535;
constexpr int kMaxSplits = 16;                // blocks of one cluster
constexpr int kBoxRows = 64;                  // keys of a TMA box
constexpr int kMaxDevices = 64;
constexpr float kNegInf = -1e30f;             // NEG_INF of the Pallas body
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// the cluster barrier in two halves: every thread arrives at the start
// of the kernel and waits only before its first remote store, so the wait
// (every block of the cluster has started) costs nothing by then
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices, lanes 8i ... 8i + 7 giving the rows of the
// i-th; .trans hands each lane a column pair instead of a row pair
__device__ __forceinline__ void ldmatrix_x4(uint32_t* d, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* d,
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(addr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of parity ``parity``; a phase that never completes (a
// fault in this kernel) traps after ~2 s, so the launch fails instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 4000000000LL) __trap();
  }
}
// One TMA load of a (cols, rows, 1) box at (c0, c1, c2) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(const CUtensorMap* map,
                                         uint32_t dst, uint32_t bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float* d, uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A round of kRound keys and their values in shared memory, as TMA
// boxes of 64 rows by one swizzle span (32, 64 or 128 bytes) of columns;
// two rounds in flight
template <typename T, int D, int kRoundRows>
struct Ring {
  static constexpr int kRound = kRoundRows;
  static constexpr int kStages = 2;
  static constexpr int kBox = kBoxRows;
  static constexpr int kSpan = D * (int)sizeof(T) < 128
                                   ? D * (int)sizeof(T) : 128;
  static constexpr int kAtom = kSpan / (int)sizeof(T);   // its columns
  static constexpr int kAtoms = D / kAtom;
  static constexpr int kTile = kRound * D * (int)sizeof(T);  // K (or V)
  static constexpr int kStage = 2 * kTile;         // keys, then values
  // the ring from a 1024-byte boundary (the 128-byte swizzle's), then
  // its mbarriers
  static constexpr int kSmem = kStages * kStage + 1024 + 8 * kStages;

  // byte offset of (row, column d) in a tile as the TMA wrote it: box
  // d / kAtom, the row, then the 16-byte chunk XOR-swizzled by the row
  // (CU_TENSOR_MAP_SWIZZLE_32B / 64B / 128B)
  static __device__ __forceinline__ uint32_t at(int row, int d) {
    constexpr int kPer16 = 16 / (int)sizeof(T);
    const int c = (d % kAtom) / kPer16;
    const int x = ((row * kSpan) >> 7) & (kSpan / 16 - 1);
    return (d / kAtom) * (kRound * kSpan) + row * kSpan + ((c ^ x) << 4) +
           (d % kPer16) * (int)sizeof(T);
  }
};

// N floats (N = 1, 2 or 4) from a shared-memory address
template <int N>
__device__ __forceinline__ void lds(uint32_t addr, float* out) {
  if constexpr (N == 4) {
    asm volatile("ld.shared.v4.f32 {%0,%1,%2,%3}, [%4];\n"
                 : "=f"(out[0]), "=f"(out[1]), "=f"(out[2]), "=f"(out[3])
                 : "r"(addr));
  } else if constexpr (N == 2) {
    asm volatile("ld.shared.v2.f32 {%0,%1}, [%2];\n"
                 : "=f"(out[0]), "=f"(out[1])
                 : "r"(addr));
  } else {
    asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(out[0]) : "r"(addr));
  }
}

// Static shared memory of the fp32 path's step loop: the queries and a
// warp's step probabilities and rescale
template <int D, int GP>
struct Smem {
  float qs[GP][D];                      // the G queries (zero past G)
  float ps[kWarps][8][GP];              // a warp's step probabilities
  float alpha[kWarps][GP];              // a warp's step rescale
};

// Dynamic shared memory after the step loop: every warp's acc by (query,
// column), rows padded by one float (the ring's space, reused)
template <int D, int GP>
struct Slots {
  static constexpr int kRow = D + 1;
  static constexpr int kFloats = kWarps * GP * kRow;
};

// ---------------------------------------------------------------------------
// fp32: the CUDA cores, IEEE fp32, from the ring (rounds of 64 keys, 8
// per warp).  Lane (key, part): part p holds the 16-byte pieces i * 4 + p
// of the key's row and scores them against the G queries in shared
// memory; a quarter-warp takes keys q and q + 4, whose rows the swizzle
// puts on opposite halves of the banks.  A transpose-reduce over the 4
// parts leaves part p the whole scores of queries p * G/4 ...  For P @ V
// a lane owns D/32 columns of the value rows (D = 16: 16 lanes a row, two
// key subsets) and all G queries, the probabilities read from shared
// memory.
template <int D, int GP>
struct WarpF32 {
  using R = Ring<float, D, 8 * kWarps>;
  static constexpr int kKeys = 8;                 // keys per warp step
  static constexpr int kPieces = D / 16;          // 16-byte pieces a part
  static constexpr int kQ = GP / 4;               // queries per lane
  static constexpr int kVals = D >= 32 ? D / 32 : 1;
  static constexpr int kRowLanes = D / kVals;
  static constexpr int kSubs = 32 / kRowLanes;    // 2 at D = 16, else 1
  static constexpr int kKeysPerLane = kKeys / kSubs;

  int lane, key, part, vd0, vsub;
  float m[kQ], l[kQ], acc[GP][kVals];

  __device__ __forceinline__ void init(int lane_) {
    lane = lane_;
    key = (lane >> 3) + 4 * ((lane >> 2) & 1);
    part = lane & 3;
    vd0 = (lane % kRowLanes) * kVals;
    vsub = lane / kRowLanes;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
    }
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < kVals; ++e) acc[g][e] = 0.f;
  }

  // keys [c0, c0 + 8): rows row0 ... row0 + 7 of the key and value tiles
  // at ks and vs (shared addresses); every row finite (past kv_len the
  // TMA's zeros or stale values, masked)
  __device__ __forceinline__ void step(uint32_t ks, uint32_t vs, int row0,
                                       int c0, int k_end, float sm_scale,
                                       Smem<D, GP>& sm, int warp) {
    float sc[GP];
#pragma unroll
    for (int g = 0; g < GP; ++g) sc[g] = 0.f;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int d0 = (p * 4 + part) * 4;
      float kk[4];
      lds<4>(ks + R::at(row0 + key, d0), kk);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float4 qq = *reinterpret_cast<const float4*>(&sm.qs[g][d0]);
        sc[g] = fmaf(qq.x, kk[0], sc[g]);
        sc[g] = fmaf(qq.y, kk[1], sc[g]);
        sc[g] = fmaf(qq.z, kk[2], sc[g]);
        sc[g] = fmaf(qq.w, kk[3], sc[g]);
      }
    }
    // transpose-reduce over the key's 4 lanes
    float h1[GP / 2];
#pragma unroll
    for (int j = 0; j < GP / 2; ++j) {
      const bool up = part & 2;
      const float keep = up ? sc[j + GP / 2] : sc[j];
      const float send = up ? sc[j] : sc[j + GP / 2];
      h1[j] = keep + __shfl_xor_sync(kFull, send, 2);
    }
    float(*ps)[GP] = sm.ps[warp];
    float* alpha = sm.alpha[warp];
    const bool valid = c0 + key < k_end;
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      const bool up = part & 1;
      const float keep = up ? h1[j + kQ] : h1[j];
      const float send = up ? h1[j] : h1[j + kQ];
      const float sr = keep + __shfl_xor_sync(kFull, send, 1);
      const float s = valid ? sr * sm_scale : kNegInf;
      float cm = s;   // the step's max over its 8 keys
      cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 4));
      cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 8));
      cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 16));
      const float mn = fmaxf(m[j], cm);
      const float a = expf(m[j] - mn);
      const float p = valid ? expf(s - mn) : 0.f;
      l[j] = fmaf(l[j], a, p);
      m[j] = mn;
      ps[key][part * kQ + j] = p;
      if (key == 0) alpha[part * kQ + j] = a;
    }
    __syncwarp();
#pragma unroll
    for (int g = 0; g < GP; g += 4) {
      const float4 a = *reinterpret_cast<const float4*>(&alpha[g]);
#pragma unroll
      for (int e = 0; e < kVals; ++e) {
        acc[g][e] *= a.x;
        acc[g + 1][e] *= a.y;
        acc[g + 2][e] *= a.z;
        acc[g + 3][e] *= a.w;
      }
    }
#pragma unroll
    for (int j = 0; j < kKeysPerLane; ++j) {
      float vv[kVals];
      lds<kVals>(vs + R::at(row0 + j * kSubs + vsub, vd0), vv);
      const float* pj = ps[j * kSubs + vsub];
#pragma unroll
      for (int g = 0; g < GP; g += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(&pj[g]);
#pragma unroll
        for (int e = 0; e < kVals; ++e) {
          acc[g][e] = fmaf(p4.x, vv[e], acc[g][e]);
          acc[g + 1][e] = fmaf(p4.y, vv[e], acc[g + 1][e]);
          acc[g + 2][e] = fmaf(p4.z, vv[e], acc[g + 2][e]);
          acc[g + 3][e] = fmaf(p4.w, vv[e], acc[g + 3][e]);
        }
      }
    }
    __syncwarp();   // ps and alpha are rewritten by the next step
  }

  // l summed over the 8 key lanes, acc over the key subsets; (m, l) of
  // every query into wm / wl
  __device__ __forceinline__ void finish(float* wm, float* wl) {
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      l[j] += __shfl_xor_sync(kFull, l[j], 4);
      l[j] += __shfl_xor_sync(kFull, l[j], 8);
      l[j] += __shfl_xor_sync(kFull, l[j], 16);
    }
    if constexpr (kSubs == 2) {
#pragma unroll
      for (int g = 0; g < GP; ++g)
#pragma unroll
        for (int e = 0; e < kVals; ++e)
          acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], 16);
    }
    if (key == 0) {
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        wm[part * kQ + j] = m[j];
        wl[part * kQ + j] = l[j];
      }
    }
  }

  // f(register index, g, d, acc register) over every register; `own` is
  // false on the lanes that hold a copy (D = 16's second key subset)
  template <typename F>
  __device__ __forceinline__ void each(F&& f) {
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int e = 0; e < kVals; ++e)
        f(g * kVals + e, g, vd0 + e, acc[g][e], vsub == 0);
  }
};

// ---------------------------------------------------------------------------
// bf16: QK^T and P @ V on the tensor cores (mma.sync m16n8k16, fp32
// accumulate; bf16 products are exact in fp32, as the JAX kernel's
// upcast dot).  The keys and values reach shared memory as TMA boxes
// (64 rows by one 32-, 64- or 128-byte swizzle span; Ring::at gives the
// swizzled address, so ldmatrix reads without bank conflicts): a block
// takes rounds of 128 keys, warp w the keys 16 w ... 16 w + 15 of a
// round, two rounds in flight.  Lane (r = lane / 4, t = lane % 4):
//
//   * S^T = Q K^T: A = Q (16 rows: the queries, zero past G, from global
//     memory once), B = K^T by ldmatrix (an 8-key tile);
//   * the C fragment of S^T (query r, keys 2t, 2t + 1 of each 8-key tile)
//     is the B fragment of P^T in O^T = V^T P^T, so P never leaves the
//     registers.  P is not rounded to one bf16: it goes in as hi + mid +
//     lo, three bf16 terms (~24 bits, as fp32), and three products (with
//     two, ~16 bits, the bf16 outputs rounded the other way ~100 times
//     as often: qwen3's greedy tokens equal to the plain path fell from
//     85 to 81 of 96);
//   * V^T's A fragments by ldmatrix.trans.
template <int D, int GP>
struct WarpBf16 {
  static constexpr int kKeys = 16;          // keys per warp step
  static constexpr int kSteps = D / 16;     // k-steps of QK^T, m-tiles of O^T
  static constexpr int kNQ = GP / 8;        // 8-query tiles
  using R = Ring<__nv_bfloat16, D, kWarps * kKeys>;

  int lane, r, t;
  uint32_t qa[kSteps][4];                   // A fragments of Q
  float m[kNQ], l[kNQ], acc[kSteps][kNQ][4];

  __device__ __forceinline__ void init(int lane_) {
    lane = lane_;
    r = lane >> 2;
    t = lane & 3;
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      m[j] = kNegInf;
      l[j] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // the A fragments of the queries (rows r and r + 8, zero past G)
  __device__ __forceinline__ void load_q(const __nv_bfloat16* qp,
                                         int group) {
    const unsigned int* q0 =
        reinterpret_cast<const unsigned int*>(qp + (size_t)r * D);
    const unsigned int* q1 =
        reinterpret_cast<const unsigned int*>(qp + (size_t)(r + 8) * D);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      qa[s][0] = r < group ? __ldg(q0 + 8 * s + t) : 0u;
      qa[s][2] = r < group ? __ldg(q0 + 8 * s + 4 + t) : 0u;
      qa[s][1] = GP > 8 && r + 8 < group ? __ldg(q1 + 8 * s + t) : 0u;
      qa[s][3] = GP > 8 && r + 8 < group ? __ldg(q1 + 8 * s + 4 + t) : 0u;
    }
  }

  // keys [c0, c0 + 16): rows row0 ... row0 + 15 of the key and value
  // tiles at ks and vs (shared addresses); every row finite (past kv_len
  // the TMA's zeros or stale values, masked)
  __device__ __forceinline__ void step(uint32_t ks, uint32_t vs, int row0,
                                       int c0, int k_end, float sm_scale) {
    const int mi = lane >> 3, row = row0 + 8 * (mi >> 1) + (lane & 7);
    // two accumulators per tile (even and odd k-steps) halve the chain
    // of dependent products
    float acc2[2][2][4] = {};
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      uint32_t b[4];   // (tile 0: b0, b1), (tile 1: b0, b1)
      ldmatrix_x4(b, ks + R::at(row, 16 * s + 8 * (mi & 1)));
#pragma unroll
      for (int n = 0; n < 2; ++n)
        mma_bf16(acc2[s & 1][n], qa[s][0], qa[s][1], qa[s][2], qa[s][3],
                 b[2 * n], b[2 * n + 1]);
    }
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = acc2[0][n][e] + acc2[1][n][e];
    // lane holds query r + 8j's scores of keys 2t, 2t + 1, 8 + 2t, 9 + 2t
    bool valid[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      valid[e] = c0 + 8 * (e >> 1) + 2 * t + (e & 1) < k_end;
    uint32_t bp[kNQ][3][2];   // P^T's B fragments: hi, mid, lo terms
    float alpha[kNQ];
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      float sj[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sj[e] = valid[e] ? sc[e >> 1][2 * j + (e & 1)] * sm_scale : kNegInf;
      float cm = fmaxf(fmaxf(sj[0], sj[1]), fmaxf(sj[2], sj[3]));
      cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 1));
      cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 2));
      const float mn = fmaxf(m[j], cm);
      alpha[j] = expf(m[j] - mn);
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = valid[e] ? expf(sj[e] - mn) : 0.f;
      l[j] = fmaf(l[j], alpha[j], (p[0] + p[1]) + (p[2] + p[3]));
      m[j] = mn;
      // p = hi + mid + lo, each a bf16, exact to ~2^-24 of p: the rest of
      // p after each term is exact in fp32
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        bp[j][x][0] = pack_bf16(p[0], p[1]);
        bp[j][x][1] = pack_bf16(p[2], p[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t h = e & 1 ? bp[j][x][e >> 1] & 0xffff0000u
                                   : bp[j][x][e >> 1] << 16;
          p[e] -= __uint_as_float(h);
        }
      }
    }
    // acc columns are queries 2t, 2t + 1 (+ 8j): their rescale lives in
    // the lanes r = 2t, 2t + 1
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      const float a0 = __shfl_sync(kFull, alpha[j], (2 * t) << 2);
      const float a1 = __shfl_sync(kFull, alpha[j], (2 * t + 1) << 2);
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        acc[i][j][0] *= a0;
        acc[i][j][1] *= a1;
        acc[i][j][2] *= a0;
        acc[i][j][3] *= a1;
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      uint32_t a[4];   // rows 16i + r, 16i + 8 + r; keys 0-7, then 8-15
      ldmatrix_x4_trans(a, vs + R::at(row, 16 * i + 8 * (mi & 1)));
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int x = 0; x < 3; ++x)
          mma_bf16(acc[i][j], a[0], a[1], a[2], a[3], bp[j][x][0],
                   bp[j][x][1]);
    }
  }

  __device__ __forceinline__ void finish(float* wm, float* wl) {
#pragma unroll
    for (int j = 0; j < kNQ; ++j) {
      l[j] += __shfl_xor_sync(kFull, l[j], 1);
      l[j] += __shfl_xor_sync(kFull, l[j], 2);
      if (t == 0) {
        wm[8 * j + r] = m[j];
        wl[8 * j + r] = l[j];
      }
    }
  }

  template <typename F>
  __device__ __forceinline__ void each(F&& f) {
#pragma unroll
    for (int i = 0; i < kSteps; ++i)
#pragma unroll
      for (int j = 0; j < kNQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          f((i * kNQ + j) * 4 + e, 8 * j + 2 * t + (e & 1),
            16 * i + r + 8 * (e >> 1), acc[i][j][e], true);
  }
};

template <typename T, int D, int GP>
using Warp = std::conditional_t<sizeof(T) == 2, WarpBf16<D, GP>,
                                WarpF32<D, GP>>;

template <typename T, int D, int GP>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v,
              const T* __restrict__ q, T* __restrict__ o,
              const int* __restrict__ kv_len_dev, int group, int kv_len_arg,
              int n_splits, int split_keys, float sm_scale, int bk0) {
  constexpr bool kMma = sizeof(T) == 2;
  using W = Warp<T, D, GP>;
  __shared__ __align__(16) Smem<D, GP> sm;
  __shared__ float wm[kWarps][GP], wl[kWarps][GP];   // each warp's (m, l)
  // a warp's (then a split's) weight exp(m - max m) in each query
  __shared__ float fac[kMaxSplits > kWarps ? kMaxSplits : kWarps][GP];
  // pushed here by the cluster's blocks: each split's (max, sum), and its
  // acc over this block's slice of the outputs (apart from everything
  // else: another block may write here while this one still computes)
  __shared__ float recv_m[kMaxSplits][GP], recv_l[kMaxSplits][GP];
  __shared__ float recv[GP * D + 4 * kMaxSplits];
  // dynamic: the ring (from a 1024-byte boundary), then the warps' acc
  // slots in the same space after the step loop
  extern __shared__ __align__(1024) unsigned char dsm[];
  const uint32_t base = (smem_u32(dsm) + 1023) & ~1023u;
  float* slots = reinterpret_cast<float*>(dsm + (base - smem_u32(dsm)));

  const int split = blockIdx.x;         // == rank in the cluster
  const int bk = bk0 + blockIdx.y;      // b * Hkv + KV head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kv_len = kv_len_dev != nullptr ? __ldg(kv_len_dev) : kv_len_arg;
  const int k_begin = split * split_keys;
  const int k_end = min(kv_len, k_begin + split_keys);
  const T* qp = q + (size_t)bk * group * D;

  if (n_splits > 1) cluster_arrive();
  W w;
  w.init(lane);
  // rounds of keys through a 2-stage ring of shared memory: one thread
  // issues a round's TMA boxes, every warp computes its share of it
  using R = typename W::R;
  const uint32_t ring = base;
  const uint32_t bar0 = ring + R::kStages * R::kStage;
  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_k))
                 : "memory");
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                     reinterpret_cast<uint64_t>(&map_v))
                 : "memory");
    for (int s = 0; s < R::kStages; ++s) mbar_init(bar0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kMma) {
    w.load_q(qp, group);
  } else {
    for (int i = tid; i < GP * D; i += kThreads) {
      const int g = i / D;
      sm.qs[g][i - g * D] = g < group ? __ldg(qp + i) : 0.f;
    }
  }
  __syncthreads();
  const int rounds = k_end > k_begin ? (k_end - k_begin + R::kRound - 1) /
                                           R::kRound : 0;
  // a round's boxes of 64 rows that start before k_end (a warp's keys
  // never straddle two boxes, so every row a warp reads was loaded)
  auto issue = [&](int rnd) {   // by thread 0
    const int s = rnd % R::kStages, first = k_begin + rnd * R::kRound;
    const int boxes = min(R::kRound, k_end - first + R::kBox - 1) / R::kBox;
    const uint32_t bar = bar0 + 8 * s, dst = ring + s * R::kStage;
    mbar_expect_tx(bar, boxes * R::kAtoms * 2 * R::kBox * R::kSpan);
    for (int a = 0; a < R::kAtoms; ++a) {
      for (int b = 0; b < boxes; ++b) {
        const uint32_t off = (a * R::kRound + b * R::kBox) * R::kSpan;
        tma_load(&map_k, dst + off, bar, a * R::kAtom, first + b * R::kBox,
                 bk);
        tma_load(&map_v, dst + R::kTile + off, bar, a * R::kAtom,
                 first + b * R::kBox, bk);
      }
    }
  };
  if (tid == 0)
    for (int rnd = 0; rnd < min(R::kStages, rounds); ++rnd) issue(rnd);
  for (int rnd = 0; rnd < rounds; ++rnd) {
    const int s = rnd % R::kStages;
    mbar_wait(bar0 + 8 * s, (rnd / R::kStages) & 1);
    const int c0 = k_begin + rnd * R::kRound + warp * W::kKeys;
    if (c0 < k_end) {
      const uint32_t ks = ring + s * R::kStage;
      if constexpr (kMma)
        w.step(ks, ks + R::kTile, warp * W::kKeys, c0, k_end, sm_scale);
      else
        w.step(ks, ks + R::kTile, warp * W::kKeys, c0, k_end, sm_scale, sm,
               warp);
    }
    __syncthreads();   // every warp is done with stage s
    if (tid == 0 && rnd + R::kStages < rounds) issue(rnd + R::kStages);
  }

  // every warp's (m, l) and acc into shared memory (the ring's space:
  // every round is consumed), then each thread merges the warps in warp
  // order for its outputs; a warp with no valid key has m = -1e30, l = 0,
  // acc = 0 and weighs 0
  w.finish(wm[warp], wl[warp]);
  w.each([&](int, int g, int d, float& a, bool own) {
    if (own) slots[(warp * GP + g) * Slots<D, GP>::kRow + d] = a;
  });
  __syncthreads();
  if (tid < kWarps * GP) {   // warp j's weight in query g, once
    const int j = tid / GP, g = tid - j * GP;
    float mx = kNegInf;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) mx = fmaxf(mx, wm[x][g]);
    fac[j][g] = expf(wm[j][g] - mx);
  }
  __syncthreads();
  const int total = group * D;
  constexpr int kMine = (GP * D + kThreads - 1) / kThreads;
  float out_a[kMine], out_l[kMine];
#pragma unroll
  for (int e = 0; e < kMine; ++e) {
    const int i = tid + e * kThreads;
    if (i < total) {
      const int g = i / D, d = i - g * D;
      float sum = 0.f, a = 0.f;
#pragma unroll
      for (int j = 0; j < kWarps; ++j) {
        sum = fmaf(wl[j][g], fac[j][g], sum);
        a = fmaf(slots[(j * GP + g) * Slots<D, GP>::kRow + d], fac[j][g], a);
      }
      out_a[e] = a;
      out_l[e] = sum;
    }
  }
  T* ob = o + (size_t)bk * group * D;
  if (n_splits == 1) {
    // the Pallas kernel's finalize: acc / max(l, 1e-30)
#pragma unroll
    for (int e = 0; e < kMine; ++e) {
      const int i = tid + e * kThreads;
      if (i < total) store_f(ob + i, out_a[e] / fmaxf(out_l[e], 1e-30f));
    }
    return;
  }

  // the cluster's splits: block s merges the s-th slice of the outputs
  // (`per` of them, a multiple of 4).  Every block pushes its acc of each
  // slice, and its (max, sum), into the block that merges it (remote
  // stores, spread over all threads); after one cluster barrier each block
  // merges from its own shared memory, the splits in rank order
  const int per = ((total + n_splits - 1) / n_splits + 3) & ~3;
  cg::cluster_group cluster = cg::this_cluster();
  cluster_wait();   // every block of the cluster has started
#pragma unroll
  for (int e = 0; e < kMine; ++e) {
    const int i = tid + e * kThreads;
    if (i < total) {
      const int dst = i / per;
      *cluster.map_shared_rank(&recv[split * per + i - dst * per], dst) =
          out_a[e];
    }
  }
  if (tid < n_splits * group) {   // the block's (max, sum) of g to block r
    const int r = tid / group, g = tid - r * group;
    float mx = kNegInf, sum = 0.f;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) mx = fmaxf(mx, wm[j][g]);
#pragma unroll
    for (int j = 0; j < kWarps; ++j) sum = fmaf(wl[j][g], fac[j][g], sum);
    *cluster.map_shared_rank(&recv_m[split][g], r) = mx;
    *cluster.map_shared_rank(&recv_l[split][g], r) = sum;
  }
  cluster.sync();
  if (tid < n_splits * group) {   // split r's weight in query g, once
    const int r = tid / group, g = tid - r * group;
    float mx = kNegInf;
#pragma unroll
    for (int x = 0; x < kMaxSplits; ++x)
      if (x < n_splits) mx = fmaxf(mx, recv_m[x][g]);
    fac[r][g] = expf(recv_m[r][g] - mx);
  }
  __syncthreads();
  const int lo = split * per, hi = min(total, lo + per);
  for (int i = lo + tid; i < hi; i += kThreads) {
    const int g = i / D;
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < kMaxSplits; ++r) {
      if (r < n_splits) {
        sum = fmaf(recv_l[r][g], fac[r][g], sum);
        a = fmaf(recv[r * per + i - lo], fac[r][g], a);
      }
    }
    // the Pallas kernel's finalize: acc / max(l, 1e-30)
    store_f(ob + i, a / fmaxf(sum, 1e-30f));
  }
}

// cuTensorMapEncodeTiled is a driver-API function: take it from the
// runtime's driver entry point, so the library links nothing beyond
// nvcc's default.
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map over (D, rows, B * Hkv) of the cache (rows seq apart per
// head), boxes of (kAtom, 64, 1), swizzled as Ring::at reads them: a box
// that runs past `rows` (kv_len, or seq when kv_len is read on the
// device) reads zeros, not the keys past it.
template <typename T, int D, int GP>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int seq,
                int heads) {
  using R = typename Warp<T, D, GP>::R;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * sizeof(T),
                                 (cuuint64_t)seq * D * sizeof(T)};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)R::kAtom, (cuuint32_t)R::kBox, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      R::kSpan == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                      : (R::kSpan == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                        : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode_tiled()(map,
                        sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, int GP>
int launch_g(const void* q, const void* k, const void* v, void* o,
             const int* kv_len_dev, int batch, int n_kv, int group, int seq,
             int kv_len, int n_splits, int split_keys, float sm_scale,
             void* stream) {
  auto kernel = decode_kernel<T, D, GP>;
  constexpr int slots = Slots<D, GP>::kFloats * 4 + 1024;
  constexpr int ring = Warp<T, D, GP>::R::kSmem;
  constexpr int smem = ring > slots ? ring : slots;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_k, map_v;
  const int rows = kv_len_dev != nullptr ? seq : kv_len;
  if (!tensor_map<T, D, GP>(&map_k, k, rows, seq, batch * n_kv) ||
      !tensor_map<T, D, GP>(&map_v, v, rows, seq, batch * n_kv))
    return (int)cudaErrorInvalidValue;
  // the > 48 KB of dynamic shared memory and clusters past 8 blocks are
  // opted in once per device and kernel (the attributes are per device)
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (rc == 0)
      rc = (int)cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (rc != 0) return rc;
    opted[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // b * Hkv on grid y, in slices of at most 65535, a launch each
  const int heads = batch * n_kv;
  for (int bk0 = 0; bk0 < heads; bk0 += kMaxGridY) {
    cfg.gridDim = dim3((unsigned)n_splits,
                       (unsigned)min(kMaxGridY, heads - bk0));
    cudaLaunchKernelEx(&cfg, kernel, map_k, map_v, (const T*)q, (T*)o,
                       kv_len_dev, group, kv_len, n_splits, split_keys,
                       sm_scale, bk0);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const int* kv_len_dev, int batch, int n_kv, int group, int seq,
             int kv_len, int n_splits, int split_keys, float sm_scale,
             void* stream) {
  if (group <= 8)
    return launch_g<T, D, 8>(q, k, v, o, kv_len_dev, batch, n_kv, group, seq,
                             kv_len, n_splits, split_keys, sm_scale, stream);
  return launch_g<T, D, 16>(q, k, v, o, kv_len_dev, batch, n_kv, group, seq,
                            kv_len, n_splits, split_keys, sm_scale, stream);
}

// kv_len_dev null: kv_len is the host's; else the kernel reads it there
// and the split must cover all seq rows
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_len_dev, int batch, int n_kv, int group, int seq,
           int kv_len, int head_dim, int n_splits, int split_keys,
           float sm_scale, void* stream) {
  const int covered = kv_len_dev != nullptr ? seq : kv_len;
  if (group < 1 || group > 16 || covered < 1 || covered > seq ||
      n_splits < 1 || n_splits > kMaxSplits || split_keys < 1 ||
      (long long)n_splits * split_keys < covered)
    return (int)cudaErrorInvalidValue;
  switch (head_dim) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, kv_len_dev, batch, n_kv, group, seq,
                             kv_len, n_splits, split_keys, sm_scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, kv_len_dev, batch, n_kv, group, seq,
                             kv_len, n_splits, split_keys, sm_scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, kv_len_dev, batch, n_kv, group, seq,
                             kv_len, n_splits, split_keys, sm_scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, kv_len_dev, batch, n_kv, group,
                              seq, kv_len, n_splits, split_keys, sm_scale,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each launches the kernel (once per 65535 of batch * n_kv, once at the
// path's shapes) and returns cudaGetLastError() after the last (0 = all
// launched).  Block s of a (b, KV head) takes the keys
// [s * split_keys, min(kv_len, (s + 1) * split_keys)); the n_splits <= 16
// blocks of a (b, KV head) form one cluster.  The caller guarantees
// 0 < kv_len <= seq, n_splits * split_keys >= kv_len (>= seq for the
// _dev_ launchers), 1 <= group <= 16, head_dim in {16, 32, 64, 128},
// contiguous 16-byte-aligned tensors of one dtype.
// The kernel's TMA box rows and largest cluster, which the wrapper's
// split policy assumes.
extern "C" void decode_attention_limits(int* box_rows, int* max_splits) {
  *box_rows = kBoxRows;
  *max_splits = kMaxSplits;
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int n_kv, int group, int seq, int kv_len,
                                    int head_dim, int n_splits,
                                    int split_keys, float sm_scale,
                                    void* stream) {
  return launch<float>(q, k, v, o, nullptr, batch, n_kv, group, seq, kv_len,
                       head_dim, n_splits, split_keys, sm_scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o, int batch,
                                     int n_kv, int group, int seq,
                                     int kv_len, int head_dim, int n_splits,
                                     int split_keys, float sm_scale,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, nullptr, batch, n_kv, group, seq,
                               kv_len, head_dim, n_splits, split_keys,
                               sm_scale, stream);
}

// The same with kv_len read from device memory (one int32, 0 < *kv_len <=
// seq, which the caller guarantees); n_splits * split_keys >= seq.
extern "C" int decode_attention_dev_f32(const void* q, const void* k,
                                        const void* v, void* o,
                                        const int* kv_len, int batch,
                                        int n_kv, int group, int seq,
                                        int head_dim, int n_splits,
                                        int split_keys, float sm_scale,
                                        void* stream) {
  return launch<float>(q, k, v, o, kv_len, batch, n_kv, group, seq, 0,
                       head_dim, n_splits, split_keys, sm_scale, stream);
}

extern "C" int decode_attention_dev_bf16(const void* q, const void* k,
                                         const void* v, void* o,
                                         const int* kv_len, int batch,
                                         int n_kv, int group, int seq,
                                         int head_dim, int n_splits,
                                         int split_keys, float sm_scale,
                                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, kv_len, batch, n_kv, group, seq,
                               0, head_dim, n_splits, split_keys, sm_scale,
                               stream);
}
