// Flash attention (GQA, causal, online softmax) for Hopper (sm_90a), plain
// C launchers bound with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention/flash_attention.py::_flash_kernel
// (flash_attention_pallas).
//
//   o[b,h,i] = sum_j softmax_j(sm_scale * q[b,h,i] . k[b,h/G,j]) v[b,h/G,j]
//
// q (B, H, Sq, D), k and v (B, Hkv, Sk, D), o (B, H, Sq, D), contiguous,
// G = H / Hkv.  The causal mask keeps qpos >= kpos; keys past Sk are
// masked (the kernel handles the ragged edge; the wrapper never pads).
// m, l and the accumulators are fp32.
//
// What bounds it: at yi-6b's shapes (H = 32, Hkv = 4, D = 128), a causal
// prefill of S = 2048 is 4 * H * S^2 * D / 2 = 34.4 GFLOP per layer
// against (2 H + 2 Hkv) * S * D * 2 B = 37.7 MB of bf16 I/O: ~900 FLOP
// per byte, so operations bound it: 35 us per layer at the bf16
// tensor-core peak (989 TFLOP/s), 0.5 ms at the fp32 CUDA-core peak.
//
// bf16 (flash_wgmma_kernel): both products on the tensor cores, with
// wgmma, fed by TMA.
//
//   * one block per (b, h, 128-query tile); two consumer warpgroups of 64
//     query rows (wgmma's M) and one producer warp.  The grid's x is
//     b * H + h, so the G query heads of one KV head run side by side and
//     share its K/V tiles in L2; its y walks the query tiles from the
//     last, causally heaviest, to the first.
//   * the producer loads the block's Q tile once, then streams 128-key
//     K and V tiles into a 2-stage ring in shared memory with TMA (3-D
//     maps (D, S, B * heads), so a ragged tile reads zeros, never the
//     next head), with a full and an empty mbarrier per stage: loads run
//     ahead of the math.  Rows are stored with D contiguous under the
//     widest swizzle a row allows (32, 64 or 128 bytes; D = 128 is two
//     128-byte atoms side by side), the layout wgmma reads.
//   * S = Q K^T: D / 16 wgmma m64n128k16 per tile, both operands
//     K-major in shared memory.  The online softmax runs on S in the
//     accumulator registers (a thread holds 2 rows; row max over the 4
//     lanes of a row by two shuffles; exp2 with sm_scale * log2(e) folded
//     in).  Only the causal diagonal tile and a ragged last tile are
//     masked (zero-filled keys past Sk score 0, not -inf); tiles wholly
//     in the causal future are never loaded.
//   * O += P V: P is rounded to bf16 in registers, where the accumulator
//     layout is wgmma's A-fragment layout, and V is read from shared
//     memory as an MN-major B operand (the transpose bit): 8 wgmma
//     m64nDk16 per tile, no trip through shared memory for P.  The
//     rounding moves each weight by at most 2^-9 of itself, where the
//     Pallas kernel multiplies in fp32; the output is bf16 in both.
//
// fp32 (flash_attention_kernel) stays on CUDA cores: fp32 here means
// IEEE fp32, and the tensor cores take fp32 only as TF32 (10-bit
// mantissa).  fp32 FMAs, no tensor cores:
//
//   * one block per (b, h, 64-query tile), b * H + h on grid y in slices
//     of at most 65535 (a launch per slice), 4 threads per query row; a
//     thread owns D/16 float4 chunks of the row (chunks interleaved across
//     the 4 threads, so a warp's shared-memory reads hit 4 neighbouring
//     16-byte words and broadcast across its 8 rows);
//   * K and V tiles of 32 keys are staged in shared memory and read by
//     all 64 rows of the block, once per tile;
//   * a row's 32 scores live in registers: tile max, rescale of (l, acc)
//     by exp(m - m_new), p = exp(s - m_new), acc += p v;
//   * key tiles wholly in the causal future of the block's last row are
//     never loaded (the Pallas kernel's pl.when(run) skip).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

namespace {

// ------------------------- fp32: CUDA cores -------------------------

constexpr int kBlockQ = 64;                      // query rows per block
constexpr int kRowThreads = 4;                   // threads per query row
constexpr int kThreads = kBlockQ * kRowThreads;  // 256
constexpr int kBlockK = 32;                      // keys per staged tile
constexpr float kNegInf = -1e30f;                // the Pallas kernel's
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int n_heads, int group,
                       int sq, int sk, float sm_scale, int causal, int bh0) {
  constexpr int kChunks = D / (4 * kRowThreads);  // a thread's float4s
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = bh0 + blockIdx.y;                // b * n_heads + h
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const size_t kv_base =
      ((size_t)b * (n_heads / group) + h / group) * (size_t)sk * D;
  const float* kp = k + kv_base;
  const float* vp = v + kv_base;

  const int t = threadIdx.x;
  const int row = t / kRowThreads;
  const int part = t % kRowThreads;
  const int qpos = q0 + row;
  const bool active = qpos < sq;
  const size_t q_off = ((size_t)bh * sq + (active ? qpos : 0)) * D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[kChunks], acc[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = 4 * (part + kRowThreads * c);
    qr[c] = active ? load4(q + q_off + col) : zero;
    acc[c] = zero;
  }
  float m = kNegInf, l = 0.f;

  // keys after the block's last query row are all in its causal future
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the previous tile has been read by every row
    for (int i = t; i < kBlockK * D / 4; i += kThreads) {
      const int j = (4 * i) / D;
      const int col = 4 * i - j * D;
      const bool in = k0 + j < sk;
      const size_t off = (size_t)(k0 + j) * D + col;
      store4(ks + 4 * i, in ? load4(kp + off) : zero);
      store4(vs + 4 * i, in ? load4(vp + off) : zero);
    }
    __syncthreads();

    float s[kBlockK];
    float m_tile = kNegInf;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float* kr = ks + j * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = load4(kr + 4 * (part + kRowThreads * c));
        dot = fmaf(qr[c].x, kk.x, dot);
        dot = fmaf(qr[c].y, kk.y, dot);
        dot = fmaf(qr[c].z, kk.z, dot);
        dot = fmaf(qr[c].w, kk.w, dot);
      }
      // the row's 4 threads are neighbouring lanes of one warp
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kpos = k0 + j;
      const bool valid = kpos < sk && (!causal || qpos >= kpos);
      s[j] = valid ? dot * sm_scale : kNegInf;
      m_tile = fmaxf(m_tile, s[j]);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float l_tile = 0.f;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const int kpos = k0 + j;
      const bool valid = kpos < sk && (!causal || qpos >= kpos);
      s[j] = valid ? expf(s[j] - m_new) : 0.f;
      l_tile += s[j];
    }
    l = alpha * l + l_tile;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float* vr = vs + j * D;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = load4(vr + 4 * (part + kRowThreads * c));
        acc[c].x = fmaf(s[j], vv.x, acc[c].x);
        acc[c].y = fmaf(s[j], vv.y, acc[c].y);
        acc[c].z = fmaf(s[j], vv.z, acc[c].z);
        acc[c].w = fmaf(s[j], vv.w, acc[c].w);
      }
    }
    m = m_new;
  }

  if (active) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * (part + kRowThreads * c);
      store4(o + q_off + col,
             make_float4(acc[c].x / denom, acc[c].y / denom,
                         acc[c].z / denom, acc[c].w / denom));
    }
    if (lse != nullptr && part == 0)
      lse[(size_t)bh * sq + qpos] = m + logf(denom);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int batch, int n_heads, int group, int sq, int sk,
               float sm_scale, int causal, void* stream) {
  const int rows = batch * n_heads;
  for (int bh0 = 0; bh0 < rows; bh0 += kMaxGridY) {
    const dim3 grid((unsigned)((sq + kBlockQ - 1) / kBlockQ),
                    (unsigned)min(kMaxGridY, rows - bh0));
    flash_attention_kernel<D><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        (float*)lse, n_heads, group, sq, sk, sm_scale, causal, bh0);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  return 0;
}

// ---------------------- bf16: tensor cores (wgmma) ----------------------

constexpr int kRows = 128;                 // query rows per block
constexpr int kKeys = 128;                 // keys per K/V tile
constexpr int kStages = 2;                 // K/V tiles in flight
constexpr int kConsumerWarps = 8;          // two warpgroups of 64 rows
constexpr int kTcThreads = 32 * kConsumerWarps + 32;  // + the producer
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr long long kWatchdogCycles = 1ll << 32;  // ~2 s: a lost barrier

template <int D>
struct Tiles {
  // bytes per swizzled row of an atom: 32, 64 or 128, the widest a row
  // of D bf16 allows; D = 128 is two 128-byte atoms side by side
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;
  static constexpr int kAtomCols = kSwizzle / 2;        // bf16 per row
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kStepsPerAtom = kSwizzle / 32;   // k16 steps
  // wgmma descriptor layout type: 1 = 128B, 2 = 64B, 3 = 32B swizzle
  static constexpr uint64_t kLayout =
      kSwizzle == 128 ? 1 : (kSwizzle == 64 ? 2 : 3);
  static constexpr int kQBytes = kRows * D * 2;
  static constexpr int kTileBytes = kKeys * D * 2;       // K or V
  static constexpr int kData = kQBytes + 2 * kStages * kTileBytes;
  // 1 KB of slack to align the data to the 128B swizzle's 1 KB period,
  // then 5 mbarriers (Q, full[2], empty[2])
  static constexpr int kSmem = kData + 1024 + 8 * (1 + 2 * kStages);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
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

// Wait for the phase of parity ``parity`` to complete.  A barrier that
// never completes (a fault in this kernel) traps after ~2 s, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > kWatchdogCycles) __trap();
  }
}

// One TMA load of a (cols, rows, 1) box at (c0, c1, c2) into shared
// memory, completing on ``bar``.
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

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator
// registers across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_D8(i) WG_D4(i), WG_D4(i + 4)
#define WG_D16(i) WG_D8(i), WG_D8(i + 8)
#define WG_D32(i) WG_D16(i), WG_D16(i + 16)
#define WG_D64(i) WG_D32(i), WG_D32(i + 32)

// wgmma m64nNk16, bf16 in, fp32 accumulators d (N / 2 per thread).
// ss: A and B from shared memory, both K-major.  rs: A (a 64 x 16
// fragment, 4 registers of 2 bf16) from registers, B from shared memory
// MN-major (the transpose bit).  acc = 0 overwrites d.
template <int N>
struct Wgmma;
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};
template <> struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_D16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : WG_D32(0)
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D32(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da,
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : WG_D64(0)
        : "l"(da), "l"(db), "r"(acc));
  }
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_D64(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(acc));
  }
};

#undef WG_D64
#undef WG_D32
#undef WG_D16
#undef WG_D8
#undef WG_D4

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int n_heads, int group, int sq, int sk, float scale_log2,
                   int causal) {
  using T = Tiles<D>;
  constexpr int kSw = T::kSwizzle;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_q = base;
  // stage s: K at s_kv(s), V at s_kv(s) + kTileBytes
  auto s_kv = [&](int s) { return base + T::kQBytes + 2 * s * T::kTileBytes; };
  const uint32_t bar_q = base + T::kData;
  auto bar_full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_empty = [&](int s) { return bar_q + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x;                        // b * n_heads + h
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int b = bh / n_heads;
  const int bkv = b * (n_heads / group) + (bh - b * n_heads) / group;
  // keys after the block's last query row are all in its causal future
  const int k_end = causal ? min(sk, q0 + kRows) : sk;
  const int n_tiles = (k_end + kKeys - 1) / kKeys;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full(s), 1);
      mbar_init(bar_empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {  // the producer warp: one thread loads
    if (lane == 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int a = 0; a < T::kAtoms; ++a)
        tma_load(&map_q, s_q + a * kRows * kSw, bar_q, a * T::kAtomCols, q0,
                 bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(bar_empty(s), (t / kStages - 1) & 1);
        mbar_expect_tx(bar_full(s), 2 * T::kTileBytes);
        for (int a = 0; a < T::kAtoms; ++a) {
          const uint32_t off = a * kKeys * kSw;
          tma_load(&map_k, s_kv(s) + off, bar_full(s), a * T::kAtomCols,
                   t * kKeys, bkv);
          tma_load(&map_v, s_kv(s) + T::kTileBytes + off, bar_full(s),
                   a * T::kAtomCols, t * kKeys, bkv);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: 64 query rows; this thread holds rows r and
  // r + 8 of its warp's 16 (accumulator element 4j + e: row r + 8 (e / 2),
  // column 8j + 2 (lane % 4) + e % 2)
  const int wg = warp / 4;
  const int wg_row0 = q0 + 64 * wg;
  const int r = wg_row0 + 16 * (warp % 4) + lane / 4;
  const int c = 2 * (lane % 4);
  const float neg_inf = __int_as_float(0xff800000);
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  float m[2] = {neg_inf, neg_inf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const int k0 = t * kKeys;
    const uint32_t s_k = s_kv(s), s_v = s_kv(s) + T::kTileBytes;
    mbar_wait(bar_full(s), (t / kStages) & 1);
    __syncwarp();  // wgmma is .sync.aligned: the warp issues it together

    float acc_s[kKeys / 2];
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) acc_s[i] = 0.f;
    fence_regs(acc_s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int atom = kk / T::kStepsPerAtom;
      const int col = 32 * (kk % T::kStepsPerAtom);      // bytes
      const uint64_t da = smem_desc(
          s_q + atom * kRows * kSw + 64 * wg * kSw + col, 16, 8 * kSw,
          T::kLayout);
      const uint64_t db = smem_desc(s_k + atom * kKeys * kSw + col, 16,
                                    8 * kSw, T::kLayout);
      Wgmma<kKeys>::ss(acc_s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_s);

    // keys past sk, and keys after the row under the causal mask
    if (k0 + kKeys > sk || (causal && k0 + kKeys - 1 > wg_row0)) {
#pragma unroll
      for (int i = 0; i < kKeys / 2; ++i) {
        const int kpos = k0 + 8 * (i / 4) + c + (i % 2);
        const int qpos = r + 8 * ((i / 2) % 2);
        if (kpos >= sk || (causal && kpos > qpos)) acc_s[i] = neg_inf;
      }
    }
    // online softmax in the base-2 domain: m is max(s) * sm_scale * log2 e
    float mx[2] = {neg_inf, neg_inf};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i)
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], acc_s[i]);
    float alpha[2], shift[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h] * scale_log2);
      // a row with every key so far masked keeps m = -inf: shift by 0
      // so p = 2^-inf = 0 and alpha = 0, never inf - inf
      shift[h] = m_new == neg_inf ? 0.f : m_new;
      alpha[h] = ex2(m[h] - shift[h]);
      m[h] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kKeys / 2; ++i) {
      const int h = (i / 2) % 2;
      acc_s[i] = ex2(fmaf(acc_s[i], scale_log2, -shift[h]));
      sum[h] += acc_s[i];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_o[i] *= alpha[(i / 2) % 2];

    // P in bf16: the accumulator of keys 16 kb .. 16 kb + 15 is the A
    // fragment of the kb-th k16 step
    uint32_t p[kKeys / 16][4];
#pragma unroll
    for (int kb = 0; kb < kKeys / 16; ++kb) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        p[kb][x] = pack_bf16(acc_s[8 * kb + 2 * x], acc_s[8 * kb + 2 * x + 1]);
    }
    fence_regs(acc_o);
    wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kKeys / 16; ++kb) {
      // V rows 16 kb ..: MN-major, atoms of kAtomCols columns kKeys * kSw
      // bytes apart (LBO), 8-key groups 8 * kSw bytes apart (SBO)
      const uint64_t db = smem_desc(s_v + 16 * kb * kSw, kKeys * kSw,
                                    8 * kSw, T::kLayout);
      Wgmma<D>::rs(acc_o, p[kb], db, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_o);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_empty(s));   // this warp is done with s
  }

  // l is this thread's share of the row sum: add the row's 4 lanes
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r + 8 * h;
    if (row >= sq) continue;
    // the row's log-sum-exp, natural log: m is in the base-2 domain
    if (lse != nullptr && lane % 4 == 0)
      lse[(size_t)bh * sq + row] = (m[h] + log2f(l[h])) * kLn2;
    __nv_bfloat16* orow = o + ((size_t)bh * sq + row) * D + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(orow + 8 * j) =
          pack_bf16(acc_o[4 * j + 2 * h] / l[h],
                    acc_o[4 * j + 2 * h + 1] / l[h]);
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

// A 3-D map over (D, rows, heads) of bf16, boxes of (cols, box_rows, 1):
// a box that runs past a head's last row reads zeros, not the next head.
template <int D>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int heads,
                int box_rows) {
  using T = Tiles<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                 (cuuint64_t)rows * D * 2};  // bytes
  const cuuint32_t box[3] = {(cuuint32_t)T::kAtomCols, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      T::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : (T::kSwizzle == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                              : CU_TENSOR_MAP_SWIZZLE_32B);
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box,
                        elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int batch, int n_heads, int group, int sq, int sk,
                float sm_scale, int causal, void* stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap map_q, map_k, map_v;
  const int n_kv = batch * (n_heads / group);
  if (!tensor_map<D>(&map_q, q, sq, batch * n_heads, kRows) ||
      !tensor_map<D>(&map_k, k, sk, n_kv, kKeys) ||
      !tensor_map<D>(&map_v, v, sk, n_kv, kKeys))
    return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tiles<D>::kSmem);
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((unsigned)(batch * n_heads),
                  (unsigned)((sq + kRows - 1) / kRows));
  flash_wgmma_kernel<D><<<grid, kTcThreads, Tiles<D>::kSmem,
                          (cudaStream_t)stream>>>(
      map_q, map_k, map_v, (__nv_bfloat16*)o, (float*)lse, n_heads, group,
      sq, sk, sm_scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const void*, const void*, const void*, void*, void*,
                         int, int, int, int, int, float, int, void*);

Launcher launcher(int head_dim, bool bf16) {
  switch (head_dim) {
    case 16: return bf16 ? launch_bf16<16> : launch_f32<16>;
    case 32: return bf16 ? launch_bf16<32> : launch_f32<32>;
    case 64: return bf16 ? launch_bf16<64> : launch_f32<64>;
    case 128: return bf16 ? launch_bf16<128> : launch_f32<128>;
    default: return nullptr;
  }
}

// ------------------------------ backward ------------------------------
//
// dq, dk and dv of the forward's function (FlashAttention-2's backward),
// from q, k, v, the forward's o and its row log-sum-exp lse (fp32,
// natural log), and do:
//
//   P = exp(sm_scale S - lse), S = Q K^T     dV = P^T dO
//   dP = dO V^T     dS = P (dP - delta), delta = rowsum(dO o)
//   dQ = sm_scale dS K                       dK = sm_scale dS^T Q
//
// Three launches, no atomics, every sum in a fixed order, so two calls
// and every graph replay give the same bits (dq sums over key tiles, dk
// and dv over query tiles and a KV head's G query heads; atomics would
// add them in whatever order the blocks ran):
//
//   1. the query pass, a block per (b, h, 128-query tile): delta and
//      lse log2(e) of its rows (written out for pass 2, 64 rows of each
//      side by side per 64-row tile, rows past Sq as lse = inf and
//      delta = 0), then over the key tiles the causal mask keeps, S and
//      dP again, dS, and dQ += dS K; dq is written once.
//   2. the key pass, a block per (b, h, 128-key tile): over the query
//      tiles the mask keeps, S^T and dP^T again, dV += P^T dO and
//      dK += dS^T Q; this query head's share of dk and dv goes to an fp32
//      workspace (B, H, Sk, D) each.  A block per query head, not per KV
//      head, fills the card: at yi-6b's S = 2048 a KV head's 16 key
//      blocks make 4 * 16 = 64 blocks for 132 SMs, its query heads' 512.
//   3. the group sum: dk and dv of each KV head are the sum of its G
//      query heads' shares, g = 0 .. G-1 in order, in the inputs' dtype.
//
// What bounds it: seven products over the pairs the mask keeps (five
// distinct, 2.5x the forward's FLOPs; the query pass computes S and dP
// again rather than accumulating dq across blocks), against q, k, v, o,
// do read once and dq, dk, dv written once: at yi-6b's layout ~1,100
// FLOP per byte, so operations bound it, as the forward.
//
// bf16: every product on wgmma, fed by TMA through the forward's 3-D maps
// (64-row boxes), in FlashAttention-3's layout for Hopper:
//
//   * 384 threads a block: two consumer warpgroups, each owning 64 of the
//     block's 128 fixed rows (wgmma's M), and a producer warpgroup whose
//     one elected thread issues every load.  The producer loads the
//     block's two fixed tiles (K and V in the key pass, Q and dO in the
//     query pass, 128 rows each) once, then streams the other two 64 rows
//     at a time into a 3-stage ring with full and empty mbarriers.  Both
//     consumers read every streamed tile: one load feeds twice the
//     products of a 64-row block.  In the key pass a stage also carries
//     its 64 rows' lse log2(e) and delta (one 512-byte cp.async.bulk from
//     pass 1's copy), which replace per-element loads from global memory.
//   * setmaxnreg: the producer gives its registers up (24 a thread) and
//     the consumers take them (240): 128 * 24 + 256 * 240 = 64,512, the
//     block's allocation at launch (384 * 168), one block an SM.  The key
//     pass's consumer holds dK and dV (128 fp32 at D = 128), S^T and dP^T
//     (32 each) and a 16-register bf16 fragment.  ptxas gives the
//     consumers the 240 only if their code cannot trap (see mbar_spin),
//     and overlaps products only while nothing but wgmma writes an
//     accumulator with a product in flight and no product issues on a
//     path of its own; else it serialises every wgmma of the kernel.
//   * overlap: a software pipeline inside each warpgroup, in the form
//     that needs no extra accumulator.  Within a tile both score
//     products issue back to back and the warpgroup waits for the first
//     alone (wait_group 1): the exponentials of P^T (P) run under dP^T
//     (dP); the last product, dK += dS^T Q (dQ += dS K), stays in flight
//     into the next tile, whose score products queue behind it, and the
//     stage it reads is released only then.  The key pass waits for
//     dV += P^T dO before dS^T's arithmetic: running dV under it keeps
//     P^T's fragment alive beside dS^T's, past 240 registers.  Measured on
//     an H100, a deeper pipeline, the next tile's S issued before this
//     tile's dS into a second accumulator, left the query pass as fast
//     as this (the key pass has no room for it: 32 more registers), and
//     a ping-pong of the two warpgroups on named barriers left both
//     passes as fast.
//   * score products m64n64k16, both operands K-major in shared memory;
//     P^T, dS^T and dS are rounded to bf16 in registers, where the
//     accumulator is wgmma's A-fragment layout, and multiply dO, Q or K
//     read MN-major (the transpose bit), as the forward's P V.  P itself
//     stays fp32 for dS.  Only tiles on the causal diagonal or (query
//     pass) at a ragged key edge are masked; a warpgroup skips the tiles
//     wholly masked for its own 64 rows, and those past the ragged edge.
//
// fp32: on the CUDA cores, IEEE fp32 FMAs, the same three passes: 4
// threads a row as the forward, 32-row tiles of the streamed pair staged
// in shared memory, and a row's two dot products (S and dP) summed over
// its 4 lanes by shuffles.

constexpr int kBwdRows = 64;                   // a warpgroup's rows, a
                                               // streamed tile's rows
constexpr int kBwdBlock = 128;                 // a block's fixed rows
constexpr int kBwdConsumers = kBwdBlock / kBwdRows;   // warpgroups
constexpr int kBwdConsumerThreads = 128 * kBwdConsumers;
constexpr int kBwdThreads = kBwdConsumerThreads + 128;  // + the producer
constexpr int kBwdStages = 3;
// setmaxnreg moves registers within the block's allocation at launch,
// kBwdThreads * 168 (the most __launch_bounds__(kBwdThreads, 1) allows a
// thread, in steps of 8): the producer warpgroup gives up what the two
// consumers take
constexpr int kLaunchRegs = 65536 / kBwdThreads / 8 * 8;
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
static_assert(128 * kProducerRegs + kBwdConsumerThreads * kConsumerRegs <=
                  kBwdThreads * kLaunchRegs,
              "the register budget of one block an SM");

template <int D>
struct BwdTiles {
  static constexpr int kTile = kBwdRows * D * 2;          // streamed, bf16
  static constexpr int kFixed = kBwdBlock * D * 2;        // fixed, bf16
  static constexpr int kStage = 2 * kTile;
  // the two fixed tiles, then the ring's stages
  static constexpr int kData = 2 * kFixed + kBwdStages * kStage;
  // 64 rows' lse log2(e), then their delta: a key-pass stage's, or a
  // query-pass warpgroup's own
  static constexpr int kStat = 2 * kBwdRows * 4;
  static constexpr int kStats =
      kStat * (kBwdStages > kBwdConsumers ? kBwdStages : kBwdConsumers);
  static constexpr int kBars = 1 + 2 * kBwdStages;        // fixed, full, empty
  // 1 KB to align the data to the swizzle's period
  static constexpr int kSmem = 1024 + kData + kStats + 8 * kBars;
};

// Rows past Sq padded to a whole query block: the length of a head's run
// of lse log2(e) and delta in pass 1's copy (two floats a row).
__device__ __forceinline__ int bwd_padded(int sq) {
  return (sq + kBwdBlock - 1) / kBwdBlock * kBwdBlock;
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// One bulk copy of ``bytes`` (a multiple of 16, both ends 16-byte
// aligned) from global memory into shared memory, completing on ``bar``.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The consumers' wait: no watchdog of their own.  A __trap in their code
// makes ptxas allocate their registers within the launch's 168 a thread,
// not setmaxnreg's 240: the key pass then spills and every wgmma of both
// passes is serialised.  The producer's end-of-ring wait (bwd_produce)
// keeps a lost barrier from hanging the card.
__device__ __forceinline__ void mbar_spin(uint32_t bar, int parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// Thread 0 sets up the fixed tiles' barrier and the ring's full (one
// arrival: the producer's, plus the bytes) and empty (the consumer warps)
// barriers.
__device__ __forceinline__ void bwd_init_bars(uint32_t bar_f) {
  if (threadIdx.x == 0) {
    mbar_init(bar_f, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(bar_f + 8 * (1 + s), 1);
      mbar_init(bar_f + 8 * (1 + kBwdStages + s), 4 * kBwdConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer (one thread): the fixed tiles f1 and f2, 128 rows from
// f_row of head f_head, then n tiles of the pair s1, s2 from row t0 * 64
// of head s_head into the ring, each with its rows' lse log2(e) and delta
// from ``stats`` (the head's run in pass 1's copy) where that is given.
// Nothing is loaded when n = 0.  It then waits (watchdog and all) until
// the consumers have released the ring's last tiles: every consumer wait
// precedes one of those releases, so a lost barrier anywhere traps here.
template <int D>
__device__ __forceinline__ void bwd_produce(
    const CUtensorMap* f1, const CUtensorMap* f2, int f_row, int f_head,
    const CUtensorMap* s1, const CUtensorMap* s2, int s_head, int t0, int n,
    const float* stats, uint32_t base) {
  using T = Tiles<D>;
  using B = BwdTiles<D>;
  if (n == 0) return;
  const uint32_t bar_f = base + B::kData + B::kStats;
  mbar_expect_tx(bar_f, 2 * B::kFixed);
  for (int a = 0; a < T::kAtoms; ++a) {
    for (int half = 0; half < kBwdConsumers; ++half) {
      const uint32_t off = (a * kBwdBlock + half * kBwdRows) * T::kSwizzle;
      const int row = f_row + half * kBwdRows;
      tma_load(f1, base + off, bar_f, a * T::kAtomCols, row, f_head);
      tma_load(f2, base + B::kFixed + off, bar_f, a * T::kAtomCols, row,
               f_head);
    }
  }
  for (int t = 0; t < n; ++t) {
    const int s = t % kBwdStages;
    const uint32_t full = bar_f + 8 * (1 + s);
    if (t >= kBwdStages)
      mbar_wait(bar_f + 8 * (1 + kBwdStages + s), (t / kBwdStages - 1) & 1);
    mbar_expect_tx(full, B::kStage + (stats ? B::kStat : 0));
    const uint32_t dst = base + 2 * B::kFixed + s * B::kStage;
    const int row = (t0 + t) * kBwdRows;
    for (int a = 0; a < T::kAtoms; ++a) {
      const uint32_t off = a * kBwdRows * T::kSwizzle;
      tma_load(s1, dst + off, full, a * T::kAtomCols, row, s_head);
      tma_load(s2, dst + B::kTile + off, full, a * T::kAtomCols, row,
               s_head);
    }
    if (stats)
      bulk_load(base + B::kData + s * B::kStat, stats + 2 * row, B::kStat,
                full);
  }
  for (int t = n > kBwdStages ? n - kBwdStages : 0; t < n; ++t)
    mbar_wait(bar_f + 8 * (1 + kBwdStages + t % kBwdStages),
              (t / kBwdStages) & 1);
}

// Descriptor of a tile of ``Rows`` rows as a K-major operand at k16 step
// kk (add 64 w rows' bytes to the tile for warpgroup w's rows).
template <int D, int Rows>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  using T = Tiles<D>;
  return smem_desc(tile + (kk / T::kStepsPerAtom) * Rows * T::kSwizzle +
                       32 * (kk % T::kStepsPerAtom),
                   16, 8 * T::kSwizzle, T::kLayout);
}

// Descriptor of a streamed 64-row tile as an MN-major B operand (its rows
// are the product's K, its D columns the N) at k16 step kb: rows 16 kb ..
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kb) {
  using T = Tiles<D>;
  return smem_desc(tile + 16 * kb * T::kSwizzle, kBwdRows * T::kSwizzle,
                   8 * T::kSwizzle, T::kLayout);
}

// An m64n64 accumulator as the bf16 A fragments of the four k16 steps
// over its 64 columns.
__device__ __forceinline__ void to_frags(const float (&acc)[32],
                                         uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kb = 0; kb < 4; ++kb) {
#pragma unroll
    for (int x = 0; x < 4; ++x)
      f[kb][x] = pack_bf16(acc[8 * kb + 2 * x], acc[8 * kb + 2 * x + 1]);
  }
}

// A consumer warp is done with ring stage s.
__device__ __forceinline__ void bwd_release(uint32_t bar_f, int s) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bar_f + 8 * (1 + kBwdStages + s));
}

__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ stats,
                   __nv_bfloat16* __restrict__ dq, int n_heads, int group,
                   int sq, int sk, float scale_log2, float sm_scale,
                   int causal) {
  using T = Tiles<D>;
  using B = BwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  float* const stats_s = reinterpret_cast<float*>(
      smem_raw + (base + B::kData - smem_u32(smem_raw)));
  const uint32_t bar_f = base + B::kData + B::kStats;
  const uint32_t s_q = base, s_do = base + B::kFixed;

  const int bh = blockIdx.x;                         // b * n_heads + h
  // the heaviest (last) query blocks first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBwdBlock;
  const int b = bh / n_heads;
  const int bkv = b * (n_heads / group) + (bh - b * n_heads) / group;
  const int k_end = causal ? min(sk, q0 + kBwdBlock) : sk;
  const int n = (k_end + kBwdRows - 1) / kBwdRows;
  bwd_init_bars(bar_f);
  if (threadIdx.x >= kBwdConsumerThreads) {
    producer_regs();
    if (threadIdx.x == kBwdConsumerThreads)
      bwd_produce<D>(&map_q, &map_do, q0, bh, &map_k, &map_v, bkv, 0, n,
                     nullptr, base);
  } else {
    consumer_regs();
    const int w = threadIdx.x / 128;               // the warpgroup
    const int qw = q0 + kBwdRows * w;              // its first row
    float* const lse_s = stats_s + 2 * kBwdRows * w;
    float* const dl_s = lse_s + kBwdRows;

    // delta and lse log2(e) of the warpgroup's rows, two threads a row,
    // D / 2 columns each; rows past sq get lse = inf (P = 0), delta = 0
    {
      const int row = threadIdx.x % 128 / 2, half = threadIdx.x % 2;
      const int qpos = qw + row;
      float sum = 0.f;
      if (qpos < sq) {
        const size_t off = ((size_t)bh * sq + qpos) * D + half * (D / 2);
#pragma unroll
        for (int x = 0; x < D / 16; ++x) {
          const uint4 ov = *reinterpret_cast<const uint4*>(o + off + 8 * x);
          const uint4 gv =
              *reinterpret_cast<const uint4*>(dout + off + 8 * x);
          const auto* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const auto* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const float2 a = __bfloat1622float2(op[y]);
            const float2 g = __bfloat1622float2(gp[y]);
            sum = fmaf(a.x, g.x, sum);
            sum = fmaf(a.y, g.y, sum);
          }
        }
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      float* const out = stats + 2 * ((size_t)bh * bwd_padded(sq) + qw);
      if (half == 0) {
        dl_s[row] = sum;
        out[kBwdRows + row] = sum;
      } else {
        const float l2 = qpos < sq ? lse[(size_t)bh * sq + qpos] * kLog2e
                                   : __int_as_float(0x7f800000);
        lse_s[row] = l2;
        out[row] = l2;
      }
    }
    // the warpgroup's own barrier (id 1 + w)
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");

    // this thread's rows r and r + 8 (accumulator layout as the forward's)
    const int lane = threadIdx.x % 32;
    const int r = 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const int c = 2 * (lane % 4);
    const float neg_inf = __int_as_float(0xff800000);
    float ll[2], dl[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ll[h] = lse_s[r + 8 * h];
      dl[h] = dl_s[r + 8 * h];
    }
    // the key tiles its rows need: under the causal mask none past its
    // last row, none at all when every row is past sq
    const int n_w = qw >= sq ? 0
                    : causal ? (min(sk, qw + kBwdRows) + kBwdRows - 1) /
                                   kBwdRows
                             : n;
    const uint32_t rows = kBwdRows * w * T::kSwizzle;   // its fixed rows
    float acc_dq[D / 2], acc_s[32], acc_dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_s[i] = acc_dp[i] = 0.f;
    uint32_t frag[4][4];

    mbar_spin(bar_f, 0);
    for (int t = 0; t < n_w; ++t) {
      const int s = t % kBwdStages;
      const int k0 = t * kBwdRows;
      const uint32_t s_k = base + 2 * B::kFixed + s * B::kStage;
      const uint32_t s_v = s_k + B::kTile;
      mbar_spin(bar_f + 8 * (1 + s), (t / kBwdStages) & 1);
      __syncwarp();

      // S = Q K^T, then dP = dO V^T, in two groups
      fence_regs(acc_s);
      fence_regs(acc_dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(acc_s, kmajor<D, kBwdBlock>(s_q + rows, kk),
                      kmajor<D, kBwdRows>(s_k, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(acc_dp, kmajor<D, kBwdBlock>(s_do + rows, kk),
                      kmajor<D, kBwdRows>(s_v, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();             // S, and the last tile's dQ, are done
      fence_regs(acc_s);
      fence_regs(acc_dq);
      if (t > 0) bwd_release(bar_f, (t - 1) % kBwdStages);

      // P = 2^(S sm_scale log2 e - lse log2 e), under dP's product; the
      // mask selects the exponent (2^-inf = 0), so that no branch goes
      // round the exponential
      const bool edge =
          k0 + kBwdRows > sk || (causal && k0 + kBwdRows - 1 > qw);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i / 2) % 2;
        const int kpos = k0 + 8 * (i / 4) + c + (i % 2);
        const int qpos = qw + r + 8 * h;
        const bool valid =
            !edge || (kpos < sk && !(causal && kpos > qpos));
        const float x = fmaf(acc_s[i], scale_log2, -ll[h]);
        acc_s[i] = ex2(valid ? x : neg_inf);
      }
      wgmma_wait<0>();
      fence_regs(acc_dp);

      // dS = P (dP - delta); dQ += dS K (K read MN-major), left in flight
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc_dp[i] = acc_s[i] * (acc_dp[i] - dl[(i / 2) % 2]);
      to_frags(acc_dp, frag);
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        Wgmma<D>::rs(acc_dq, frag[kb], mnmajor<D>(s_k, kb), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(acc_dq);
    if (n_w > 0) bwd_release(bar_f, (n_w - 1) % kBwdStages);
    for (int t = n_w; t < n; ++t) {   // no row of this warpgroup needs it
      mbar_spin(bar_f + 8 * (1 + t % kBwdStages), (t / kBwdStages) & 1);
      bwd_release(bar_f, t % kBwdStages);
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = qw + r + 8 * h;
      if (row >= sq) continue;
      __nv_bfloat16* out = dq + ((size_t)bh * sq + row) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(acc_dq[4 * j + 2 * h] * sm_scale,
                      acc_dq[4 * j + 2 * h + 1] * sm_scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ stats,
                     float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                     int n_heads, int group, int sq, int sk,
                     float scale_log2, float sm_scale, int causal) {
  using T = Tiles<D>;
  using B = BwdTiles<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const float* const stats_s = reinterpret_cast<const float*>(
      smem_raw + (base + B::kData - smem_u32(smem_raw)));
  const uint32_t bar_f = base + B::kData + B::kStats;
  const uint32_t s_k = base, s_v = base + B::kFixed;

  const int bh = blockIdx.x;                         // b * n_heads + h
  const int k0 = blockIdx.y * kBwdBlock;             // heaviest first
  const int b = bh / n_heads;
  const int bkv = b * (n_heads / group) + (bh - b * n_heads) / group;
  // query tiles wholly before key k0 are in its causal past: masked
  const int t0 = causal ? k0 / kBwdRows : 0;
  const int n = max(0, (sq + kBwdRows - 1) / kBwdRows - t0);
  bwd_init_bars(bar_f);
  if (threadIdx.x >= kBwdConsumerThreads) {
    producer_regs();
    if (threadIdx.x == kBwdConsumerThreads)
      bwd_produce<D>(&map_k, &map_v, k0, bkv, &map_q, &map_do, bh, t0, n,
                     stats + 2 * (size_t)bh * bwd_padded(sq), base);
  } else {
    consumer_regs();
    const int w = threadIdx.x / 128;               // the warpgroup
    const int kw = k0 + kBwdRows * w;              // its first key
    // this thread's key rows r and r + 8, query columns 8 j + c + e
    const int lane = threadIdx.x % 32;
    const int r = 16 * (threadIdx.x % 128 / 32) + lane / 4;
    const int c = 2 * (lane % 4);
    const uint32_t rows = kBwdRows * w * T::kSwizzle;   // its fixed rows
    const float neg_inf = __int_as_float(0xff800000);
    // ring tiles before t_begin are wholly in its keys' causal past (the
    // first, for the second warpgroup), all of them when every key is
    // past sk
    const int t_begin = kw >= sk ? n : min(n, causal ? w : 0);
    float acc_dk[D / 2], acc_dv[D / 2], acc_s[32], acc_dp[32];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_s[i] = acc_dp[i] = 0.f;
    uint32_t frag[4][4];

    if (n > 0) mbar_spin(bar_f, 0);
    int prev = -1;                 // the stage dK's last product reads
    for (int t = 0; t < n; ++t) {
      const int s = t % kBwdStages;
      const int q0 = (t0 + t) * kBwdRows;
      const uint32_t s_q = base + 2 * B::kFixed + s * B::kStage;
      const uint32_t s_do = s_q + B::kTile;
      const float* const st = stats_s + 2 * kBwdRows * s;
      mbar_spin(bar_f + 8 * (1 + s), (t / kBwdStages) & 1);
      __syncwarp();
      if (t < t_begin) {           // no key of this warpgroup sees it
        bwd_release(bar_f, s);
        continue;
      }

      // S^T = K Q^T, then dP^T = V dO^T, in two groups
      fence_regs(acc_s);
      fence_regs(acc_dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(acc_s, kmajor<D, kBwdBlock>(s_k + rows, kk),
                      kmajor<D, kBwdRows>(s_q, kk), kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<64>::ss(acc_dp, kmajor<D, kBwdBlock>(s_v + rows, kk),
                      kmajor<D, kBwdRows>(s_do, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<1>();     // S^T, and the last tile's dK, are done
      fence_regs(acc_s);
      fence_regs(acc_dk);
      if (prev >= 0) bwd_release(bar_f, prev);

      // P^T, fp32, under dP^T's product: zero where masked (the mask
      // selects the exponent, 2^-inf = 0, so that no branch goes round
      // the exponential) and for a row past sq (lse = inf)
      const bool diag = causal && kw + kBwdRows - 1 > q0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(st + 8 * j + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qpos = q0 + 8 * j + c + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const bool valid = !diag || qpos >= kw + r + 8 * h;
            const float x = fmaf(acc_s[i], scale_log2, -(e ? l2.y : l2.x));
            acc_s[i] = ex2(valid ? x : neg_inf);
          }
        }
      }
      to_frags(acc_s, frag);

      // dV += P^T dO (dO read MN-major)
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        Wgmma<D>::rs(acc_dv, frag[kb], mnmajor<D>(s_do, kb), 1);
      wgmma_commit();
      wgmma_wait<0>();             // dP^T and dV are done
      fence_regs(acc_dp);
      fence_regs(acc_dv);

      // dS^T = P^T (dP^T - delta)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(st + kBwdRows + 8 * j + c);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            acc_dp[i] = acc_s[i] * (acc_dp[i] - (e ? d2.y : d2.x));
          }
        }
      }
      to_frags(acc_dp, frag);

      // dK += dS^T Q (Q read MN-major), left in flight
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        Wgmma<D>::rs(acc_dk, frag[kb], mnmajor<D>(s_q, kb), 1);
      wgmma_commit();
      prev = s;
    }
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    if (prev >= 0) bwd_release(bar_f, prev);

    // this query head's share of dK (times sm_scale) and dV
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kpos = kw + r + 8 * h;
      if (kpos >= sk) continue;
      const size_t off = ((size_t)bh * sk + kpos) * D + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<float2*>(dk_ws + off + 8 * j) =
            make_float2(acc_dk[4 * j + 2 * h] * sm_scale,
                        acc_dk[4 * j + 2 * h + 1] * sm_scale);
        *reinterpret_cast<float2*>(dv_ws + off + 8 * j) =
            make_float2(acc_dv[4 * j + 2 * h], acc_dv[4 * j + 2 * h + 1]);
      }
    }
  }
}

// fp32, CUDA cores: the query pass, a block per (b, h, 64-query tile) on
// grid (x, y), 4 threads a row as the forward.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ o,
                 const float* __restrict__ dout,
                 const float* __restrict__ lse, float* __restrict__ delta,
                 float* __restrict__ dq, int n_heads, int group, int sq,
                 int sk, float sm_scale, int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * kBlockQ;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const size_t kv_base =
      ((size_t)b * (n_heads / group) + h / group) * (size_t)sk * D;
  const float* kp = k + kv_base;
  const float* vp = v + kv_base;

  const int t = threadIdx.x;
  const int row = t / kRowThreads;
  const int part = t % kRowThreads;
  const int qpos = q0 + row;
  const bool active = qpos < sq;
  const size_t q_off = ((size_t)bh * sq + (active ? qpos : 0)) * D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 qr[kChunks], gr[kChunks], acc[kChunks];
  float dl = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = 4 * (part + kRowThreads * c);
    qr[c] = active ? load4(q + q_off + col) : zero;
    gr[c] = active ? load4(dout + q_off + col) : zero;
    const float4 oo = active ? load4(o + q_off + col) : zero;
    dl = fmaf(gr[c].x, oo.x, dl);
    dl = fmaf(gr[c].y, oo.y, dl);
    dl = fmaf(gr[c].z, oo.z, dl);
    dl = fmaf(gr[c].w, oo.w, dl);
    acc[c] = zero;
  }
  dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  dl += __shfl_xor_sync(0xffffffffu, dl, 2);
  if (active && part == 0) delta[(size_t)bh * sq + qpos] = dl;
  const float lr = active ? lse[(size_t)bh * sq + qpos] : 0.f;

  const int q_last = min(q0 + kBlockQ, sq) - 1;
  const int k_end = causal ? min(sk, q_last + 1) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();
    for (int i = t; i < kBlockK * D / 4; i += kThreads) {
      const int j = (4 * i) / D;
      const int col = 4 * i - j * D;
      const bool in = k0 + j < sk;
      const size_t off = (size_t)(k0 + j) * D + col;
      store4(ks + 4 * i, in ? load4(kp + off) : zero);
      store4(vs + 4 * i, in ? load4(vp + off) : zero);
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float* kr = ks + j * D;
      const float* vr = vs + j * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * (part + kRowThreads * c);
        const float4 kk = load4(kr + col);
        const float4 vv = load4(vr + col);
        s = fmaf(qr[c].x, kk.x, s);
        s = fmaf(qr[c].y, kk.y, s);
        s = fmaf(qr[c].z, kk.z, s);
        s = fmaf(qr[c].w, kk.w, s);
        dp = fmaf(gr[c].x, vv.x, dp);
        dp = fmaf(gr[c].y, vv.y, dp);
        dp = fmaf(gr[c].z, vv.z, dp);
        dp = fmaf(gr[c].w, vv.w, dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int kpos = k0 + j;
      const bool valid = kpos < sk && (!causal || qpos >= kpos);
      const float p = valid ? expf(s * sm_scale - lr) : 0.f;
      const float ds = p * (dp - dl);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = load4(kr + 4 * (part + kRowThreads * c));
        acc[c].x = fmaf(ds, kk.x, acc[c].x);
        acc[c].y = fmaf(ds, kk.y, acc[c].y);
        acc[c].z = fmaf(ds, kk.z, acc[c].z);
        acc[c].w = fmaf(ds, kk.w, acc[c].w);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      store4(dq + q_off + 4 * (part + kRowThreads * c),
             make_float4(acc[c].x * sm_scale, acc[c].y * sm_scale,
                         acc[c].z * sm_scale, acc[c].w * sm_scale));
  }
}

// fp32, CUDA cores: the key pass, a block per (b, h, 64-key tile), 4
// threads a key row; Q and dO rows (with their lse and delta) staged 32
// at a time.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_f32(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v,
                   const float* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   float* __restrict__ dk_ws, float* __restrict__ dv_ws,
                   int n_heads, int group, int sq, int sk, float sm_scale,
                   int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);
  __shared__ __align__(16) float qs[kBlockK * D];
  __shared__ __align__(16) float gs[kBlockK * D];
  __shared__ float ls[kBlockK], dls[kBlockK];

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBlockQ;
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const size_t kv_base =
      ((size_t)b * (n_heads / group) + h / group) * (size_t)sk * D;
  const float* qp = q + (size_t)bh * sq * D;
  const float* gp = dout + (size_t)bh * sq * D;

  const int t = threadIdx.x;
  const int row = t / kRowThreads;
  const int part = t % kRowThreads;
  const int kpos = k0 + row;
  const bool active = kpos < sk;
  const size_t k_off = kv_base + (size_t)(active ? kpos : 0) * D;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  float4 kr[kChunks], vr[kChunks], adk[kChunks], adv[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int col = 4 * (part + kRowThreads * c);
    kr[c] = active ? load4(k + k_off + col) : zero;
    vr[c] = active ? load4(v + k_off + col) : zero;
    adk[c] = adv[c] = zero;
  }

  // queries before the block's first key are all in its causal past
  const int i_begin = causal ? k0 - k0 % kBlockK : 0;
  for (int i0 = i_begin; i0 < sq; i0 += kBlockK) {
    __syncthreads();
    for (int i = t; i < kBlockK * D / 4; i += kThreads) {
      const int j = (4 * i) / D;
      const int col = 4 * i - j * D;
      const bool in = i0 + j < sq;
      const size_t off = (size_t)(i0 + j) * D + col;
      store4(qs + 4 * i, in ? load4(qp + off) : zero);
      store4(gs + 4 * i, in ? load4(gp + off) : zero);
    }
    if (t < kBlockK) {
      const bool in = i0 + t < sq;
      ls[t] = in ? lse[(size_t)bh * sq + i0 + t] : 0.f;
      dls[t] = in ? delta[(size_t)bh * sq + i0 + t] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlockK; ++j) {
      const float* qrow = qs + j * D;
      const float* grow = gs + j * D;
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * (part + kRowThreads * c);
        const float4 qq = load4(qrow + col);
        const float4 gg = load4(grow + col);
        s = fmaf(kr[c].x, qq.x, s);
        s = fmaf(kr[c].y, qq.y, s);
        s = fmaf(kr[c].z, qq.z, s);
        s = fmaf(kr[c].w, qq.w, s);
        dp = fmaf(vr[c].x, gg.x, dp);
        dp = fmaf(vr[c].y, gg.y, dp);
        dp = fmaf(vr[c].z, gg.z, dp);
        dp = fmaf(vr[c].w, gg.w, dp);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      dp += __shfl_xor_sync(0xffffffffu, dp, 1);
      dp += __shfl_xor_sync(0xffffffffu, dp, 2);
      const int qpos = i0 + j;
      const bool valid = qpos < sq && active && (!causal || qpos >= kpos);
      const float p = valid ? expf(s * sm_scale - ls[j]) : 0.f;
      const float ds = p * (dp - dls[j]);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int col = 4 * (part + kRowThreads * c);
        const float4 qq = load4(qrow + col);
        const float4 gg = load4(grow + col);
        adv[c].x = fmaf(p, gg.x, adv[c].x);
        adv[c].y = fmaf(p, gg.y, adv[c].y);
        adv[c].z = fmaf(p, gg.z, adv[c].z);
        adv[c].w = fmaf(p, gg.w, adv[c].w);
        adk[c].x = fmaf(ds, qq.x, adk[c].x);
        adk[c].y = fmaf(ds, qq.y, adk[c].y);
        adk[c].z = fmaf(ds, qq.z, adk[c].z);
        adk[c].w = fmaf(ds, qq.w, adk[c].w);
      }
    }
  }
  if (active) {
    const size_t off = ((size_t)bh * sk + kpos) * D;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int col = 4 * (part + kRowThreads * c);
      store4(dk_ws + off + col,
             make_float4(adk[c].x * sm_scale, adk[c].y * sm_scale,
                         adk[c].z * sm_scale, adk[c].w * sm_scale));
      store4(dv_ws + off + col, adv[c]);
    }
  }
}

__device__ __forceinline__ void store4_as(float* p, float4 x) {
  store4(p, x);
}
__device__ __forceinline__ void store4_as(__nv_bfloat16* p, float4 x) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
}

// dk and dv of each KV head: its G query heads' shares summed in order,
// 4 elements a thread, in the output's dtype.
template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_group_sum(const float* __restrict__ dk_ws,
                    const float* __restrict__ dv_ws, T* __restrict__ dk,
                    T* __restrict__ dv, long long n4, long long head4,
                    int group) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n4; i += (long long)gridDim.x * blockDim.x) {
    const long long bkv = i / head4;
    const long long src = bkv * group * head4 + (i - bkv * head4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), w = a;
    for (int g = 0; g < group; ++g) {
      const float4 x = load4(dk_ws + 4 * (src + g * head4));
      const float4 y = load4(dv_ws + 4 * (src + g * head4));
      a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
      w.x += y.x; w.y += y.y; w.z += y.z; w.w += y.w;
    }
    store4_as(dk + 4 * i, a);
    store4_as(dv + 4 * i, w);
  }
}

template <typename T>
int launch_group_sum(const float* ws, void* dk, void* dv, int batch,
                     int n_heads, int group, int sk, int d,
                     cudaStream_t stream) {
  const long long per = (long long)batch * n_heads * sk * d;
  const long long n4 = per / group / 4;
  const long long blocks = min((n4 + 255) / 256, 132ll * 16);
  flash_bwd_group_sum<T><<<(unsigned)blocks, 256, 0, stream>>>(
      ws, ws + per, (T*)dk, (T*)dv, n4, (long long)sk * d / 4, group);
  return (int)cudaGetLastError();
}

template <int D>
int bwd_f32(const void* q, const void* k, const void* v, const void* o,
            const void* lse, const void* dout, void* dq, void* dk, void* dv,
            void* delta, void* ws, int batch, int n_heads, int group, int sq,
            int sk, float sm_scale, int causal, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned rows = (unsigned)(batch * n_heads);
  const size_t per = (size_t)batch * n_heads * sk * D;
  flash_bwd_dq_f32<D><<<dim3(rows, (sq + kBlockQ - 1) / kBlockQ), kThreads,
                        0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)o,
      (const float*)dout, (const float*)lse, (float*)delta, (float*)dq,
      n_heads, group, sq, sk, sm_scale, causal);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  flash_bwd_dkdv_f32<D><<<dim3(rows, (sk + kBlockQ - 1) / kBlockQ),
                          kThreads, 0, st>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      (const float*)lse, (const float*)delta, (float*)ws,
      (float*)ws + per, n_heads, group, sq, sk, sm_scale, causal);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  return launch_group_sum<float>((const float*)ws, dk, dv, batch, n_heads,
                                 group, sk, D, st);
}

// cudaFuncSetAttribute of a kernel's dynamic shared memory, once per
// kernel and device: ``done`` holds a bit per device already set.  Two
// threads that race both set it, which is harmless.
template <typename Kernel>
cudaError_t smem_once(Kernel kernel, int bytes,
                      std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  rc = cudaFuncSetAttribute(kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            bytes);
  if (rc == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return rc;
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             void* stats, void* ws, int batch, int n_heads, int group,
             int sq, int sk, float sm_scale, int causal, void* stream) {
  using B = BwdTiles<D>;
  static std::atomic<unsigned long long> dq_set{0}, dkdv_set{0};
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  const cudaStream_t st = (cudaStream_t)stream;
  CUtensorMap map_q, map_k, map_v, map_do;
  const int n_kv = batch * (n_heads / group);
  if (!tensor_map<D>(&map_q, q, sq, batch * n_heads, kBwdRows) ||
      !tensor_map<D>(&map_do, dout, sq, batch * n_heads, kBwdRows) ||
      !tensor_map<D>(&map_k, k, sk, n_kv, kBwdRows) ||
      !tensor_map<D>(&map_v, v, sk, n_kv, kBwdRows))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = smem_once(flash_bwd_dq_wgmma<D>, B::kSmem, dq_set);
  if (rc != cudaSuccess) return (int)rc;
  rc = smem_once(flash_bwd_dkdv_wgmma<D>, B::kSmem, dkdv_set);
  if (rc != cudaSuccess) return (int)rc;
  const unsigned rows = (unsigned)(batch * n_heads);
  const size_t per = (size_t)batch * n_heads * sk * D;
  const float scale_log2 = sm_scale * kLog2e;
  flash_bwd_dq_wgmma<D><<<dim3(rows, (sq + kBwdBlock - 1) / kBwdBlock),
                          kBwdThreads, B::kSmem, st>>>(
      map_q, map_k, map_v, map_do, (const __nv_bfloat16*)o,
      (const __nv_bfloat16*)dout, (const float*)lse, (float*)stats,
      (__nv_bfloat16*)dq, n_heads, group, sq, sk, scale_log2, sm_scale,
      causal);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  flash_bwd_dkdv_wgmma<D><<<dim3(rows, (sk + kBwdBlock - 1) / kBwdBlock),
                            kBwdThreads, B::kSmem, st>>>(
      map_q, map_k, map_v, map_do, (const float*)stats, (float*)ws,
      (float*)ws + per, n_heads, group, sq, sk, scale_log2, sm_scale,
      causal);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_group_sum<__nv_bfloat16>((const float*)ws, dk, dv, batch,
                                         n_heads, group, sk, D, st);
}

// numRegs and localSizeBytes (0: nothing spilled) of the bf16 query and
// key passes, in that order, from cudaFuncGetAttributes.
template <int D>
int bwd_attributes(int* out) {
  cudaFuncAttributes a;
  cudaError_t rc = cudaFuncGetAttributes(&a, flash_bwd_dq_wgmma<D>);
  if (rc != cudaSuccess) return (int)rc;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  rc = cudaFuncGetAttributes(&a, flash_bwd_dkdv_wgmma<D>);
  if (rc != cudaSuccess) return (int)rc;
  out[2] = a.numRegs;
  out[3] = (int)a.localSizeBytes;
  return 0;
}

using BwdLauncher = int (*)(const void*, const void*, const void*,
                            const void*, const void*, const void*, void*,
                            void*, void*, void*, void*, int, int, int, int,
                            int, float, int, void*);

BwdLauncher bwd_launcher(int head_dim, bool bf16) {
  switch (head_dim) {
    case 16: return bf16 ? bwd_bf16<16> : bwd_f32<16>;
    case 32: return bf16 ? bwd_bf16<32> : bwd_f32<32>;
    case 64: return bf16 ? bwd_bf16<64> : bwd_f32<64>;
    case 128: return bf16 ? bwd_bf16<128> : bwd_f32<128>;
    default: return nullptr;
  }
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched); the
// bf16 one returns before launching on a failed cudaFuncSetAttribute, on
// cudaErrorNotSupported when the driver has no cuTensorMapEncodeTiled and
// on cudaErrorInvalidValue when a TMA map cannot be encoded.  The
// caller guarantees sq, sk > 0, head_dim in {16, 32, 64, 128}, n_heads a
// multiple of group, contiguous 16-byte-aligned tensors of one dtype.  The
// fp32 one launches once per 65535 of batch * n_heads; the bf16 one once,
// its launch failing past 65535 tiles of 128 queries (its grid y).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse,
                                   int batch, int n_heads, int group, int sq,
                                   int sk, int head_dim, float sm_scale,
                                   int causal, void* stream) {
  const Launcher fn = launcher(head_dim, false);
  return fn ? fn(q, k, v, o, lse, batch, n_heads, group, sq, sk, sm_scale,
                 causal, stream)
            : (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int batch, int n_heads, int group, int sq,
                                    int sk, int head_dim, float sm_scale,
                                    int causal, void* stream) {
  const Launcher fn = launcher(head_dim, true);
  return fn ? fn(q, k, v, o, lse, batch, n_heads, group, sq, sk, sm_scale,
                 causal, stream)
            : (int)cudaErrorInvalidValue;
}

// The backward: dq, dk, dv (the inputs' dtype) of the function above for
// the output gradient dout, from q, k, v, the forward's o and lse (fp32,
// (B, H, Sq)); delta (fp32, at least 2 * B * H * Sq' with Sq' = Sq
// rounded up to a multiple of 128: the fp32 passes use (B, H, Sq) of it,
// the bf16 ones the rows' lse log2(e) and delta) and ws (fp32,
// 2 * B * H * Sk * D) are scratch.  Three launches in order (the query
// pass, the key pass, the group sum); each returns the first nonzero
// cudaGetLastError() (or the bf16 one's set-up error, as above) and
// launches nothing after it.  The caller guarantees what the forward's
// does, dout and o contiguous as q, and at most 65535 tiles of 64
// queries or keys (the grids' y).
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* ws, int batch, int n_heads, int group, int sq, int sk,
    int head_dim, float sm_scale, int causal, void* stream) {
  const BwdLauncher fn = bwd_launcher(head_dim, false);
  return fn ? fn(q, k, v, o, lse, dout, dq, dk, dv, delta, ws, batch,
                 n_heads, group, sq, sk, sm_scale, causal, stream)
            : (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* delta, void* ws, int batch, int n_heads, int group, int sq, int sk,
    int head_dim, float sm_scale, int causal, void* stream) {
  const BwdLauncher fn = bwd_launcher(head_dim, true);
  return fn ? fn(q, k, v, o, lse, dout, dq, dk, dv, delta, ws, batch,
                 n_heads, group, sq, sk, sm_scale, causal, stream)
            : (int)cudaErrorInvalidValue;
}

// numRegs and localSizeBytes of the bf16 backward's query pass, then its
// key pass, for head_dim, into out[0..3]; cudaErrorInvalidValue for a
// head dim without a kernel.
extern "C" int flash_attention_bwd_attributes(int head_dim, int* out) {
  switch (head_dim) {
    case 16: return bwd_attributes<16>(out);
    case 32: return bwd_attributes<32>(out);
    case 64: return bwd_attributes<64>(out);
    case 128: return bwd_attributes<128>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
