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
                       int n_heads, int group, int sq, int sk,
                       float sm_scale, int causal, int bh0) {
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
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int batch, int n_heads, int group, int sq, int sk,
               float sm_scale, int causal, void* stream) {
  const int rows = batch * n_heads;
  for (int bh0 = 0; bh0 < rows; bh0 += kMaxGridY) {
    const dim3 grid((unsigned)((sq + kBlockQ - 1) / kBlockQ),
                    (unsigned)min(kMaxGridY, rows - bh0));
    flash_attention_kernel<D><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o,
        n_heads, group, sq, sk, sm_scale, causal, bh0);
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
                   __nv_bfloat16* __restrict__ o, int n_heads, int group,
                   int sq, int sk, float scale_log2, int causal) {
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
                int batch, int n_heads, int group, int sq, int sk,
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
      map_q, map_k, map_v, (__nv_bfloat16*)o, n_heads, group, sq, sk,
      sm_scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

using Launcher = int (*)(const void*, const void*, const void*, void*, int,
                         int, int, int, int, float, int, void*);

Launcher launcher(int head_dim, bool bf16) {
  switch (head_dim) {
    case 16: return bf16 ? launch_bf16<16> : launch_f32<16>;
    case 32: return bf16 ? launch_bf16<32> : launch_f32<32>;
    case 64: return bf16 ? launch_bf16<64> : launch_f32<64>;
    case 128: return bf16 ? launch_bf16<128> : launch_f32<128>;
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
                                   const void* v, void* o, int batch,
                                   int n_heads, int group, int sq, int sk,
                                   int head_dim, float sm_scale, int causal,
                                   void* stream) {
  const Launcher fn = launcher(head_dim, false);
  return fn ? fn(q, k, v, o, batch, n_heads, group, sq, sk, sm_scale, causal,
                 stream)
            : (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int n_heads, int group, int sq, int sk,
                                    int head_dim, float sm_scale, int causal,
                                    void* stream) {
  const Launcher fn = launcher(head_dim, true);
  return fn ? fn(q, k, v, o, batch, n_heads, group, sq, sk, sm_scale, causal,
                 stream)
            : (int)cudaErrorInvalidValue;
}
