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
// I/O is fp32 or bf16; m, l, acc and all math are fp32.
//
// What bounds it: at yi-6b's shapes (H = 32, Hkv = 4, D = 128), a causal
// prefill of S = 2048 is 4 * H * S^2 * D / 2 = 34.4 GFLOP per layer
// (1.10 TFLOP over 32 layers) against (2 H + 2 Hkv) * S * D * 2 B =
// 37.7 MB of bf16 I/O: ~900 FLOP per byte, so operations bound it
// (about 35 us per layer at the bf16 tensor-core peak, 0.5 ms at the fp32
// CUDA-core peak).  This first design is the simple, right one: fp32 FMAs
// on CUDA cores, no tensor cores (the fp32 path must stay IEEE fp32):
//
//   * one block per (b, h, 64-query tile), 4 threads per query row; a
//     thread owns D/16 float4 chunks of the row (chunks interleaved across
//     the 4 threads, so a warp's shared-memory reads hit 4 neighbouring
//     16-byte words and broadcast across its 8 rows);
//   * K and V tiles of 32 keys are staged in shared memory as fp32 and
//     read by all 64 rows of the block, once per tile;
//   * a row's 32 scores live in registers: tile max, rescale of (l, acc)
//     by exp(m - m_new), p = exp(s - m_new), acc += p v;
//   * key tiles wholly in the causal future of the block's last row are
//     never loaded (the Pallas kernel's pl.when(run) skip).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;                      // query rows per block
constexpr int kRowThreads = 4;                   // threads per query row
constexpr int kThreads = kBlockQ * kRowThreads;  // 256
constexpr int kBlockK = 32;                      // keys per staged tile
constexpr float kNegInf = -1e30f;                // the Pallas kernel's

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
// 4 bf16 -> fp32 (exact: a bf16 is the high half of an fp32)
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  uint2 u;
  u.x = bf16_bits(v.x) | (bf16_bits(v.y) << 16);
  u.y = bf16_bits(v.z) | (bf16_bits(v.w) << 16);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
                       int n_heads, int group, int sq, int sk,
                       float sm_scale, int causal) {
  constexpr int kChunks = D / (4 * kRowThreads);  // a thread's float4s
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];

  const int q0 = blockIdx.x * kBlockQ;
  const int bh = blockIdx.y;                      // b * n_heads + h
  const int b = bh / n_heads;
  const int h = bh - b * n_heads;
  const size_t kv_base =
      ((size_t)b * (n_heads / group) + h / group) * (size_t)sk * D;
  const T* kp = k + kv_base;
  const T* vp = v + kv_base;

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

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int n_heads, int group, int sq, int sk, float sm_scale,
             int causal, void* stream) {
  const dim3 grid((unsigned)((sq + kBlockQ - 1) / kBlockQ),
                  (unsigned)(batch * n_heads));
  flash_attention_kernel<T, D><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, n_heads, group, sq, sk,
      sm_scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch,
           int n_heads, int group, int sq, int sk, int head_dim,
           float sm_scale, int causal, void* stream) {
  switch (head_dim) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, batch, n_heads, group, sq, sk,
                             sm_scale, causal, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, batch, n_heads, group, sq, sk,
                             sm_scale, causal, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, batch, n_heads, group, sq, sk,
                             sm_scale, causal, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, batch, n_heads, group, sq, sk,
                              sm_scale, causal, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).  The
// caller guarantees sq, sk > 0, head_dim in {16, 32, 64, 128}, n_heads a
// multiple of group, batch * n_heads < 65536, contiguous 16-byte-aligned
// tensors of one dtype.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int n_heads, int group, int sq, int sk,
                                   int head_dim, float sm_scale, int causal,
                                   void* stream) {
  return launch<float>(q, k, v, o, batch, n_heads, group, sq, sk, head_dim,
                       sm_scale, causal, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int n_heads, int group, int sq, int sk,
                                    int head_dim, float sm_scale, int causal,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, batch, n_heads, group, sq, sk,
                               head_dim, sm_scale, causal, stream);
}
