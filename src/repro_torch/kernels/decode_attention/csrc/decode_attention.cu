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
// long).  I/O is fp32 or bf16; all math is fp32.
//
// What bounds it: bytes.  At yi-6b's shapes (Hkv = 4, D = 128) and
// kv_len = 4096, one layer reads 2 * 4 * 4096 * 128 * 2 B = 8.4 MB of
// bf16 K/V (2.5 us at 3.35 TB/s) for 2 * 2 * 32 * 4096 * 128 = 67 MFLOP:
// 8 FLOP per byte.  The Pallas kernel runs one program per (b, KV head),
// which on this card would fill B * Hkv = 4 of 132 SMs.  So the keys are
// split (flash-decoding) into blocks of 128, two launches per call:
//
//   1. decode_partial_kernel, one block per (b, KV head, 128 keys): the G
//      query heads of the KV head share one pass over the block's keys.
//      The block's keys, values and queries are contiguous in memory and
//      come into shared memory in one round trip (16-byte cp.async copies,
//      all in flight at once: a small launch is bound by round trips, not
//      by bytes).  Thread j scores key j against the G queries; a warp per
//      query head takes the block's max m and l = sum exp(s - m); then
//      P @ V with the threads on the columns of V.  It writes
//      (m, l, unnormalised acc).
//   2. decode_combine_kernel, one block per (b, query head): rescales the
//      split partials by exp(m_s - max m) and divides by the summed l.
//
// At kv_len 4096 the first launch has 32 * B * Hkv = 128 blocks.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 128;       // keys per block of the first launch
constexpr int kMaxGridY = 65535;
constexpr int kMaxGroup = 16;    // query heads per KV head
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// one 16-byte word of shared memory -> 4 fp32 or 8 bf16 values as fp32
// (a bf16 is the high half of an fp32, so the widening is exact)
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 bytes global -> shared without passing through registers; every
// copy a thread issues is in flight until cp_async_wait_all
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// shared memory of one block: K rows padded by one 16-byte word (so the
// threads' row reads fall on different banks), V rows, the G queries
template <typename T, int D>
struct Tiles {
  static constexpr int kPad = 16 / sizeof(T);
  static constexpr size_t kBytes =
      sizeof(T) * ((size_t)kKeys * (D + kPad) + (size_t)kKeys * D +
                   (size_t)kMaxGroup * D);
};

template <typename T, int D>
__global__ void __launch_bounds__(kKeys)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ part_o,
                      float* __restrict__ part_ml, int group, int seq,
                      int kv_len, int n_splits, float sm_scale, int bk0) {
  constexpr int kParts = kKeys / D;   // key subsets of the P @ V threads
  constexpr int kPad = Tiles<T, D>::kPad;
  constexpr int kPerWord = 16 / sizeof(T);
  constexpr int kWords = D / kPerWord;          // 16-byte words per row
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);           // [kKeys][D + kPad]
  T* vs = ks + kKeys * (D + kPad);              // [kKeys][D]
  T* qs = vs + kKeys * D;                       // [group][D]
  __shared__ float ps[kMaxGroup * kKeys];

  const int split = blockIdx.x;
  const int bk = bk0 + blockIdx.y;    // b * Hkv + KV head
  const int t = threadIdx.x;
  const int k0 = split * kKeys;
  const int n_keys = min(kKeys, kv_len - k0);
  const T* kp = k + ((size_t)bk * seq + k0) * D;
  const T* vp = v + ((size_t)bk * seq + k0) * D;
  const T* qp = q + (size_t)bk * group * D;     // the KV head's G queries

  // one round trip: every word of the block's keys, values and queries
  for (int i = t; i < n_keys * kWords; i += kKeys) {
    const int j = i / kWords, w = i - j * kWords;
    cp_async16(ks + j * (D + kPad) + w * kPerWord, kp + (size_t)i * kPerWord);
    cp_async16(vs + (size_t)i * kPerWord, vp + (size_t)i * kPerWord);
  }
  for (int i = t; i < group * kWords; i += kKeys)
    cp_async16(qs + i * kPerWord, qp + i * kPerWord);
  cp_async_wait_all();
  __syncthreads();

  // scores: thread t <-> key k0 + t
  float sc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) sc[g] = 0.f;
  if (t < n_keys) {
    const T* kr = ks + t * (D + kPad);
#pragma unroll 4
    for (int c = 0; c < D; c += kPerWord) {
      float kk[kPerWord];
      load16(kr + c, kk);
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float qq[kPerWord];
          load16(qs + g * D + c, qq);
#pragma unroll
          for (int e = 0; e < kPerWord; ++e)
            sc[g] = fmaf(qq[e], kk[e], sc[g]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g)
    if (g < group)
      ps[g * kKeys + t] = t < n_keys ? sc[g] * sm_scale : kNegInf;
  __syncthreads();

  // block max and sum of exp, one warp per query head
  const int warp = t / 32, lane = t % 32;
  for (int g = warp; g < group; g += kKeys / 32) {
    float* row = ps + g * kKeys;
    float mx = kNegInf;
    for (int j = lane; j < kKeys; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
    for (int j = lane; j < kKeys; j += 32) {
      const float p = j < n_keys ? expf(row[j] - mx) : 0.f;
      row[j] = p;
      sum += p;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      float* ml =
          part_ml + (((size_t)bk * n_splits + split) * group + g) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  __syncthreads();

  // P @ V: thread t takes column d of the keys j = jp, jp + kParts, ...
  const int d = t % D, jp = t / D;
  float acc[kMaxGroup];
#pragma unroll
  for (int g = 0; g < kMaxGroup; ++g) acc[g] = 0.f;
  for (int j = jp; j < n_keys; j += kParts) {
    const float vv = to_f(vs[j * D + d]);
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) acc[g] = fmaf(ps[g * kKeys + j], vv, acc[g]);
  }
  if (kParts > 1) {
    __syncthreads();   // every thread has read ps
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) ps[g * kKeys + t] = acc[g];
    __syncthreads();
    if (t < D) {
#pragma unroll
      for (int g = 0; g < kMaxGroup; ++g) {
        if (g < group) {
          float s = 0.f;
          for (int p = 0; p < kParts; ++p) s += ps[g * kKeys + p * D + t];
          acc[g] = s;
        }
      }
    }
  }
  if (t < D) {
    float* po = part_o + ((size_t)bk * n_splits + split) * group * D;
#pragma unroll
    for (int g = 0; g < kMaxGroup; ++g)
      if (g < group) po[g * D + t] = acc[g];
  }
}

template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_o,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ o, int group,
                                      int n_splits, int head_dim) {
  const int bh = blockIdx.x;          // b * H + h, h = KV head * G + g
  const int bk = bh / group, g = bh - bk * group;
  const int d = threadIdx.x;
  const float* ml = part_ml + ((size_t)bk * n_splits * group + g) * 2;
  float mx = kNegInf;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) mx = fmaxf(mx, ml[2 * s * group]);
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_splits; ++s) {
    const float w = expf(ml[2 * s * group] - mx);
    l = fmaf(ml[2 * s * group + 1], w, l);
    const size_t row = ((size_t)bk * n_splits + s) * group + g;
    acc = fmaf(part_o[row * head_dim + d], w, acc);
  }
  store_f(o + (size_t)bh * head_dim + d, acc / fmaxf(l, 1e-30f));
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o,
             float* part_o, float* part_ml, int batch, int n_kv, int group,
             int seq, int kv_len, float sm_scale, void* stream) {
  const int n_splits = (kv_len + kKeys - 1) / kKeys;
  const size_t smem = Tiles<T, D>::kBytes;     // above 48 KB: opt in
  int rc = (int)cudaFuncSetAttribute(
      decode_partial_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != 0) return rc;
  // b * Hkv on grid y, in slices of at most 65535, a launch each
  const int rows = batch * n_kv;
  for (int bk0 = 0; bk0 < rows; bk0 += kMaxGridY) {
    const dim3 grid((unsigned)n_splits,
                    (unsigned)min(kMaxGridY, rows - bk0));
    decode_partial_kernel<T, D><<<grid, kKeys, smem,
                                  (cudaStream_t)stream>>>(
        (const T*)q, (const T*)k, (const T*)v, part_o, part_ml, group, seq,
        kv_len, n_splits, sm_scale, bk0);
    rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  decode_combine_kernel<T><<<batch * n_kv * group, D, 0,
                             (cudaStream_t)stream>>>(
      part_o, part_ml, (T*)o, group, n_splits, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           void* part_o, void* part_ml, int batch, int n_kv, int group,
           int seq, int kv_len, int head_dim, float sm_scale, void* stream) {
  float* po = (float*)part_o;
  float* pm = (float*)part_ml;
  switch (head_dim) {
    case 16:
      return launch_d<T, 16>(q, k, v, o, po, pm, batch, n_kv, group, seq,
                             kv_len, sm_scale, stream);
    case 32:
      return launch_d<T, 32>(q, k, v, o, po, pm, batch, n_kv, group, seq,
                             kv_len, sm_scale, stream);
    case 64:
      return launch_d<T, 64>(q, k, v, o, po, pm, batch, n_kv, group, seq,
                             kv_len, sm_scale, stream);
    case 128:
      return launch_d<T, 128>(q, k, v, o, po, pm, batch, n_kv, group, seq,
                              kv_len, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each launches the partials (once per 65535 of batch * n_kv, 1 at the
// path's shapes) and their combine, and returns cudaGetLastError() after
// the last (0 = all launched).  part_o holds B * Hkv * n_splits * G * D and
// part_ml B * Hkv * n_splits * G * 2 floats, n_splits = ceil(kv_len / 128).
// The caller guarantees 0 < kv_len <= seq, 1 <= group <= 16, head_dim in
// {16, 32, 64, 128}, contiguous 16-byte-aligned tensors of one dtype.
extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, void* o, void* part_o,
                                    void* part_ml, int batch, int n_kv,
                                    int group, int seq, int kv_len,
                                    int head_dim, float sm_scale,
                                    void* stream) {
  return launch<float>(q, k, v, o, part_o, part_ml, batch, n_kv, group, seq,
                       kv_len, head_dim, sm_scale, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, void* o, void* part_o,
                                     void* part_ml, int batch, int n_kv,
                                     int group, int seq, int kv_len,
                                     int head_dim, float sm_scale,
                                     void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, part_o, part_ml, batch, n_kv,
                               group, seq, kv_len, head_dim, sm_scale, stream);
}
