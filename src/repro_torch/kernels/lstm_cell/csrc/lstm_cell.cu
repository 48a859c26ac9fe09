// Fused LSTM cell for Hopper (sm_90a), plain C launchers bound with ctypes.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/lstm_cell/lstm_cell.py::_lstm_kernel (lstm_cell_pallas).
//
//   z  = x @ Wx + h @ Wh + b            gates packed [i, f, g, o]
//   c' = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h' = sigmoid(o) * tanh(c')
//
// x (B, In), h and c (B, H), Wx (In, 4H), Wh (H, 4H), b (4H), all row-major
// and contiguous; h', c' (B, H).  I/O is fp32 or bf16, accumulation and
// the gate math are fp32 (as in the TPU kernel).
//
// What bounds it: on START's decision path B is a job bucket (<= 256) and
// In = H = 32, so one call is ~4 MFLOP over ~0.2 MB of inputs and outputs:
// tens of nanoseconds at the card's memory or fp32 rate.  What a small
// call actually waits on is latency: the launch, and each round trip to L2
// or memory that a thread waits on in turn (six in a row, x and h, the
// weights a batch at a time, the bias, then c, took 7-8 us a launch), and
// the bytes one SM pulls from L2.  So here:
//
//   * a block takes kUnits = 8 hidden units, i.e. their 32 gate columns
//     (lane = gate * 8 + unit), and 8 batch rows, one warp each: at In =
//     H = 32, B = 1 runs as 4 blocks and B = 256 as 128, each block
//     reading an 8 KB slice of the weights (its 8 warps share the copies,
//     also where fewer rows are left);
//   * every load of a launch is issued in one round before any is used:
//     the block's weight and bias slice by 16-byte cp.async into shared
//     memory (8 contiguous columns per gate and row; plain loads where H
//     is not a multiple of 8 or a pointer is not 16-byte aligned), and each
//     warp's x, h and c by plain loads; then one wait;
//   * lane n accumulates z[row][n] from shared memory, and lane j < 8
//     gathers unit j's four gates from lanes j, j + 8, j + 16, j + 24 by
//     shuffles and applies the cell update: no second barrier.
//
// Each z[r][n] sums x @ Wx and h @ Wh apart, in order of k, and then adds
// them and the bias, as the plain version groups them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxSmem = 232448;     // 227 KB, a block's most (opted in)
constexpr int kUnits = 8;            // hidden units per block: 32 columns
constexpr int kMaxRows = 8;          // batch rows per block, a warp each

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// The gates by the special-function exponential (__expf, ~2 ulp) and a
// fast divide, shorter chains than expf and tanhf: ~2e-7 absolute off the
// plain version's, against the 1e-5 the fp32 check allows.
__device__ __forceinline__ float sigmoid_f(float v) {
  return __fdividef(1.0f, 1.0f + __expf(-v));
}
__device__ __forceinline__ float tanh_f(float v) {
  return 1.0f - __fdividef(2.0f, __expf(2.0f * v) + 1.0f);
}

// Shared memory of a block: the weight slice and the bias, (In + H + 1) x
// 32 elements, then each warp's x and h row in fp32 (ops.smem_bytes in
// Python).
__host__ __device__ constexpr long long slice_bytes(int n_in, int hid,
                                                    int elem) {
  return ((long long)(n_in + hid + 1) * 32 * elem + 15) / 16 * 16;
}
__host__ __device__ constexpr int row_floats(int n_in, int hid) {
  return (n_in + hid + 3) / 4 * 4;
}
__host__ __device__ constexpr long long smem_bytes(int n_in, int hid,
                                                   int elem) {
  return slice_bytes(n_in, hid, elem) + 4LL * kMaxRows * row_floats(n_in, hid);
}

// 16 bytes from device to shared memory, not waited on
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(32 * kMaxRows)
    lstm_cell_kernel(const T* __restrict__ x, const T* __restrict__ h,
                     const T* __restrict__ c, const T* __restrict__ wx,
                     const T* __restrict__ wh, const T* __restrict__ b,
                     T* __restrict__ h_out, T* __restrict__ c_out,
                     int batch, int n_in, int hid, int unit_blocks) {
  extern __shared__ __align__(16) char smem[];
  const int g4 = 4 * hid, k_all = n_in + hid;
  const int u0 = (blockIdx.x % unit_blocks) * kUnits;
  const int row0 = (blockIdx.x / unit_blocks) * kMaxRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int unit = u0 + lane % kUnits;
  const int row = row0 + warp;
  const bool row_ok = row < batch;
  T* ws = reinterpret_cast<T*>(smem);  // [k_all + 1][32]: Wx, Wh, b
  float* xh = reinterpret_cast<float*>(smem + slice_bytes(n_in, hid,
                                                          sizeof(T))) +
              warp * row_floats(n_in, hid);

  // every load of the launch in one round: the weight slice first
  if constexpr (kVec) {
    // (row k, gate) holds 8 contiguous elements: kPer 16-byte pieces; a
    // thread copies one piece of every kStride-th row
    constexpr int kPer = kUnits * sizeof(T) / 16;
    constexpr int kPieces = 4 * kPer;
    constexpr int kStride = 32 * kMaxRows / kPieces;
    const int piece = threadIdx.x % kPieces;
    const int col = piece / kPer * kUnits + piece % kPer * (16 / sizeof(T));
    const int src_col = piece / kPer * hid + u0 + col % kUnits;
    for (int k = threadIdx.x / kPieces; k < n_in; k += kStride)
      cp_async16(ws + k * 32 + col, wx + (size_t)k * g4 + src_col);
    for (int k = threadIdx.x / kPieces; k < hid; k += kStride)
      cp_async16(ws + (n_in + k) * 32 + col, wh + (size_t)k * g4 + src_col);
    if (threadIdx.x < kPieces) cp_async16(ws + k_all * 32 + col, b + src_col);
  } else {
#pragma unroll 4
    for (int i = threadIdx.x; i < (k_all + 1) * 32; i += blockDim.x) {
      const int k = i / 32, c = i % 32, uu = u0 + c % kUnits;
      const T* w = k < n_in ? wx + (size_t)k * g4
                            : (k < k_all ? wh + (size_t)(k - n_in) * g4 : b);
      ws[i] = uu < hid ? w[c / kUnits * hid + uu] : T{};
    }
  }
  // this warp's x and h rows, and its units' c
#pragma unroll 4
  for (int k = lane; k < k_all; k += 32)
    xh[k] = !row_ok ? 0.f
                    : to_f(k < n_in ? x[(size_t)row * n_in + k]
                                    : h[(size_t)row * hid + k - n_in]);
  const bool mine = lane < kUnits && row_ok && unit < hid;
  const float cv = mine ? to_f(c[(size_t)row * hid + unit]) : 0.f;
  if constexpr (kVec) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float zx = 0.f, zh = 0.f;
#pragma unroll 8
  for (int k = 0; k < n_in; ++k) zx = fmaf(xh[k], to_f(ws[k * 32 + lane]), zx);
#pragma unroll 8
  for (int k = n_in; k < k_all; ++k)
    zh = fmaf(xh[k], to_f(ws[k * 32 + lane]), zh);
  const float z = zx + zh + to_f(ws[k_all * 32 + lane]);
  // lane j < 8 gathers unit j's gates: i (its own), f, g, o
  const float zf = __shfl_sync(0xffffffffu, z, (lane + kUnits) % 32);
  const float zg = __shfl_sync(0xffffffffu, z, (lane + 2 * kUnits) % 32);
  const float zo = __shfl_sync(0xffffffffu, z, (lane + 3 * kUnits) % 32);
  if (mine) {
    const float c_new = sigmoid_f(zf) * cv + sigmoid_f(z) * tanh_f(zg);
    const size_t o = (size_t)row * hid + unit;
    store_f(h_out, o, sigmoid_f(zo) * tanh_f(c_new));
    store_f(c_out, o, c_new);
  }
}

template <typename T, bool kVec>
int launch_v(const void* x, const void* h, const void* c, const void* wx,
             const void* wh, const void* b, void* h_out, void* c_out,
             int batch, int n_in, int hid, void* stream) {
  auto kernel = lstm_cell_kernel<T, kVec>;
  const long long smem = smem_bytes(n_in, hid, (int)sizeof(T));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  // the > 48 KB of dynamic shared memory, opted in once per device
  static bool opted[kMaxDevices] = {};
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted[dev]) {
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (rc != 0) return rc;
    opted[dev] = true;
  }
  const int unit_blocks = (hid + kUnits - 1) / kUnits;
  const long long blocks =
      (long long)unit_blocks * ((batch + kMaxRows - 1) / kMaxRows);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * kMaxRows, (size_t)smem,
           (cudaStream_t)stream>>>(
      (const T*)x, (const T*)h, (const T*)c, (const T*)wx, (const T*)wh,
      (const T*)b, (T*)h_out, (T*)c_out, batch, n_in, hid, unit_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, void* h_out, void* c_out,
           int batch, int n_in, int hid, void* stream) {
  // 16-byte pieces of 8 columns need H % 8 == 0 and aligned weights
  const bool vec = hid % kUnits == 0 &&
                   (((uintptr_t)wx | (uintptr_t)wh | (uintptr_t)b) & 15) == 0;
  if (vec)
    return launch_v<T, true>(x, h, c, wx, wh, b, h_out, c_out, batch, n_in,
                             hid, stream);
  return launch_v<T, false>(x, h, c, wx, wh, b, h_out, c_out, batch, n_in,
                            hid, stream);
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).  The
// caller guarantees batch > 0, a block's shared memory (smem_bytes) <= 227
// KB, contiguity and matching dtypes.
extern "C" int lstm_cell_f32(const void* x, const void* h, const void* c,
                             const void* wx, const void* wh, const void* b,
                             void* h_out, void* c_out, int batch, int n_in,
                             int hid, void* stream) {
  return launch<float>(x, h, c, wx, wh, b, h_out, c_out, batch, n_in, hid,
                       stream);
}

extern "C" int lstm_cell_bf16(const void* x, const void* h, const void* c,
                              const void* wx, const void* wh, const void* b,
                              void* h_out, void* c_out, int batch, int n_in,
                              int hid, void* stream) {
  return launch<__nv_bfloat16>(x, h, c, wx, wh, b, h_out, c_out, batch, n_in,
                               hid, stream);
}
