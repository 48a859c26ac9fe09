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
// call actually waits on is latency: the launch, and chains of L2 round
// trips inside a thread.  A first version (one thread per output walking
// its In + H dot products) waited on each weight load in turn.  So here:
//
//   * a block of 4H threads takes kRows batch rows; thread n owns gate
//     column n and accumulates z[r][n] for all kRows rows, so each weight
//     load feeds kRows multiply-adds;
//   * the block's x and h rows are staged in shared memory (coalesced,
//     zero past the ragged edge of the batch, so the wrapper never pads);
//   * a thread loads its weight column kBatch values at a time into
//     registers before using them, so kBatch loads are in flight at once;
//   * the gate pre-activations go through shared memory to the threads
//     that apply the cell update, one per (row, hidden unit).
//
// Each z[r][n] sums x @ Wx and h @ Wh apart, in order of k, and then adds
// them and the bias, as the plain version groups them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 8;     // batch rows per block
constexpr int kBatch = 16;   // weight loads issued ahead of their use

__device__ __forceinline__ float load_f(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// acc[r] += sum_k in[r][k] * w[k][col] over k = 0..n-1, in order of k.
template <typename T>
__device__ __forceinline__ void column_dot(const float* in, const T* w,
                                           int n, int g4, int col,
                                           float (&acc)[kRows]) {
  for (int k0 = 0; k0 < n; k0 += kBatch) {
    float wk[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      wk[u] = k0 + u < n ? load_f(w, (k0 + u) * g4 + col) : 0.f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u < n) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(in[r * n + k0 + u], wk[u], acc[r]);
      }
    }
  }
}

template <typename T>
__global__ void lstm_cell_kernel(const T* __restrict__ x,
                                 const T* __restrict__ h,
                                 const T* __restrict__ c,
                                 const T* __restrict__ wx,
                                 const T* __restrict__ wh,
                                 const T* __restrict__ b,
                                 T* __restrict__ h_out,
                                 T* __restrict__ c_out,
                                 int batch, int n_in, int hid) {
  extern __shared__ float smem[];
  const int g4 = 4 * hid;
  float* xs = smem;                   // (kRows, n_in)
  float* hs = xs + kRows * n_in;      // (kRows, hid)
  float* zs = hs + kRows * hid;       // (kRows, 4 * hid)
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, batch - row0);
  const int t = threadIdx.x;          // gate column; blockDim.x == 4 * hid

  for (int i = t; i < kRows * n_in; i += g4)
    xs[i] = i < rows * n_in ? load_f(x, row0 * n_in + i) : 0.f;
  for (int i = t; i < kRows * hid; i += g4)
    hs[i] = i < rows * hid ? load_f(h, row0 * hid + i) : 0.f;
  __syncthreads();

  float zx[kRows], zh[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) zx[r] = zh[r] = 0.f;
  column_dot(xs, wx, n_in, g4, t, zx);
  column_dot(hs, wh, hid, g4, t, zh);
  const float bias = load_f(b, t);
#pragma unroll
  for (int r = 0; r < kRows; ++r) zs[r * g4 + t] = zx[r] + zh[r] + bias;
  __syncthreads();

  for (int i = t; i < rows * hid; i += g4) {
    const int r = i / hid;
    const int j = i - r * hid;
    const float* z = zs + r * g4;
    const int o = (row0 + r) * hid + j;
    const float c_new = sigmoid_f(z[hid + j]) * load_f(c, o)
                        + sigmoid_f(z[j]) * tanhf(z[2 * hid + j]);
    store_f(h_out, o, sigmoid_f(z[3 * hid + j]) * tanhf(c_new));
    store_f(c_out, o, c_new);
  }
}

template <typename T>
int launch(const void* x, const void* h, const void* c, const void* wx,
           const void* wh, const void* b, void* h_out, void* c_out,
           int batch, int n_in, int hid, void* stream) {
  const unsigned blocks = (unsigned)((batch + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * kRows * (n_in + 5 * hid);
  lstm_cell_kernel<T><<<blocks, 4 * hid, smem, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)h, (const T*)c, (const T*)wx, (const T*)wh,
      (const T*)b, (T*)h_out, (T*)c_out, batch, n_in, hid);
  return (int)cudaGetLastError();
}

}  // namespace

// Each returns cudaGetLastError() after the launch (0 = launched).  The
// caller guarantees batch > 0, 4 * hid <= 1024 threads, the shared memory
// 4 * kRows * (n_in + 5 * hid) bytes <= 48 KB, 32-bit offsets,
// contiguity and matching dtypes.
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
