// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/linear_scan.py::linear_scan
// (_scan_kernel).  That kernel runs an associative prefix scan inside each
// VMEM time block and carries the state across a sequential time grid
// axis.  Here the channels are independent, so one thread owns one
// (batch, channel) pair and walks t from 0 to T - 1 with its float32 carry
// in a register: nothing is carried between blocks.  Neighbouring threads
// take neighbouring channels, so every load and store of a time step is
// one coalesced row segment; no padding of T is needed.
//
// Each step is a rounded multiply then a rounded add (__fmul_rn,
// __fadd_rn: no FMA contraction), the order of the plain torch version,
// so the two agree bit for bit.  States leave in x's type, the final
// state in float32.
//
// Bound on an H100: it reads x and a and writes the states once
// (2 * B * T * D * sizeof(x) + B * T * D * sizeof(x) bytes, plus h0 and
// the final state); at recurrentgemma-2b's prefill (8, 2304, 2560) float32
// that is 566 MB, 0.169 ms at 3.35 TB/s.  Only B * D = 20,480 threads run
// there, each a chain of T dependent steps, so the kernel is bound by
// load latency, not by bandwidth; the unrolled loop lets each thread keep
// several time steps' loads in flight.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
linear_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const float* __restrict__ h0, T* __restrict__ hs,
                   float* __restrict__ last, int64_t t, int64_t d) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t bi = blockIdx.y;
  if (j >= d) return;
  float h = h0 != nullptr ? h0[bi * d + j] : 0.f;
  const int64_t base = bi * t * d + j;
  const T* xp = x + base;
  const T* ap = a + base;
  T* hp = hs + base;
#pragma unroll 8
  for (int64_t i = 0; i < t; ++i) {
    h = __fadd_rn(__fmul_rn(to_f(ap[i * d]), h), to_f(xp[i * d]));
    hp[i * d] = from_f<T>(h);
  }
  last[bi * d + j] = h;
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* hs,
           void* last, int64_t b, int64_t t, int64_t d,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((d + kThreads - 1) / kThreads),
                  static_cast<unsigned>(b));
  linear_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(hs),
      static_cast<float*>(last), t, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, a, hs: (B, T, D) contiguous, dtype 0 = float32, 1 = bfloat16;
// h0: (B, D) float32 or null (zeros); last: (B, D) float32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_linear_scan(const void* x, const void* a,
                                 const void* h0, void* hs, void* last,
                                 int64_t b, int64_t t, int64_t d, int dtype,
                                 void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, a, h0, hs, last, b, t, d, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, h0, hs, last, b, t, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
