// Diagonal linear recurrence h_t = a_t * h_{t-1} + x_t, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/linear_scan.py::linear_scan
// (_scan_kernel).  That kernel runs an associative prefix scan inside each
// VMEM time block and carries the state across a sequential time grid
// axis.  Here the channels are independent: one thread owns one (batch,
// channel) pair and walks t from 0 to T - 1 with its float32 carry in a
// register, so nothing is carried between blocks.
//
// Each step is a rounded multiply then a rounded add (__fmul_rn,
// __fadd_rn: no FMA contraction), the order of the plain torch version,
// so the two agree bit for bit; a chunked scan over T would round
// differently.  States leave in x's type, the final state in float32.
//
// Bound on an H100: it reads x and a and writes the states once
// (3 * B * T * D * sizeof(x) bytes, plus h0 and the final state); at
// recurrentgemma-2b's prefill (8, 2304, 2560) float32 that is 566 MB,
// 0.169 ms at 3.35 TB/s.  The chains are short of parallelism (B * D =
// 20,480 threads), so the bytes in flight, not the threads, must cover the
// memory latency (Little's law: ~20 KiB per SM at 3.35 TB/s).  Hence:
//  - a block is one warp over 32 neighbouring channels (640 blocks at the
//    shape above, 80 at a batch-1 prefill), so every SM holds several;
//  - each block keeps a ring of kStages stages in shared memory (32 KB
//    in float32), each stage 32 time steps x 32 channels of x and of a,
//    filled by cp.async (16-byte pieces where the rows allow, else element
//    by element) kStages - 1 stages ahead of the chain.  8 stages (64 KB)
//    fit 3 blocks on an SM instead of 7: on an H100 they were slower at
//    (8, 2304, 2560) and within 1% at (1, 2048, 2560), so the ring has 4
//    (PERF.md; tools/time_scan.py --stages N builds it with N to compare);
//  - a thread reads its own column of the stage, and each time step's
//    states leave as one coalesced row of the warp.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

#ifndef LINEAR_SCAN_STAGES
#define LINEAR_SCAN_STAGES 4
#endif

constexpr int kCh = 32;  // channels per block: one warp, a channel a thread
constexpr int kTS = 32;  // time steps per stage
constexpr int kStages = LINEAR_SCAN_STAGES;  // depth of the cp.async ring

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Fills one stage: rows row0 .. row0 + rows - 1 of the flattened (B * T, D)
// x and a, channels j0 .. j0 + 31 (those < d).  Whole 16-byte pieces go by
// cp.async when `vec` (rows 16-byte aligned); the rest by plain loads.
template <typename T>
__device__ __forceinline__ void load_stage(T* xs, T* as, const T* x,
                                           const T* a, int64_t row0,
                                           int rows, int64_t d, int64_t j0,
                                           bool vec) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte piece
  constexpr int kPieces = kCh / kPer;   // pieces per stage row
  for (int p = threadIdx.x; p < rows * kPieces; p += kCh) {
    const int r = p / kPieces;
    const int c = (p % kPieces) * kPer;
    const int64_t src = (row0 + r) * d + j0 + c;
    T* xd = xs + r * kCh + c;
    T* ad = as + r * kCh + c;
    if (vec && j0 + c + kPer <= d) {
      cp_async16(xd, x + src);
      cp_async16(ad, a + src);
    } else {
      for (int e = 0; e < kPer && j0 + c + e < d; ++e) {
        xd[e] = x[src + e];
        ad[e] = a[src + e];
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kCh)
linear_scan_kernel(const T* __restrict__ x, const T* __restrict__ a,
                   const float* __restrict__ h0, T* __restrict__ hs,
                   float* __restrict__ last, int64_t t, int64_t d, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);  // [kStages][kTS][kCh]
  T* as = xs + kStages * kTS * kCh;
  const int lane = threadIdx.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kCh;
  const int64_t bi = blockIdx.y;
  const int64_t j = j0 + lane;
  const bool mine = j < d;
  const int64_t n_chunks = (t + kTS - 1) / kTS;
  auto load = [&](int64_t c) {
    const int st = static_cast<int>(c % kStages);
    const int64_t rows = t - c * kTS;
    load_stage(xs + st * kTS * kCh, as + st * kTS * kCh, x, a,
               bi * t + c * kTS, static_cast<int>(rows < kTS ? rows : kTS),
               d, j0, vec != 0);
  };

  float h = mine && h0 != nullptr ? h0[bi * d + j] : 0.f;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < n_chunks) load(c);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int64_t c = 0; c < n_chunks; ++c) {
    if (c + kStages - 1 < n_chunks) load(c + kStages - 1);
    asm volatile("cp.async.commit_group;" ::: "memory");
    // chunk c's group is complete once at most kStages - 1 are pending
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncwarp();
    const int st = static_cast<int>(c % kStages);
    const T* xc = xs + st * kTS * kCh + lane;
    const T* ac = as + st * kTS * kCh + lane;
    const int64_t t0 = c * kTS;
    T* hp = hs + (bi * t + t0) * d + j;
    if (mine) {
      if (t0 + kTS <= t) {
#pragma unroll
        for (int r = 0; r < kTS; ++r) {
          h = __fadd_rn(__fmul_rn(to_f(ac[r * kCh]), h), to_f(xc[r * kCh]));
          hp[r * d] = from_f<T>(h);
        }
      } else {
        for (int r = 0; r < t - t0; ++r) {
          h = __fadd_rn(__fmul_rn(to_f(ac[r * kCh]), h), to_f(xc[r * kCh]));
          hp[r * d] = from_f<T>(h);
        }
      }
    }
    __syncwarp();  // the stage is consumed before it is refilled
  }
  if (mine) last[bi * d + j] = h;
}

template <typename T>
int launch(const void* x, const void* a, const void* h0, void* hs,
           void* last, int64_t b, int64_t t, int64_t d,
           cudaStream_t stream) {
  constexpr int smem = 2 * kStages * kTS * kCh * static_cast<int>(sizeof(T));
  auto kernel = linear_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = (d * static_cast<int64_t>(sizeof(T))) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const dim3 grid(static_cast<unsigned>((d + kCh - 1) / kCh),
                  static_cast<unsigned>(b));
  kernel<<<grid, kCh, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const float*>(h0), static_cast<T*>(hs),
      static_cast<float*>(last), t, d, vec);
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
