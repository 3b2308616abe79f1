// Segment boundaries and counts over sorted signatures, written for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/seg_count.py::seg_boundaries
// (_seg_kernel, _seg_kernel_batched).  That kernel compares each sorted
// signature block with a shifted copy the wrapper materializes (prev) and
// emits one partial count per block, summed afterwards by XLA.  Here
// thread i reads row i - 1 itself through an offset load (the neighbour
// is the next thread's row, so the second read comes from L1), row 0 of
// each candidate is always a boundary, and there is no padding.
//
// Layout: grid (cdiv(N, 1024), C), one thread per row.  Each block sums
// its flags with warp shuffles, then one atomicAdd per block lands in a
// zeroed (C,) int32 count; integer atomics give the same total in any
// order, so the count is deterministic.
//
// Bound on an H100: it reads C * N * 8 bytes and writes C * N * 4; a
// compare and an add per row is far below the integer peak, so HBM sets
// the floor.  Loads are one 8-byte uint2 per thread, fully coalesced, and
// the only extra traffic is the L1-served neighbour load and one atomic
// per 1024 rows.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
seg_count_kernel(const uint2* __restrict__ sig, int64_t n,
                 int32_t* __restrict__ bounds, int32_t* __restrict__ counts) {
  __shared__ int warp_sums[kThreads / 32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t c = blockIdx.y;
  int flag = 0;
  if (i < n) {
    const uint2* row = sig + c * n;
    if (i == 0) {
      flag = 1;
    } else {
      const uint2 cur = row[i];
      const uint2 prev = row[i - 1];
      flag = (cur.x != prev.x) | (cur.y != prev.y);
    }
    bounds[c * n + i] = flag;
  }
  int s = flag;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    int v = warp_sums[lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0 && v != 0) atomicAdd(counts + c, v);
  }
}

}  // namespace

// sig:    (C, N, 2) uint32, each candidate sorted along its own row axis
// bounds: (C, N) int32 out; counts: (C,) int32, zeroed by the caller
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_seg_count(const void* sig, int64_t n, int64_t c,
                               void* bounds, void* counts, void* stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(c));
  seg_count_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(sig), n, static_cast<int32_t*>(bounds),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}
