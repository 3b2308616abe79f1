// murmur3 row signatures for the FSP group-by, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_hash.py::sig_hash
// (_hash_block, _sig_hash_kernel, _sig_hash_kernel_batched).  That kernel
// hashes a (C, N, K) stack the caller has already materialized
// (parent * column mask); this one reads the (N, K) parent once per
// candidate and applies the column mask and the padded-row sentinel
// itself, so the masked stack never exists in device memory.
//
// Layout: grid (cdiv(N, 256), C), one thread per row.  The thread loops
// over the K columns (unrolled for the bucket_cols rungs 2..32), runs the
// two murmur3 lanes in registers and writes its [hi, lo] pair as one
// 8-byte store.  Every column is hashed -- masked ones as 0 -- and both
// lanes finalize with fmix32(h ^ K), which is what makes the result
// bit-identical to hashing the masked stack.
//
// Bound on an H100: per row it reads K int32 and writes 8 bytes, and runs
// 7K + 4 IMADs (FMA pipe) and 7K + 14 shifts and logic ops (INT32 pipe),
// each pipe 64 lanes/clk/SM, running side by side.  At the sweep's
// (N=2^21, K=8, C=8) the INT32 pipe's 1.17 G operations (0.070 ms) and
// the ~0.2 GB of traffic (0.061 ms) nearly meet; the design keeps all
// arithmetic in registers, touches the parent once per candidate (it
// stays in L2 across the candidate axis only when it fits), and issues
// no shared-memory traffic at all.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kFM1 = 0x85ebca6bu;
constexpr uint32_t kFM2 = 0xc2b2ae35u;
constexpr uint32_t kSeedHi = 0x9e3779b9u;
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mm3_step(uint32_t h, uint32_t k) {
  k *= kC1;
  k = rotl32(k, 15);
  k *= kC2;
  h ^= k;
  h = rotl32(h, 13);
  return h * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kFM1;
  h ^= h >> 13;
  h *= kFM2;
  return h ^ (h >> 16);
}

// K > 0: compile-time column count (loop fully unrolled); K == 0: k_rt.
template <int K>
__global__ void __launch_bounds__(kThreads)
sig_hash_kernel(const int32_t* __restrict__ mat, int64_t n, int k_rt,
                int64_t mat_cstride, const int32_t* __restrict__ masks,
                const uint8_t* __restrict__ valid, int64_t valid_cstride,
                uint2* __restrict__ out) {
  const int k = K > 0 ? K : k_rt;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t c = blockIdx.y;
  if (i >= n) return;
  uint2 res;
  if (valid != nullptr && valid[c * valid_cstride + i] == 0) {
    res = make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu);        // SIG_SENTINEL
  } else {
    const int32_t* row = mat + c * mat_cstride + i * k;
    const int32_t* m = masks != nullptr ? masks + c * k : nullptr;
    uint32_t lo = 0u;
    uint32_t hi = kSeedHi;
#pragma unroll
    for (int j = 0; j < k; ++j) {
      // the cast is the int32 -> uint32 bit reinterpretation; the unsigned
      // multiply by the mask keeps the low 32 bits of the reference's
      // int32 masked stack
      uint32_t x = static_cast<uint32_t>(row[j]);
      if (m != nullptr) x *= static_cast<uint32_t>(m[j]);
      lo = mm3_step(lo, x);
      hi = mm3_step(hi, x ^ 0xdeadbeefu);
    }
    lo = fmix32(lo ^ static_cast<uint32_t>(k));
    hi = fmix32(hi ^ static_cast<uint32_t>(k));
    res = make_uint2(hi, lo);
  }
  out[c * n + i] = res;
}

template <int K>
void launch(const int32_t* mat, int64_t n, int k, int64_t mat_cstride,
            const int32_t* masks, int64_t c, const uint8_t* valid,
            int64_t valid_cstride, uint2* out, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>(c));
  sig_hash_kernel<K><<<grid, kThreads, 0, stream>>>(
      mat, n, k, mat_cstride, masks, valid, valid_cstride, out);
}

}  // namespace

// mat:    int32, candidate c's rows start at mat + c * mat_cstride
//         (mat_cstride = 0 for a shared (N, K) parent, N * K for a stack)
// masks:  (C, K) int32 column mask or null
// valid:  (N,) or (C, N) bool bytes or null (valid_cstride 0 or N)
// out:    (C, N, 2) uint32, [hi, lo] per row
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_sig_hash(const void* mat, int64_t n, int k,
                              int64_t mat_cstride, const void* masks,
                              int64_t c, const void* valid,
                              int64_t valid_cstride, void* out,
                              void* stream) {
  auto* m = static_cast<const int32_t*>(mat);
  auto* mk = static_cast<const int32_t*>(masks);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: launch<2>(m, n, k, mat_cstride, mk, c, v, valid_cstride, o, s); break;
    case 4: launch<4>(m, n, k, mat_cstride, mk, c, v, valid_cstride, o, s); break;
    case 8: launch<8>(m, n, k, mat_cstride, mk, c, v, valid_cstride, o, s); break;
    case 16: launch<16>(m, n, k, mat_cstride, mk, c, v, valid_cstride, o, s); break;
    case 32: launch<32>(m, n, k, mat_cstride, mk, c, v, valid_cstride, o, s); break;
    default: launch<0>(m, n, k, mat_cstride, mk, c, v, valid_cstride, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
