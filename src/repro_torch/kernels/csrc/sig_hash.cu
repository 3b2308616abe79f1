// murmur3 row signatures for the FSP group-by, written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/sig_hash.py::sig_hash
// (_hash_block, _sig_hash_kernel, _sig_hash_kernel_batched).  That kernel
// hashes a (C, N, K) stack the caller has already materialized
// (parent * column mask); this one applies the column masks and the
// padded-row sentinel itself, so the masked stack never exists in device
// memory.
//
// Layout: one thread per row, 256 rows a block; the thread loops over
// the candidates.  In the fused form (an (N, K) parent and (C, K) masks)
// the thread loads its row once, into registers, before that loop (int4
// pieces for K = 4..32, int2 for K = 2), so the parent is read once per
// launch for all C candidates; a row whose (N,) valid flag is False is
// not read at all.  The block stages the masks in shared memory, a piece
// of at most kMaskInts at a time.  Per candidate both murmur3 lanes run
// in registers over the masked row -- every column hashed, masked ones
// as x * m (a multiply: any int32 mask is taken), finalized with
// fmix32(h ^ K) -- which is what makes the result bit-identical to
// hashing the masked stack; the [hi, lo] pair goes out as one 8-byte
// store, consecutive threads on consecutive rows of candidate c.  Row
// blocks run from both ends of the rows in turn (a bucket's padding is
// its tail, so hashing and store-only blocks share the card).  A
// second grid axis splits the candidates into chunks only where the rows
// alone give too few blocks to fill the card (the caller picks the
// number of chunks); each chunk then reads the (small) parent once.
// The stacked (C, N, K) form reads candidate c's own row inside the loop;
// a runtime K (not a power of two, or above 32) reads the row from global
// memory per candidate with scalar loads (the repeats hit L1).
//
// Bound on an H100, counted over the work the kernel must do: per valid
// row and candidate 7K + 4 IMADs (FMA pipe) and 7K + 14 shifts and logic
// ops (INT32 pipe), each pipe 64 lanes/clk/SM, running side by side;
// bytes: the valid rows of the parent once, the valid flags, the masks,
// and C * N * 8 bytes of signatures (the sentinels of invalid rows are
// written too: the sort reads them).  At the sweep's (N = 2^21, K = 8,
// C = 8) with 1.11M valid rows the bytes set it: about 0.051 ms.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kFM1 = 0x85ebca6bu;
constexpr uint32_t kFM2 = 0xc2b2ae35u;
constexpr uint32_t kSeedHi = 0x9e3779b9u;
constexpr int kThreads = 256;
constexpr int kMaskInts = 4096;     // masks staged per piece (16 KB)

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

// row of K int32 into registers: int4 pieces (K % 4 == 0), int2 (K == 2),
// else scalars; ``vec`` says the base allows the vector pieces
template <int K>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ row,
                                         bool vec, uint32_t (&x)[K]) {
  if (K % 4 == 0 && vec) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const int4 p = __ldg(reinterpret_cast<const int4*>(row + j));
      x[j] = p.x; x[j + 1] = p.y; x[j + 2] = p.z; x[j + 3] = p.w;
    }
  } else if (K % 2 == 0 && vec) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const int2 p = __ldg(reinterpret_cast<const int2*>(row + j));
      x[j] = p.x; x[j + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) x[j] = __ldg(row + j);
  }
}

// K masks from shared memory (16-byte aligned for K % 4 == 0, 8 for K = 2)
template <int K>
__device__ __forceinline__ void load_mask(const int32_t* m,
                                          uint32_t (&mk)[K]) {
  if (K % 4 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 4) {
      const int4 p = *reinterpret_cast<const int4*>(m + j);
      mk[j] = p.x; mk[j + 1] = p.y; mk[j + 2] = p.z; mk[j + 3] = p.w;
    }
  } else if (K % 2 == 0) {
#pragma unroll
    for (int j = 0; j < K; j += 2) {
      const int2 p = *reinterpret_cast<const int2*>(m + j);
      mk[j] = p.x; mk[j + 1] = p.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) mk[j] = m[j];
  }
}

__device__ __forceinline__ uint2 finish(uint32_t hi, uint32_t lo, int k) {
  return make_uint2(fmix32(hi ^ static_cast<uint32_t>(k)),
                    fmix32(lo ^ static_cast<uint32_t>(k)));
}

// K > 0: compile-time column count, the row held in registers;
// K == 0: k_rt columns read from global memory per candidate.
template <int K>
__global__ void __launch_bounds__(kThreads)
sig_hash_kernel(const int32_t* __restrict__ mat, int64_t n, int k_rt,
                int64_t mat_cstride, bool vec,
                const int32_t* __restrict__ masks, int64_t c,
                int64_t c_per_block, const uint8_t* __restrict__ valid,
                int64_t valid_cstride, uint2* __restrict__ out) {
  __shared__ __align__(16) int32_t smask[kMaskInts];
  constexpr int KR = K > 0 ? K : 1;
  const int k = K > 0 ? K : k_rt;
  // a bucket's padding is a suffix of its rows: row blocks are taken from
  // the front and the back in turn, so store-only padding blocks run
  // beside hashing blocks instead of after them
  const int64_t bx = (blockIdx.x & 1) ? gridDim.x - 1 - (blockIdx.x >> 1)
                                      : blockIdx.x >> 1;
  const int64_t i = bx * kThreads + threadIdx.x;
  const int64_t c_lo = static_cast<int64_t>(blockIdx.y) * c_per_block;
  const int64_t c_hi = min(c, c_lo + c_per_block);
  const bool in = i < n;
  // valid of shape (N,) decides for every candidate, and spares the read
  const bool row_ok =
      in && (valid == nullptr || valid_cstride != 0 || valid[i] != 0);
  uint32_t x[KR];
  if (K > 0 && mat_cstride == 0 && row_ok)
    load_row<KR>(mat + i * K, vec, x);

  const int64_t piece = masks != nullptr ? kMaskInts / k : c_hi - c_lo;
  for (int64_t c0 = c_lo; c0 < c_hi; c0 += piece) {
    const int64_t cn = min(piece, c_hi - c0);
    if (masks != nullptr) {
      __syncthreads();                 // the previous piece is consumed
      for (int64_t t = threadIdx.x; t < cn * k; t += kThreads)
        smask[t] = masks[c0 * k + t];
      __syncthreads();
    }
    if (!in) continue;
    for (int64_t cc = 0; cc < cn; ++cc) {
      const int64_t cand = c0 + cc;
      const bool ok =
          valid_cstride != 0 ? valid[cand * valid_cstride + i] != 0 : row_ok;
      uint2 res = make_uint2(0xFFFFFFFFu, 0xFFFFFFFFu);     // SIG_SENTINEL
      if (ok) {
        const int32_t* m = masks != nullptr ? smask + cc * k : nullptr;
        uint32_t lo = 0u;
        uint32_t hi = kSeedHi;
        if (K > 0) {
          if (mat_cstride != 0)
            load_row<KR>(mat + cand * mat_cstride + i * K, vec, x);
          uint32_t mk[KR];
          if (m != nullptr) load_mask<KR>(m, mk);
#pragma unroll
          for (int j = 0; j < KR; ++j) {
            // the unsigned multiply keeps the low 32 bits of the
            // reference's int32 masked stack
            uint32_t xv = x[j];
            if (m != nullptr) xv *= mk[j];
            lo = mm3_step(lo, xv);
            hi = mm3_step(hi, xv ^ 0xdeadbeefu);
          }
        } else {
          const int32_t* row = mat + cand * mat_cstride + i * k;
          for (int j = 0; j < k; ++j) {
            uint32_t xv = static_cast<uint32_t>(__ldg(row + j));
            if (m != nullptr) xv *= static_cast<uint32_t>(m[j]);
            lo = mm3_step(lo, xv);
            hi = mm3_step(hi, xv ^ 0xdeadbeefu);
          }
        }
        res = finish(hi, lo, k);
      }
      out[cand * n + i] = res;
    }
  }
}

template <int K>
void launch(const int32_t* mat, int64_t n, int k, int64_t mat_cstride,
            bool vec, const int32_t* masks, int64_t c, int64_t chunks,
            const uint8_t* valid, int64_t valid_cstride, uint2* out,
            cudaStream_t stream) {
  const int64_t per = (c + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads),
                  static_cast<unsigned>((c + per - 1) / per));
  sig_hash_kernel<K><<<grid, kThreads, 0, stream>>>(
      mat, n, k, mat_cstride, vec, masks, c, per, valid, valid_cstride, out);
}

}  // namespace

// mat:    int32, candidate c's rows start at mat + c * mat_cstride
//         (mat_cstride = 0 for a shared (N, K) parent, N * K for a stack)
// masks:  (C, K) int32 column mask or null
// valid:  (N,) or (C, N) bool bytes or null (valid_cstride 0 or N)
// chunks: candidate chunks along the second grid axis, 1..min(C, 65535)
// out:    (C, N, 2) uint32, [hi, lo] per row
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_sig_hash(const void* mat, int64_t n, int k,
                              int64_t mat_cstride, const void* masks,
                              int64_t c, int64_t chunks, const void* valid,
                              int64_t valid_cstride, void* out,
                              void* stream) {
  if (k < 1 || c < 1 || chunks < 1 || chunks > c || chunks > 65535 ||
      (masks != nullptr && k > kMaskInts))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* m = static_cast<const int32_t*>(mat);
  auto* mk = static_cast<const int32_t*>(masks);
  auto* v = static_cast<const uint8_t*>(valid);
  auto* o = static_cast<uint2*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  // every row (and every candidate's block of rows) starts at a multiple
  // of K int32 from the base, so the base's alignment decides
  const auto base = reinterpret_cast<uintptr_t>(mat);
  const bool vec = k % 4 == 0 ? base % 16 == 0 : k % 2 == 0 && base % 8 == 0;
  switch (k) {
#define SIG_CASE(KK)                                                        \
  case KK:                                                                  \
    launch<KK>(m, n, k, mat_cstride, vec, mk, c, chunks, v, valid_cstride,  \
               o, s);                                                       \
    break;
    SIG_CASE(2) SIG_CASE(4) SIG_CASE(8) SIG_CASE(16) SIG_CASE(32)
#undef SIG_CASE
    default:
      launch<0>(m, n, k, mat_cstride, false, mk, c, chunks, v, valid_cstride,
                o, s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}
