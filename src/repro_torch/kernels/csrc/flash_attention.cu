// GQA forward attention with an online softmax on the float32 CUDA cores,
// for float32 inputs (sm_90a).  bfloat16 inputs take the tensor-core kernel
// in flash_attention_sm90.cu: its products would need TF32 here, and TF32
// cannot meet float32's 1e-5.  Every product here is a true float32 FMA.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for float32.  That kernel walks a
// sequential KV grid axis and carries m, l and the accumulator in VMEM
// scratch between grid steps; here one block owns one (batch, q-head,
// 64-row query tile) and loops over the KV tiles itself, so nothing is
// carried between blocks.
//
// What bounds it: the FMAs, but only if shared memory keeps up.  Shared
// memory gives an SM 32 floats a clock to its threads and the FMA pipes
// take 128 a clock, so a thread must do 4 FMAs for every float it reads:
// an 8 x 8 register tile of each product, fed 8 + 8 floats a step.
//
// Layout: grid (cdiv(T, 64), Hq, B), 256 threads (8 warps), one block an
// SM.  The query tile lies in shared memory transposed (d-major), written
// once.  Keys come in tiles of 256; each tile streams through a two-slot
// cp.async ring as chunks: first K in slices of 32 d (256 keys x 32), then
// V in slices of 32 keys (32 x D), the next chunk always loading while
// this one is used, one barrier a chunk.
//  * S = QK^T: a warp owns 8 query rows, a lane 8 keys (lane + 32 j): an
//    8 x 8 tile of S in registers across the tile's K chunks.  Per 4 d it
//    reads 8 float4s of K (its keys) and 8 of Q^T (its rows, the same
//    words for the whole warp): 64 floats for 256 FMAs.
//  * Online softmax, once per 256 keys: a row's max and sum reduce over
//    its warp with xor shuffles; P goes to shared memory key-major, with
//    each row's rescale factor.
//  * O += PV: each thread owns an 8 x 8 (D = 256), 4 x 8 (D = 128) or
//    4 x 4 (D = 64) block of O, rescaled once per tile, fed per key by
//    float4 reads of P (its rows) and V (its columns): 16 floats for 64
//    FMAs at D = 256, 12 for 32 at D = 128.
// The KV head of q-head h is h / (Hq / Hkv), read in place.  Shared
// memory: 208.5 KB at D = 256, 174.5 KB at D = 128, 157.5 KB at D = 64.
//
// Masking: query row r sits at position qpos = r + S - T.  A key j is
// attended when j < S, and j <= qpos if causal, and j > qpos - window if a
// window is set.  KV tiles wholly outside that band are never loaded, nor
// are keys past the band's end (zero-filled) or V chunks past it.  A row
// with no key to attend gets l = 0 and writes 0.  Unlike the Pallas kernel
// this one masks j >= S itself instead of padding K with zeros, so
// causal=False on a ragged S matches the reference.
//
// Training asks for each row's log-sum-exp of its scaled scores too (the
// softmax normaliser its backward recomputes P from): lane 0 of a warp,
// which holds the row's m and reduced l, writes it in the epilogue into a
// (B, Hq, T) float32 tensor.  A null pointer launches the instantiation
// compiled without the store (kLse = false).
//
// Bound on an H100: 4 * Hq * D flops per attended (q, k) pair (QK^T and
// PV) against reading q, k, v and writing o once; at recurrentgemma-2b's
// prefill shape (8, 10, 2304, 256), window 2048, the operations bound it:
// 2.15e11 flops, 3.2 ms at the 67 TFLOP/s float32 rate of the CUDA cores
// these products run on.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 64;         // query rows per block
constexpr int kTK = 256;        // keys per KV tile
constexpr int kDC = 32;         // d per K chunk
constexpr int kVC = 32;         // keys per V chunk
constexpr int kThreads = 256;
constexpr int kQS = kTQ + 4;    // row stride of Q^T [d][row], P^T [key][row]
constexpr int kKS = kDC + 4;    // row stride of a K chunk [key][d]
constexpr float kNeg = -1e30f;
// the log-sum-exp written for a row with no key to attend: the backward's
// exp(score - lse) is then exactly 0 on every key of the row
constexpr float kEmptyLse = 1e30f;

// the O tile's split over the threads: RO rows x NV float4s per thread
template <int D>
struct OTile {
  static constexpr int RO = D >= 256 ? 8 : 4;       // rows per thread
  static constexpr int TR = kTQ / RO;               // row groups
  static constexpr int TC = kThreads / TR;          // column groups
  static constexpr int NV = D / (4 * TC);           // float4s per row
  static_assert(NV >= 1 && NV * 4 * TC == D && TC % 8 == 0, "O split");
};

// shared memory in floats: Q^T [D][kQS], P^T [kTK][kQS], two ring slots
// (a K or a V chunk each), the rows' rescale factors and final sums
template <int D>
struct Smem {
  static constexpr int kSlot =
      kTK * kKS > kVC * (D + 4) ? kTK * kKS : kVC * (D + 4);
  static constexpr int kFloats = D * kQS + kTK * kQS + 2 * kSlot + 2 * kTQ;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  // src-size 0 writes 16 zero bytes and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// K chunk: keys [k0, k0 + kTK) x d [d0, d0 + kDC) into [kTK][kKS], keys
// >= lim zero-filled; 8 threads read one key's 128 contiguous bytes
template <int D>
__device__ __forceinline__ void load_k_chunk(float* dst, const float* head,
                                             int k0, int d0, int lim,
                                             int tid) {
  constexpr int kPieces = kDC / 4;
#pragma unroll
  for (int it = 0; it < kTK * kPieces / kThreads; ++it) {
    const int i = it * kThreads + tid;
    const int r = i / kPieces;
    const int c = (i % kPieces) * 4;
    const bool in = k0 + r < lim;
    cp_async16(dst + r * kKS + c,
               in ? head + static_cast<int64_t>(k0 + r) * D + d0 + c : head,
               in);
  }
}

// V chunk: keys [k0, k0 + kVC), all of D, into [kVC][D + 4], keys >= lim
// zero-filled
template <int D>
__device__ __forceinline__ void load_v_chunk(float* dst, const float* head,
                                             int k0, int lim, int tid) {
  constexpr int kPieces = D / 4;
  static_assert(kVC * kPieces % kThreads == 0, "whole rounds of pieces");
#pragma unroll
  for (int it = 0; it < kVC * kPieces / kThreads; ++it) {
    const int i = it * kThreads + tid;
    const int r = i / kPieces;
    const int c = (i % kPieces) * 4;
    const bool in = k0 + r < lim;
    cp_async16(dst + r * (D + 4) + c,
               in ? head + static_cast<int64_t>(k0 + r) * D + c : head, in);
  }
}

// S[i][j] += Q^T[d][row i] K[key j][d] over a K chunk's 32 d, for this
// lane's first J key groups (keys lane + 32 j) and the warp's 8 rows: per
// 4 d, 8 float4s of K (one per key) and 8 of Q^T (one word for the warp)
template <int J>
__device__ __forceinline__ void qk_chunk(const float* kr, const float* qr,
                                         float (&sc)[8][8]) {
#pragma unroll 4
  for (int d = 0; d < kDC; d += 4) {
    float4 kv[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      kv[j] = *reinterpret_cast<const float4*>(kr + j * 32 * kKS + d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 qa = *reinterpret_cast<const float4*>(qr + (d + e) * kQS);
      const float4 qc =
          *reinterpret_cast<const float4*>(qr + (d + e) * kQS + 4);
      const float qq[8] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float kk = e == 0 ? kv[j].x
                       : e == 1 ? kv[j].y
                       : e == 2 ? kv[j].z
                                : kv[j].w;
#pragma unroll
        for (int i = 0; i < 8; ++i) sc[i][j] = fmaf(qq[i], kk, sc[i][j]);
      }
    }
  }
}

template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int hq, int hkv, int t, int s,
                 float scale, int causal, int window) {
  constexpr int kND = D / kDC;          // K chunks per tile
  using O = OTile<D>;
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // Q^T [D][kQS]
  float* pt = qt + D * kQS;                      // P^T [kTK][kQS]
  float* slot0 = pt + kTK * kQS;
  float* slot1 = slot0 + Smem<D>::kSlot;
  float* corr_s = slot1 + Smem<D>::kSlot;      // per row: tile rescale
  float* l_s = corr_s + kTQ;                     // per row: final sum

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int q0 = iq * kTQ;
  const int off = s - t;
  const float* qb = q + (static_cast<int64_t>(b) * hq + h) * t * D;
  const float* kb = k + (static_cast<int64_t>(b) * hkv + hk) * s * D;
  const float* vb = v + (static_cast<int64_t>(b) * hkv + hk) * s * D;
  float* ob = out + (static_cast<int64_t>(b) * hq + h) * t * D;

  // O layout: a warp is 4 row groups x 8 column groups
  constexpr int kWarpCols = O::TC / 8;
  const int rgo = (warp / kWarpCols) * 4 + (lane >> 3);
  const int cgo = (warp % kWarpCols) * 8 + (lane & 7);

  // the band of keys any row of this tile may attend: [k_begin, k_end)
  const int q_first = q0 + off;
  const int q_last = min(q0 + kTQ, t) - 1 + off;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = causal ? min(s, q_last + 1) : s;

  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
  }
  float acc[O::RO][4 * O::NV];
#pragma unroll
  for (int i = 0; i < O::RO; ++i)
#pragma unroll
    for (int c = 0; c < 4 * O::NV; ++c) acc[i][c] = 0.f;

  if (k_begin < k_end) {
    load_k_chunk<D>(slot0, kb, k_begin, 0, k_end, tid);
    cp_async_commit();
    // Q^T, once: every load in flight before the first store;
    // consecutive threads take consecutive rows, so the transposing stores
    // meet no bank conflict
    constexpr int kQLoads = kTQ * D / 4 / kThreads;
    float4 x[kQLoads];
#pragma unroll
    for (int it = 0; it < kQLoads; ++it) {
      const int i = it * kThreads + tid;
      const int r = i % kTQ;
      x[it] = q0 + r < t ? *reinterpret_cast<const float4*>(
                               qb + static_cast<int64_t>(q0 + r) * D +
                               (i / kTQ) * 4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int it = 0; it < kQLoads; ++it) {
      const int i = it * kThreads + tid;
      const int r = i % kTQ;
      const int c = (i / kTQ) * 4;
      qt[(c + 0) * kQS + r] = x[it].x;
      qt[(c + 1) * kQS + r] = x[it].y;
      qt[(c + 2) * kQS + r] = x[it].z;
      qt[(c + 3) * kQS + r] = x[it].w;
    }
  }

  const float scale2 = scale * 1.4426950408889634f;   // and log2 e
  int ctr = 0;                          // chunks consumed: the ring's turn
  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    const int n_vc = (min(kTK, k_end - k0) + kVC - 1) / kVC;
    const int n_kg = (min(kTK, k_end - k0) + 31) / 32;   // 32-key groups

    float sc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;

    for (int dc = 0; dc < kND; ++dc, ++ctr) {
      // this chunk landed; every thread is done with the other slot
      cp_async_wait_all();
      __syncthreads();
      const float* cur = (ctr & 1) ? slot1 : slot0;
      float* nxt = (ctr & 1) ? slot0 : slot1;
      if (dc + 1 < kND)
        load_k_chunk<D>(nxt, kb, k0, (dc + 1) * kDC, k_end, tid);
      else
        load_v_chunk<D>(nxt, vb, k0, k_end, tid);
      cp_async_commit();

      // key groups past the band's end hold only masked keys: skip them
      const float* kr = cur + lane * kKS;
      const float* qr = qt + dc * kDC * kQS + warp * 8;
      if (n_kg > 4)
        qk_chunk<8>(kr, qr, sc);
      else if (n_kg > 2)
        qk_chunk<4>(kr, qr, sc);
      else
        qk_chunk<2>(kr, qr, sc);
    }

    // online softmax over the tile's keys, rows warp * 8 + i, in base 2
    // (m holds max score * scale * log2 e); a masked score becomes kNeg and
    // its weight 0, and a tile inside every row's band skips the mask
    const bool inside = k0 + kTK <= s &&
                        (!causal || k0 + kTK - 1 <= q_first) &&
                        (window <= 0 || k0 > q_last - window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qpos = q0 + warp * 8 + i + off;
      bool ok[8];
      float rmax = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + lane + 32 * j;
        ok[j] = inside || (kpos < s && (!causal || kpos <= qpos) &&
                           (window <= 0 || kpos > qpos - window));
        sc[i][j] = ok[j] ? sc[i][j] * scale2 : kNeg;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = exp2f(m[i] - m_new);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = ok[j] ? exp2f(sc[i][j] - m_new) : 0.f;
        rsum += sc[i][j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
      if (lane == 0) corr_s[warp * 8 + i] = corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* row = pt + (lane + 32 * j) * kQS + warp * 8;
      *reinterpret_cast<float4*>(row) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
      *reinterpret_cast<float4*>(row + 4) =
          make_float4(sc[4][j], sc[5][j], sc[6][j], sc[7][j]);
    }

    for (int vc = 0; vc < n_vc; ++vc, ++ctr) {
      // this V chunk landed and P is written; the other slot is free
      cp_async_wait_all();
      __syncthreads();
      const float* cur = (ctr & 1) ? slot1 : slot0;
      float* nxt = (ctr & 1) ? slot0 : slot1;
      if (vc + 1 < n_vc)
        load_v_chunk<D>(nxt, vb, k0 + (vc + 1) * kVC, k_end, tid);
      else if (k0 + kTK < k_end)
        load_k_chunk<D>(nxt, kb, k0 + kTK, 0, k_end, tid);
      cp_async_commit();

      if (vc == 0) {
#pragma unroll
        for (int i = 0; i < O::RO; ++i) {
          const float c = corr_s[rgo * O::RO + i];
#pragma unroll
          for (int e = 0; e < 4 * O::NV; ++e) acc[i][e] *= c;
        }
      }
      const float* pr0 = pt + vc * kVC * kQS + rgo * O::RO;
#pragma unroll 8
      for (int kk = 0; kk < kVC; ++kk) {
        float pr[O::RO];
#pragma unroll
        for (int i = 0; i < O::RO; i += 4) {
          const float4 x =
              *reinterpret_cast<const float4*>(pr0 + kk * kQS + i);
          pr[i] = x.x; pr[i + 1] = x.y; pr[i + 2] = x.z; pr[i + 3] = x.w;
        }
#pragma unroll
        for (int hh = 0; hh < O::NV; ++hh) {
          const float4 vv = *reinterpret_cast<const float4*>(
              cur + kk * (D + 4) + hh * 4 * O::TC + cgo * 4);
#pragma unroll
          for (int i = 0; i < O::RO; ++i) {
            acc[i][hh * 4 + 0] = fmaf(pr[i], vv.x, acc[i][hh * 4 + 0]);
            acc[i][hh * 4 + 1] = fmaf(pr[i], vv.y, acc[i][hh * 4 + 1]);
            acc[i][hh * 4 + 2] = fmaf(pr[i], vv.z, acc[i][hh * 4 + 2]);
            acc[i][hh * 4 + 3] = fmaf(pr[i], vv.w, acc[i][hh * 4 + 3]);
          }
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      l_s[warp * 8 + i] = l[i];
      // the row's log-sum-exp of its scaled scores, natural log: m is in
      // base 2; a row with no key gets kEmptyLse
      const int r = q0 + warp * 8 + i;
      if (kLse && r < t)
        lse[(static_cast<int64_t>(b) * hq + h) * t + r] =
            l[i] > 0.f ? (m[i] + log2f(l[i])) * 0.6931471805599453f
                       : kEmptyLse;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < O::RO; ++i) {
    const int r = q0 + rgo * O::RO + i;
    if (r >= t) continue;
    const float li = l_s[rgo * O::RO + i];
#pragma unroll
    for (int hh = 0; hh < O::NV; ++hh) {
      float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
      if (li > 0.f)
        o = make_float4(acc[i][hh * 4 + 0] / li, acc[i][hh * 4 + 1] / li,
                        acc[i][hh * 4 + 2] / li, acc[i][hh * 4 + 3] / li);
      *reinterpret_cast<float4*>(ob + static_cast<int64_t>(r) * D +
                                 hh * 4 * O::TC + cgo * 4) = o;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           void* lse, int64_t b, int hq, int hkv, int64_t t, int64_t s,
           float scale, int causal, int window, cudaStream_t stream) {
  const int smem = Smem<D>::kFloats * static_cast<int>(sizeof(float));
  // without an LSE tensor, the kernel compiled without its store
  auto kernel = lse != nullptr ? flash_fwd_kernel<D, true>
                               : flash_fwd_kernel<D, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((t + kTQ - 1) / kTQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<float*>(lse), hq, hkv,
      static_cast<int>(t), static_cast<int>(s), scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, T, D); k, v: (B, Hkv, S, D); out: (B, Hq, T, D), all
// contiguous float32 starting on 16-byte boundaries.  D in {64, 128, 256};
// window <= 0 means none.  lse: null, or (B, Hq, T) float32 to receive each
// row's log-sum-exp of its scaled scores (1e30 for a row with no key).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, void* lse,
                                     int64_t b, int hq, int hkv, int64_t t,
                                     int64_t s, int d, float scale,
                                     int causal, int window, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, lse, b, hq, hkv, t, s, scale, causal,
                        window, st);
    case 128:
      return launch<128>(q, k, v, out, lse, b, hq, hkv, t, s, scale, causal,
                         window, st);
    case 256:
      return launch<256>(q, k, v, out, lse, b, hq, hkv, t, s, scale, causal,
                         window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
