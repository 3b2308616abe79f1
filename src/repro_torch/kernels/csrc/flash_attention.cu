// GQA forward attention with an online softmax on the float32 CUDA cores,
// for float32 inputs (sm_90a).  bfloat16 inputs take the tensor-core kernel
// in flash_attention_sm90.cu: its products would need TF32 here, and TF32
// cannot meet float32's 1e-5.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for float32.  That kernel walks a
// sequential KV grid axis and carries m, l and the accumulator in VMEM
// scratch between grid steps; here one block owns one (batch, q-head,
// 64-row query tile) and loops over the KV tiles itself, so nothing is
// carried between blocks.
//
// Layout: grid (cdiv(T, 64), Hq, B), 256 threads as a 16 x 16 grid.  The
// query tile (64 x D) stays in shared memory for the whole loop; each
// 32-key K and V tile is staged in shared memory.  A thread owns 4 query
// rows: for the scores it holds a 4 x 2 micro-tile (keys tc and tc + 16),
// for the output a 4 x D/16 accumulator in registers (64 floats at
// D = 256), columns tc + 16 j.  The 16 threads sharing a row reduce its max
// and sum with xor shuffles inside their half-warp.  The KV head of q-head
// h is h / (Hq / Hkv), read in place.
//
// Masking: query row r sits at position qpos = r + S - T.  A key j is
// attended when j < S, and j <= qpos if causal, and j > qpos - window if a
// window is set.  KV tiles wholly outside that band are never loaded.  A
// row with no key to attend gets l = 0 and writes 0.  Unlike the Pallas
// kernel this one masks j >= S itself instead of padding K with zeros,
// so causal=False on a ragged S matches the reference.
//
// Bound on an H100: 4 * Hq * D flops per attended (q, k) pair (QK^T and
// PV) against reading q, k, v and writing o once; at recurrentgemma-2b's
// prefill shape (8, 10, 2304, 256), window 2048, the operations bound it:
// 2.15e11 flops, 3.2 ms at the 67 TFLOP/s float32 rate of the CUDA cores
// these products run on.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTQ = 64;        // query rows per block
constexpr int kTK = 32;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPS = kTK + 1;   // padded row stride of the P tile
constexpr float kNeg = -1e30f;

template <int D>
constexpr int smem_floats() {
  // Q [kTQ][D], K [kTK][D + 4], V [kTK][D], P [kTQ][kPS]
  return kTQ * D + kTK * (D + 4) + kTK * D + kTQ * kPS;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int hq,
                 int hkv, int t, int s, float scale, int causal,
                 int window) {
  constexpr int kKS = D + 4;     // K row stride: float4 reads of rows
                                 // tc and tc + 16 hit distinct banks
  constexpr int kCols = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kTQ * D;
  float* vs = ks + kTK * kKS;
  float* ps = vs + kTK * D;

  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int tr = tid >> 4;
  const int tc = tid & 15;
  const int q0 = iq * kTQ;
  const int off = s - t;
  const float* qb = q + (static_cast<int64_t>(b) * hq + h) * t * D;
  const float* kb = k + (static_cast<int64_t>(b) * hkv + hk) * s * D;
  const float* vb = v + (static_cast<int64_t>(b) * hkv + hk) * s * D;
  float* ob = out + (static_cast<int64_t>(b) * hq + h) * t * D;

  for (int i = tid; i < kTQ * D; i += kThreads) {
    const int r = i / D;
    qs[i] = q0 + r < t ? qb[static_cast<int64_t>(q0) * D + i] : 0.f;
  }

  // the band of keys any row of this tile may attend
  const int q_first = q0 + off;
  const int q_last = min(q0 + kTQ, t) - 1 + off;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = causal ? min(s, q_last + 1) : s;

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kTK) {
    __syncthreads();  // the previous tile's K, V and P are consumed
    for (int i = tid; i < kTK * D; i += kThreads) {
      const int r = i / D;
      const int c = i - r * D;
      const int64_t src = static_cast<int64_t>(k0 + r) * D + c;
      const bool in = k0 + r < s;
      ks[r * kKS + c] = in ? kb[src] : 0.f;
      vs[i] = in ? vb[src] : 0.f;
    }
    __syncthreads();

    // scores for rows tr*4 + i, keys tc and tc + 16
    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(&ks[tc * kKS + d]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&ks[(tc + 16) * kKS + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qq =
            *reinterpret_cast<const float4*>(&qs[(tr * 4 + i) * D + d]);
        sc[i][0] += qq.x * ka.x + qq.y * ka.y + qq.z * ka.z + qq.w * ka.w;
        sc[i][1] += qq.x * kc.x + qq.y * kc.y + qq.z * kc.z + qq.w * kc.w;
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + tr * 4 + i + off;
      bool ok[2];
      float rmax = kNeg;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kpos = k0 + tc + 16 * j;
        ok[j] = kpos < s && (!causal || kpos <= qpos) &&
                (window <= 0 || kpos > qpos - window);
        sc[i][j] = ok[j] ? sc[i][j] * scale : kNeg;
        rmax = fmaxf(rmax, sc[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
      const float m_new = fmaxf(m[i], rmax);
      const float corr = expf(m[i] - m_new);
      const float p0 = ok[0] ? expf(sc[i][0] - m_new) : 0.f;
      const float p1 = ok[1] ? expf(sc[i][1] - m_new) : 0.f;
      float rsum = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
      ps[(tr * 4 + i) * kPS + tc] = p0;
      ps[(tr * 4 + i) * kPS + tc + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kTK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(tr * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[kk * D + tc + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + tr * 4 + i;
    if (r >= t) continue;
    const bool any = l[i] > 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      ob[static_cast<int64_t>(r) * D + tc + 16 * c] =
          any ? acc[i][c] / l[i] : 0.f;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int hq, int hkv, int64_t t, int64_t s, float scale,
           int causal, int window, cudaStream_t stream) {
  const int smem = smem_floats<D>() * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((t + kTQ - 1) / kTQ),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), hq, hkv,
      static_cast<int>(t), static_cast<int>(s), scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, T, D); k, v: (B, Hkv, S, D); out: (B, Hq, T, D), all
// contiguous float32.  D in {64, 256}; window <= 0 means none.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int64_t b,
                                     int hq, int hkv, int64_t t, int64_t s,
                                     int d, float scale, int causal,
                                     int window, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, b, hq, hkv, t, s, scale, causal, window,
                        st);
    case 256:
      return launch<256>(q, k, v, out, b, hq, hkv, t, s, scale, causal,
                         window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
