// GQA forward attention on Hopper's tensor cores (sm_90a), for bfloat16.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel) for bf16 inputs; float32 inputs keep the
// CUDA-core kernel in flash_attention.cu (TF32 products could not meet
// float32's 1e-5).  The Pallas kernel walks a sequential KV grid axis and
// carries m, l and the accumulator in VMEM scratch between grid steps; here
// one block owns one (batch, q-head, 128-row query tile) and loops over the
// KV tiles itself, so nothing is carried between blocks.
//
// Bound on an H100: 4 * D flops per attended (q, k) pair and head (QK^T and
// PV) against one read of q, k, v and one write of o.  At recurrentgemma-2b's
// prefill (8, 10, 2304, 256), window 2048, that is 2.15e11 flops, 0.217 ms
// at the 989 TFLOP/s bf16 tensor-core rate, against 0.062 ms for the
// bytes: the operations bound it, so both products run as wgmma.
//
// Layout: grid (cdiv(T, 128), Hq, B), 384 threads in three warpgroups.
//  - Warpgroup 2 is the producer: one thread starts TMA loads of the Q tile
//    (once) and of 64-key K and V tiles into a two-stage ring, each stage
//    guarded by a "full" mbarrier (TMA bytes arrived) and an "empty" one
//    (both consumers done with it).  It gives its registers up
//    (setmaxnreg 24) to the consumers (240).
//  - Warpgroups 0 and 1 each own 64 query rows.  Per KV tile: S = Q K^T as
//    16 wgmma.m64n64k16 (both operands in shared memory, K-major), an
//    online softmax on the S registers (exp2 of log2e-scaled scores; m and
//    the partial l per thread, float32), P rounded to bf16 in registers as
//    the A operand of O += P V (wgmma.m64nDk16, V MN-major: the transpose
//    bit of 16-bit types).  O stays in registers, float32: D / 2 of them a
//    thread (32, 64 or 128 at D = 64, 128, 256).  Shared memory holds the
//    Q tile and two stages of K and V: 48, 96 or 192 KB.
//  - Epilogue: O / l in bf16 into the warpgroup's own rows of the Q tile
//    (no longer read), then a TMA store that clips rows >= T.
//
// Every tile sits in shared memory as 64-column sub-tiles (rows x 128
// bytes, 128-byte swizzle, as TMA writes them), so D = 256 is four
// sub-tiles and D = 128 two; the wgmma descriptors step 32 bytes per
// 16-wide k slice inside a sub-tile (K-major) or 16 rows per k slice
// (MN-major V, with its sub-tiles 64 rows apart as its leading byte
// offset).  The tensor
// maps are 3-D (D, rows, batch * heads), so a ragged tile is zero-filled
// or clipped at its own head's edge, never the next head's rows.
//
// Masking: query row r sits at qpos = r + S - T.  A key j is attended when
// j < S, and j <= qpos if causal, and j > qpos - window if a window is set;
// the per-element test runs only on tiles that cross one of those edges.
// KV tiles wholly outside the block's band are never loaded.  A row with no
// key to attend ends with l = 0 and writes 0.  l sums the float32 weights;
// PV uses them rounded to bf16 (a relative change of at most 2^-9 per
// weight).
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>

namespace {

constexpr int kBM = 128;      // query rows per block: two warpgroups of 64
constexpr int kBN = 64;       // keys per KV tile
constexpr int kStages = 2;    // KV ring depth
constexpr int kThreads = 384;
constexpr int kSub = 64;      // columns per 128-byte swizzled sub-tile

template <int D>
struct Smem {
  __nv_bfloat16 q[D / kSub][kBM * kSub];
  __nv_bfloat16 k[kStages][D / kSub][kBN * kSub];
  __nv_bfloat16 v[kStages][D / kSub][kBN * kSub];
  uint64_t q_full;
  uint64_t k_full[kStages], v_full[kStages];
  uint64_t k_empty[kStages], v_empty[kStages];
};

template <int D>
constexpr int smem_bytes() { return sizeof(Smem<D>) + 1024; }  // + alignment

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// returns once the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// between an asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]; A in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]; A in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 256] += A[64 x 16] B[16 x 256]; A in registers, B MN-major in
// shared memory.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127 "
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap to, int hq, int hkv,
                  int t, int s, float scale_log2, int causal, int window) {
  constexpr int kSubs = D / kSub;
  constexpr int kKvBytes = kBN * D * 2;
  constexpr uint32_t kSubKvBytes = kBN * kSub * 2;  // V's sub-tile stride
  extern __shared__ uint8_t smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBM;
  const int off = s - t;
  // the band of keys any row of this tile may attend, in whole KV tiles
  const int q_first = q0 + off;
  const int q_last = min(q0 + kBM, t) - 1 + off;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int k_end = causal ? min(s, q_last + 1) : s;
  const int n_first = k_begin / kBN;
  const int n_tiles =
      k_end > k_begin ? (k_end + kBN - 1) / kBN - n_first : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&sm.k_full[i], 1);
      mbar_init(&sm.v_full[i], 1);
      mbar_init(&sm.k_empty[i], 2);  // one arrival per consumer warpgroup
      mbar_init(&sm.v_empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // producer: from here on it never meets the consumers at a barrier
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x == 256 && n_tiles > 0) {
      const int qh = b * hq + h;
      const int kh = b * hkv + h / (hq / hkv);
      mbar_expect_tx(&sm.q_full, kBM * D * 2);
#pragma unroll
      for (int c = 0; c < kSubs; ++c)
        tma_load(sm.q[c], &tq, &sm.q_full, c * kSub, q0, qh);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        const int ph = (i / kStages) & 1;
        const int k0 = (n_first + i) * kBN;
        mbar_wait(&sm.k_empty[st], ph ^ 1);
        mbar_expect_tx(&sm.k_full[st], kKvBytes);
#pragma unroll
        for (int c = 0; c < kSubs; ++c)
          tma_load(sm.k[st][c], &tk, &sm.k_full[st], c * kSub, k0, kh);
        mbar_wait(&sm.v_empty[st], ph ^ 1);
        mbar_expect_tx(&sm.v_full[st], kKvBytes);
#pragma unroll
        for (int c = 0; c < kSubs; ++c)
          tma_load(sm.v[st][c], &tv, &sm.v_full[st], c * kSub, k0, kh);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int g = (tid % 32) / 4;   // accumulator row group of this thread
    const int tc = tid % 4;         // its column pair
    const int rw = wg * 64;         // first row of this warpgroup
    // this thread's two rows (qpos of accumulator rows g and g + 8)
    const int qpos0 = q0 + rw + warp * 16 + g + off;
    const int wq_first = q0 + rw + off;
    const int wq_last = wq_first + 63;
    const uint64_t dq = gmma_desc(sm.q[0] + rw * kSub, 16, 1024);

    float o[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.f, 0.f};  // this thread's partial row sums
    if (n_tiles > 0) mbar_wait(&sm.q_full, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const int ph = (i / kStages) & 1;
      const int k0 = (n_first + i) * kBN;

      // S = Q K^T: 16-wide k slices, 32 bytes apart inside a sub-tile
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.f;
      const uint64_t dk = gmma_desc(sm.k[st][0], 16, 1024);
      mbar_wait(&sm.k_full[st], ph);
      pin(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t step = (kk % 4) * 32;
        wgmma_ss_n64(sc, dq + (((kk / 4) * kBM * kSub * 2 + step) >> 4),
                     dk + (((kk / 4) * kBN * kSub * 2 + step) >> 4), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(sc);
      if (tid == 0) mbar_arrive(&sm.k_empty[st]);

      // accumulator element j: row g + 8 ((j >> 1) & 1), key 8 (j / 4) +
      // 2 tc + (j & 1)
      const bool edge = k0 + kBN > s || (causal && k0 + kBN - 1 > wq_first) ||
                        (window > 0 && k0 <= wq_last - window);
      if (edge) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int kpos = k0 + (j / 4) * 8 + 2 * tc + (j & 1);
          const int qpos = qpos0 + ((j >> 1) & 1) * 8;
          const bool ok = kpos < s && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          if (!ok) sc[j] = -CUDART_INF_F;
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < 32; ++j)
        mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
      float ms[2], corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // the four threads of a quad share a row
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        ms[r] = mx[r] == -CUDART_INF_F ? 0.f : mx[r] * scale_log2;
        corr[r] = exp2f(m[r] * scale_log2 - ms[r]);  // 0 while m = -inf
        m[r] = mx[r];
        l[r] *= corr[r];
      }
      // P in bf16 as the A operand of the next products: its k slice kk
      // is accumulator elements 8 kk .. 8 kk + 7, in order
      uint32_t pf[kBN / 16][4];
#pragma unroll
      for (int j = 0; j < 32; j += 2) {
        const int r = (j >> 1) & 1;
        const float p0 = exp2f(fmaf(sc[j], scale_log2, -ms[r]));
        const float p1 = exp2f(fmaf(sc[j + 1], scale_log2, -ms[r]));
        l[r] += p0 + p1;
        pf[j / 8][(j % 8) / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];

      // O += P V: 16-key slices, 16 rows of 128 bytes apart
      const uint64_t dv = gmma_desc(sm.v[st][0], kSubKvBytes, 1024);
      mbar_wait(&sm.v_full[st], ph);
      pin(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        if constexpr (D == 256)
          wgmma_rs_n256(o, pf[kk], dv + ((kk * 16 * 128) >> 4));
        else if constexpr (D == 128)
          wgmma_rs_n128(o, pf[kk], dv + ((kk * 16 * 128) >> 4));
        else
          wgmma_rs_n64(o, pf[kk], dv + ((kk * 16 * 128) >> 4));
      }
      wgmma_commit();
      wgmma_wait_all();
      pin(o);
      if (tid == 0) mbar_arrive(&sm.v_empty[st]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
    }
    // O / l in bf16 into this warpgroup's rows of the Q tile, in the
    // swizzled layout TMA reads: element (r, c) of a sub-tile lies at byte
    // r * 128 + ((c / 8) ^ (r % 8)) * 16 + (c % 8) * 2
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      // columns 8 (j / 4) + 2 tc, + 1: sub-tile j / 32, 16-byte chunk
      // (j / 4) % 8 of the row
      const int r = warp * 16 + g + 8 * ((j >> 1) & 1);
      uint8_t* sub = reinterpret_cast<uint8_t*>(sm.q[j / 32] + rw * kSub);
      *reinterpret_cast<uint32_t*>(sub + r * 128 +
                                   ((((j / 4) % 8) ^ (r % 8)) * 16) + tc * 4) =
          pack_bf16(o[j] * inv[(j >> 1) & 1], o[j + 1] * inv[(j >> 1) & 1]);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < kSubs; ++c)
        tma_store(&to, sm.q[c] + rw * kSub, c * kSub, q0 + rw, b * hq + h);
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's tensor-map encoder, looked up once at run time so that the
// library links against the CUDA runtime alone.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// A 3-D map (D, rows, heads) of a contiguous bf16 tensor, boxes of 64
// columns x box_rows rows of one head, 128-byte swizzle, zero fill.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int d,
            int64_t rows, int64_t heads, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(d) * 2,
                                 static_cast<cuuint64_t>(rows * d) * 2};
  const cuuint32_t box[3] = {kSub, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t b, int hq, int hkv, int64_t t, int64_t s, float scale,
           int causal, int window, cudaStream_t stream) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorSharedObjectSymbolNotFound);
  CUtensorMap mq, mk, mv, mo;
  if (!encode(fn, &mq, q, D, t, b * hq, kBM) ||
      !encode(fn, &mk, k, D, s, b * hkv, kBN) ||
      !encode(fn, &mv, v, D, s, b * hkv, kBN) ||
      !encode(fn, &mo, out, D, t, b * hq, kBM / 2))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = flash_sm90_kernel<D>;
  const int smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((t + kBM - 1) / kBM),
                  static_cast<unsigned>(hq), static_cast<unsigned>(b));
  kernel<<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, mo, hq, hkv, static_cast<int>(t), static_cast<int>(s),
      scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: (B, Hq, T, D); k, v: (B, Hkv, S, D); out: (B, Hq, T, D), all
// contiguous bfloat16 with 16-byte-aligned bases.  D in {64, 128, 256};
// window <= 0 means none.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int repro_flash_attention_sm90(const void* q, const void* k,
                                          const void* v, void* out, int64_t b,
                                          int hq, int hkv, int64_t t,
                                          int64_t s, int d, float scale,
                                          int causal, int window,
                                          void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, b, hq, hkv, t, s, scale, causal, window,
                        st);
    case 128:
      return launch<128>(q, k, v, out, b, hq, hkv, t, s, scale, causal,
                         window, st);
    case 256:
      return launch<256>(q, k, v, out, b, hq, hkv, t, s, scale, causal,
                         window, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
