// pull_common.cuh: what the two BMO pull kernels (fused_epoch_pull.cu and
// block_pull.cu) share on NVIDIA Hopper (sm_90a): the block-slice arithmetic
// of one pull, read by a group of 8 lanes, the mbarrier and bulk-copy (TMA)
// primitives, and the "rows" schedule's staging of one corpus row in shared
// memory.
//
// One pull is the block mean of (x[arm, blk*block + j] - q[blk*block + j])^2
// (|.| for l1) over j < block, summed in fp32 whatever the input type. A
// group of 8 neighbouring lanes reads one slice with vector loads of up to
// 16 bytes, lane l taking vectors l, l + 8, ...: a group's load is 128
// contiguous bytes (one quarter-warp phase of shared memory, one line of
// device memory), and a warp serves four pulls at once. The group sums its
// lanes' partial sums with three xor shuffles, so every lane of the group
// holds the slice's sum.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace pull {

constexpr int kGroup = 8;            // lanes per pull
constexpr int kGroupsPerWarp = 32 / kGroup;
// bytes of one bulk copy when a row is staged; a row is copied in pieces
constexpr uint32_t kCopyChunk = 32768;

// a vector load of BYTES bytes
template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// This lane's share of one slice's distance terms: xr and qr point at the
// slice's first element (in shared or device memory), gl is the lane's
// index within its group. Every load is started before any term is summed.
template <typename T, int BLOCK, bool L1>
__device__ __forceinline__ float group_partial(const T* __restrict__ xr,
                                               const T* __restrict__ qr,
                                               int gl) {
  constexpr int SLICE_BYTES = BLOCK * (int)sizeof(T);
  constexpr int VEC_BYTES =
      SLICE_BYTES / kGroup < 16 ? SLICE_BYTES / kGroup : 16;
  constexpr int VEC = VEC_BYTES / (int)sizeof(T);
  constexpr int CHUNKS = SLICE_BYTES / (kGroup * VEC_BYTES);
  using V = typename Raw<VEC_BYTES>::type;
  V a[CHUNKS], b[CHUNKS];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int off = (c * kGroup + gl) * VEC;
    a[c] = *reinterpret_cast<const V*>(xr + off);
    b[c] = *reinterpret_cast<const V*>(qr + off);
  }
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const T* ae = reinterpret_cast<const T*>(&a[c]);
    const T* be = reinterpret_cast<const T*>(&b[c]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float diff = to_float(ae[e]) - to_float(be[e]);
      s += L1 ? fabsf(diff) : diff * diff;
    }
  }
  return s;
}

// Sum over the 8 lanes of each group; every lane of the warp must call it.
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
  for (int w = kGroup / 2; w > 0; w >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, w);
  return s;
}

// --- mbarriers and bulk copies ---------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// one arrival that also expects `bytes` more of transactions in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Waits until the barrier's phase of the given parity has completed. A wait
// that never ends (a fault in the pipeline) traps after some 2^26 polls, so
// it surfaces as a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred P1;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%1], %2;\n"
        "selp.u32 %0, 1, 0, P1;\n"
        "}\n" : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (n == (1u << 26)) __trap();
  }
}
// TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into this block's shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Thread 0 copies `bytes` (a multiple of 16) from src to dst in bulk copies
// of at most kCopyChunk, all completing on `bar`, which it arms for them.
__device__ __forceinline__ void copy_row(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  mbar_expect_tx(bar, bytes);
  for (uint32_t c = 0; c < bytes; c += kCopyChunk)
    bulk_copy(static_cast<char*>(dst) + c,
              static_cast<const char*>(src) + c, min(kCopyChunk, bytes - c),
              bar);
}

// --- the rows schedule: one corpus row staged once ---------------------------
//
// A block of the rows schedule owns one arm of a vector that every query
// shares, and has kRowsWarps warps: one 64 KB row (fp32 at d_pad 16,384)
// leaves room for three blocks on an SM, so one stages its row while two
// stream queries. The kernels are compiled for kRowsMinBlocks blocks an SM,
// so their registers (85 a thread at most) do not cut that to two.
constexpr int kRowsWarps = 8;
constexpr int kRowsMinBlocks = 3;

// Thread 0 copies row `arm` of x (d_pad values) into `row` on one barrier;
// an arm that is negative (a discarded lane) or out of range (flagged by
// its caller) is not read. Every thread returns once the row has landed.
template <typename T>
__device__ __forceinline__ void stage_row(T* row, const T* __restrict__ x,
                                          int64_t arm, int64_t n,
                                          int64_t d_pad, uint64_t* bar) {
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool reads = arm >= 0 && arm < n;
    copy_row(row, reads ? x + arm * d_pad : x,
             reads ? (uint32_t)(d_pad * (int64_t)sizeof(T)) : 0u, bar);
  }
  mbar_wait(bar, 0);
}

// The query a group of the rows schedule's walk takes at position p (its
// warp's base plus its group): the queries in order, four to a warp, one a
// group. A group past the last query takes the last one's place, so every
// lane runs the same iterations and the group sums' shuffles see the whole
// warp; it writes nothing.
__device__ __forceinline__ int64_t rows_query(int64_t p, int64_t Q) {
  return p < Q ? p : Q - 1;
}

// The first two block ids of a pair (0 where it reads nothing or T < 2),
// loaded one iteration ahead of their use: the ids come from device memory,
// and without this each iteration would wait for them before it could ask
// for its query slices.
template <typename IB>
__device__ __forceinline__ void first_ids(const IB* __restrict__ bl,
                                          int64_t T, bool reads, int64_t& i0,
                                          int64_t& i1) {
  i0 = reads ? (int64_t)bl[0] : 0;
  i1 = reads && T > 1 ? (int64_t)bl[1] : 0;
}

// Raises a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB; the launch that follows is refused if this fails.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace pull
