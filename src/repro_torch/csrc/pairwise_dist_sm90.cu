// pairwise_dist_sm90: exact squared l2 distances on Hopper's tensor cores
// (sm_90a), for the tiled schedule (more than 4 queries) of the exact oracle.
//
// Replaces the TPU kernel src/repro/kernels/pairwise_dist.py,
// pairwise_dist_pallas / _dist_kernel, in its "l2_dot" form (the one that
// src/repro/kernels/ops.py picks for l2 on hardware). l1, l2 with at most 4
// queries, and rows whose stride is not a multiple of 16 bytes (d % 4 != 0)
// run the CUDA-core kernel in pairwise_dist.cu.
//
// What it computes. out[q, r] = ||q||^2 + ||x_r||^2 - 2 q.x_r for qs (Q, d)
// and x (n, d) fp32, output (Q, n) fp32, then an exact repair of every entry
// where that form could lose more than 1e-4 of its value to cancellation.
//
//  * Norms: fp32 sums of squares on the CUDA cores, compensated (Kahan).
//  * Cross term, split TF32 ("3xTF32"): a = a_hi + a_lo with
//    a_hi = cvt.rna.tf32(a) and a_lo = a - a_hi (exact in fp32), and
//    q.x ~ q_hi.x_hi + q_hi.x_lo + q_lo.x_hi, three wgmma .tf32 products
//    into fp32. This is not a silent drop to TF32: each term keeps about 21
//    of fp32's 24 bits.
//  * Accumulation: each 32-column slice is summed by the tensor cores into a
//    fresh accumulator (12 wgmma steps), then added into an fp32 master sum
//    on the CUDA cores (round to nearest). The tensor cores' own fp32
//    accumulation is not IEEE round-to-nearest at every step (it truncates),
//    so its error is biased; keeping each such run to 12 steps keeps that
//    bias small however long d is.
//
// Error analysis (u = 2^-24; S = ||q||^2 + ||x||^2; sum|ab| <= S/2):
//  * products: |a_lo| <= 2^-11 |a|, and the tensor cores read a_lo as TF32,
//    truncating it by less than 2^-10 |a_lo|, so each of the two cross
//    products is off by at most 2^-21 |a b| and the dropped a_lo b_lo is at
//    most 2^-22 |a b|: 2.5 * 2^-21 |a b| a term. Over the sum, times the 2
//    of -2 q.x: at most 2.5 * 2^-21 S = 1.19e-6 S, a worst case that needs
//    every term's error to share a sign (their signs follow the residuals').
//  * slice sums: 12 truncating steps, each off by up to an ulp of the
//    slice's running sum and by half of one on average, biased toward zero.
//    The running sum grows to the slice's own sum, so the bias is about 3
//    ulps of each slice's sum |ab|: some 4e-7 S in all, whatever d is.
//  * norms (compensated), S itself and the final subtraction: a few u S.
//  * master sum: d / 32 round-to-nearest additions, whose errors are
//    unbiased and independent, a random walk of standard deviation about
//    u sqrt(d / 32) S.
// gamma, the error per unit of S, bounds the d-independent parts by 2^-19
// (1.9e-6, above the products' worst case and the slices' bias together)
// and takes the master sum at two standard deviations:
//    gamma(d) = 2^-19 + 2^-23 sqrt(d / 32),
// 4.2e-6 at d = 12,288 and 4.6e-6 at d = 16,384. chip_smoke.py checks it on
// the card: the largest |error| / S of the unrepaired form against a
// float64 brute force, on randn data, x against itself, near-duplicates, a
// common offset of 100 and the oracle's clustered corpus, must stay under
// gamma (1.44e-6 at d = 12,288 on an H100 when this was written, 4.9e-7 at
// d = 128).
//
// The repair. Every entry with value <= (gamma / 1e-4) * S is flagged: only
// there can an error of gamma S exceed 1e-4 of the value. The flagged (q, r)
// pairs go to a device list through a warp-aggregated atomic counter, and a
// second kernel recomputes each one in the difference form, sum (q - x)^2, on
// the CUDA cores, one warp a pair, and overwrites it. Every entry is then
// within 1e-4 of its exact value, relatively, and x against itself gives
// exactly 0.0 on the diagonal. Each call adds its count of flagged pairs to
// a running total on the device.
//
// What bounds it on this card. Operations: 3 TF32 products of 2 flops per
// (q, r, j) term, 6 Q n d flops, at 495 TFLOP/s: 3.81 ms at the oracle's
// shape (256 x 100,000 x 12,288), against 1.50 ms to read both operands once.
// The expanded form on the CUDA cores would take 2 Q n d flops at 67 TFLOP/s
// (9.39 ms); the difference form 2 issue slots a term (18.78 ms).
//
// What the design does about it.
//  * A prologue kernel splits the queries into hi and lo (2 Q d floats) and
//    takes their norms; it also zeroes the call's flag counter.
//  * A CTA owns 128 corpus rows by 128 queries: two consumer warpgroups of
//    64 rows each (the wgmma M = corpus rows, N = queries), and a producer
//    warp whose first thread keeps TMA loads in flight into a 4-stage
//    ring of 32-column slices (corpus, query hi, query lo: 48 KB a stage, 128
//    bytes a row, 128-byte swizzle). The CTAs of one corpus tile run next to
//    each other, so its second read comes from L2.
//  * Each consumer loads its A fragments (corpus rows) from shared memory
//    into registers, splits them there, and sums their squares for the row
//    norms; B (queries hi and lo) comes from shared memory. Both operands
//    are K-major (d is contiguous), which TF32 wgmma needs.
//  * Accumulator 64 x 128 fp32 (64 registers a thread) and the master sum
//    beside it (64 more).
//  * The epilogue adds the norms, flags, and writes straight from registers:
//    each warp store fills whole 32-byte sectors (8 consecutive corpus rows of
//    4 queries), so no staging through shared memory is needed. Corpus rows
//    past n and queries past Q are zero on load (TMA) and not written.
//  * Barrier waits trap after some 2^26 polls, so a pipeline fault is a
//    launch error, not a hung card.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                  // corpus rows a CTA; 64 a consumer
constexpr int BN = 128;                  // queries a CTA (the wgmma N)
constexpr int BK = 32;                   // columns a stage: 128 bytes of fp32
constexpr int STAGES = 4;
constexpr int X_TILE = BM * BK * 4;      // 16 KB
constexpr int Q_TILE = BN * BK * 4;      // 16 KB
// two consumer warpgroups (warps 0-7, so that each is warpgroup-aligned for
// wgmma) and a producer warp. ptxas gives 288 threads 168 registers a thread
// and spills part of the master sum around each slice's products; a version
// whose first consumer thread issued the loads instead (256 threads, no
// spill) ran slower on an H100.
constexpr int kThreads = 288;
constexpr int kPrologueThreads = 256;
constexpr int kRepairWarps = 8;

struct alignas(1024) Smem {
  uint8_t x[STAGES][X_TILE];
  uint8_t qhi[STAGES][Q_TILE];
  uint8_t qlo[STAGES][Q_TILE];
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;   // room to align the base

struct Params {
  float* out;
  const float* qnorm;
  unsigned long long* list;              // [0]: the call's count; then pairs
  int64_t Q, n;
  int nk, nq_tiles;
  float flag_ratio;                      // gamma / 1e-4
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ---------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
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

// --- TMA ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint64_t* bar,
                                         void* dst, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle, K-major: rows of 128
// bytes, 8-row groups 1,024 bytes apart (the leading offset is unused).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of registers that an
// asynchronous wgmma reads or writes across its wait: they are "changed" here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define ACC8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define ACC64                                                           \
  ACC8(0), ACC8(8), ACC8(16), ACC8(24), ACC8(32), ACC8(40), ACC8(48),   \
      ACC8(56)
#define ACC_REGS                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "  \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "   \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "   \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, fp32) (+)= A (64 x 8, TF32 in registers) * B (8 x 128, TF32
// in shared memory, K-major); accumulate = 0 overwrites d. The A fragment
// of a thread (lane l of warp w of the warpgroup, g = l / 4, t = l % 4):
// a[0] = A[16w + g][t], a[1] = A[16w + g + 8][t], a[2] = A[16w + g][t + 4],
// a[3] = A[16w + g + 8][t + 4]. TF32 takes no transpose: both operands are
// K-major.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return u;
}

// Compensated (Kahan) sum: s + c carries the running total.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = v - c;
  const float t = s + y;
  c = (t - s) - y;
  s = t;
}

// --- prologue: split the queries, their norms, the call's counter -----------
__global__ void __launch_bounds__(kPrologueThreads)
pairwise_split_queries(const float4* __restrict__ qs, float4* __restrict__ qhi,
              float4* __restrict__ qlo, float* __restrict__ qnorm,
              unsigned long long* __restrict__ list, int64_t d4) {
  __shared__ float part[kPrologueThreads / 32];
  const int64_t row = blockIdx.x;
  if (row == 0 && threadIdx.x == 0) list[0] = 0;
  float s = 0.f, c = 0.f;
  for (int64_t i = threadIdx.x; i < d4; i += kPrologueThreads) {
    const float4 v = qs[row * d4 + i];
    float4 h, l;
    h.x = __uint_as_float(to_tf32(v.x)); l.x = v.x - h.x;
    h.y = __uint_as_float(to_tf32(v.y)); l.y = v.y - h.y;
    h.z = __uint_as_float(to_tf32(v.z)); l.z = v.z - h.z;
    h.w = __uint_as_float(to_tf32(v.w)); l.w = v.w - h.w;
    qhi[row * d4 + i] = h;
    qlo[row * d4 + i] = l;
    kahan_add(s, c, v.x * v.x);
    kahan_add(s, c, v.y * v.y);
    kahan_add(s, c, v.z * v.z);
    kahan_add(s, c, v.w * v.w);
  }
  s -= c;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kPrologueThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    if (lane == 0) qnorm[row] = s;
  }
}

// --- main kernel -------------------------------------------------------------
__device__ __forceinline__ void produce(Smem& s, const CUtensorMap* tx,
                                       const CUtensorMap* tqh,
                                       const CUtensorMap* tql, int r0, int q0,
                                       int nk) {
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&s.empty[st], ((kt / STAGES) & 1) ^ 1);
    mbar_expect_tx(&s.full[st], X_TILE + 2 * Q_TILE);
    const int c0 = kt * BK;
    tma_load(tx, &s.full[st], s.x[st], c0, r0);
    tma_load(tqh, &s.full[st], s.qhi[st], c0, q0);
    tma_load(tql, &s.full[st], s.qlo[st], c0, q0);
  }
}

// One consumer warpgroup: corpus rows r0 + 64 w .. + 63 against the CTA's
// 128 queries.
__device__ __forceinline__ void consume(Smem& s, const Params& p, int64_t r0,
                                       int64_t q0, int w) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = 64 * w + 16 * warp + g;   // rows row0 and row0 + 8 of the tile

  float acc[64], mast[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) mast[i] = 0.f;
  float ns[2] = {0.f, 0.f}, nc[2] = {0.f, 0.f};   // row norms, compensated

  for (int kt = 0; kt < p.nk; ++kt) {
    const int st = kt % STAGES;
    mbar_wait(&s.full[st], (kt / STAGES) & 1);

    // A fragments of the four k8 steps, from the swizzled corpus tile: the
    // 16-byte chunk c of row r sits at chunk c ^ (r % 8)
    uint32_t ahi[16], alo[16];
    const uint8_t* xs = s.x[st];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = row0 + 8 * rr;
          const int chunk = (2 * kk + h) ^ (row & 7);
          const float v = *reinterpret_cast<const float*>(
              xs + row * 128 + chunk * 16 + t * 4);
          const uint32_t hi = to_tf32(v);
          ahi[4 * kk + 2 * h + rr] = hi;
          alo[4 * kk + 2 * h + rr] = __float_as_uint(v - __uint_as_float(hi));
          kahan_add(ns[rr], nc[rr], v * v);
        }

    const uint32_t qh = smem_u32(s.qhi[st]), ql = smem_u32(s.qlo[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dh = make_desc(qh + 32 * kk);
      const uint64_t dl = make_desc(ql + 32 * kk);
      wgmma_tf32(acc, &alo[4 * kk], dh, kk > 0);
      wgmma_tf32(acc, &ahi[4 * kk], dl, 1);
      wgmma_tf32(acc, &ahi[4 * kk], dh, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(ahi);
    fence_regs(alo);
    if (tid == 0) mbar_arrive(&s.empty[st]);
#pragma unroll
    for (int i = 0; i < 64; ++i) mast[i] += acc[i];
  }

  // row norms: the quad's four threads share rows row0 and row0 + 8
  float xn[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float v = ns[rr] - nc[rr];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    xn[rr] = v;
  }

  // epilogue: value, flag, store; accumulator entry 4j + 2rr + e is
  // (row row0 + 8 rr, query 8 j + 2 t + e)
  unsigned long long* list = p.list;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int64_t q = q0 + 8 * j + 2 * t + e;
      const float qn = q < p.Q ? p.qnorm[q] : 0.f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int64_t r = r0 + row0 + 8 * rr;
        const bool inside = q < p.Q && r < p.n;
        const float S = qn + xn[rr];
        const float v = S - 2.f * mast[4 * j + 2 * rr + e];
        const bool flag = inside && v <= p.flag_ratio * S;
        const unsigned ballot = __ballot_sync(0xffffffffu, flag);
        if (ballot) {
          const int leader = __ffs(ballot) - 1;
          unsigned long long base = 0;
          if (lane == leader) base = atomicAdd(list, (unsigned long long)__popc(ballot));
          base = __shfl_sync(0xffffffffu, base, leader);
          if (flag)
            list[1 + base + __popc(ballot & ((1u << lane) - 1))] =
                (unsigned long long)(q * p.n + r);
        }
        if (inside) p.out[q * p.n + r] = v;
      }
    }
}

__global__ void __launch_bounds__(kThreads, 1)
pairwise_l2_tc_kernel(const __grid_constant__ CUtensorMap tx,
                      const __grid_constant__ CUtensorMap tqh,
                      const __grid_constant__ CUtensorMap tql,
                      const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + pad);

  // the CTAs of one corpus tile are consecutive
  const int64_t q0 = (int64_t)(blockIdx.x % p.nq_tiles) * BN;
  const int64_t r0 = (int64_t)(blockIdx.x / p.nq_tiles) * BM;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.full[i], 1);
      mbar_init(&s.empty[i], 2);          // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroups 0 and 1 compute; the first thread of warp 8 loads
  const int wg = threadIdx.x / 128;
  if (wg < 2) {
    consume(s, p, r0, q0, wg);
  } else if (threadIdx.x == 256) {
    produce(s, &tx, &tqh, &tql, (int)r0, (int)q0, p.nk);
  }
}

// --- repair: the flagged pairs in the difference form, one warp a pair ------
__global__ void __launch_bounds__(kRepairWarps * 32)
pairwise_repair_flagged(const float4* __restrict__ qs, const float4* __restrict__ x,
               float* __restrict__ out,
               const unsigned long long* __restrict__ list,
               unsigned long long* __restrict__ total, int64_t n, int64_t d4) {
  const unsigned long long count = list[0];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(total, count);
  const int lane = threadIdx.x & 31;
  const unsigned long long warps = (unsigned long long)gridDim.x * kRepairWarps;
  for (unsigned long long i = blockIdx.x * kRepairWarps + threadIdx.x / 32;
       i < count; i += warps) {
    const unsigned long long pair = list[1 + i];
    const float4* qr = qs + (int64_t)(pair / n) * d4;
    const float4* xr = x + (int64_t)(pair % n) * d4;
    float s = 0.f;
    for (int64_t c = lane; c < d4; c += 32) {
      const float4 a = qr[c], b = xr[c];
      const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z, dw = a.w - b.w;
      s += dx * dx;
      s += dy * dy;
      s += dz * dz;
      s += dw * dw;
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    if (lane == 0) out[pair] = s;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, which the process already has loaded.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"))
             : nullptr;
  }();
  return fn;
}

// A 2-D fp32 map over (d columns, rows), boxes of 32 columns by 128 rows,
// 128-byte swizzle, zeros past the edges.
int make_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t d) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(d * 4)};
  const cuuint32_t box[2] = {BK, 128};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;   // CUresult, offset
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// qs (Q, d) and x (n, d) fp32, contiguous, 16-byte aligned, d % 4 == 0;
// out (Q, n) fp32; scratch fp32 of 2 Q d + Q (the split queries and their
// norms); list uint64 of 1 + Q n (the call's flag count, then the flagged
// pairs as q * n + r); total a uint64 on the device to which the call's
// count is added. flag_ratio = gamma / 1e-4 (see the note above). Needs
// Q, n, d < 2^31. Returns cudaGetLastError() after the three
// launches, cudaErrorInvalidValue for arguments it does not take, or 10000 +
// libcuda's CUresult when a tensor map cannot be made; nothing is launched
// then.
extern "C" int pairwise_l2_sm90(const void* qs, const void* x, void* out,
                                void* scratch, void* list, void* total,
                                int64_t Q, int64_t n, int64_t d,
                                float flag_ratio, void* stream) {
  if (Q <= 0 || n <= 0) return (int)cudaSuccess;
  const int64_t lim = int64_t(1) << 31;
  if (d <= 0 || d % 4 || Q >= lim || n >= lim || d >= lim ||
      !aligned16(qs) || !aligned16(x) || !aligned16(scratch))
    return (int)cudaErrorInvalidValue;
  float* qhi = static_cast<float*>(scratch);
  float* qlo = qhi + Q * d;
  float* qnorm = qlo + Q * d;
  CUtensorMap tx, tqh, tql;
  int rc = make_map(&tx, x, n, d);
  if (!rc) rc = make_map(&tqh, qhi, Q, d);
  if (!rc) rc = make_map(&tql, qlo, Q, d);
  if (rc) return rc;
  auto s = static_cast<cudaStream_t>(stream);
  auto* lp = static_cast<unsigned long long*>(list);

  pairwise_split_queries<<<(unsigned)Q, kPrologueThreads, 0, s>>>(
      static_cast<const float4*>(qs), reinterpret_cast<float4*>(qhi),
      reinterpret_cast<float4*>(qlo), qnorm, lp, d / 4);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = cudaFuncSetAttribute(pairwise_l2_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Params p;
  p.out = static_cast<float*>(out);
  p.qnorm = qnorm;
  p.list = lp;
  p.Q = Q;
  p.n = n;
  p.nk = (int)((d + BK - 1) / BK);
  p.nq_tiles = (int)((Q + BN - 1) / BN);
  p.flag_ratio = flag_ratio;
  const int64_t ctas = (int64_t)p.nq_tiles * ((n + BM - 1) / BM);
  if (ctas >= lim) return (int)cudaErrorInvalidValue;
  pairwise_l2_tc_kernel<<<(unsigned)ctas, kThreads, SMEM_BYTES, s>>>(tx, tqh, tql, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  pairwise_repair_flagged<<<264, kRepairWarps * 32, 0, s>>>(
      static_cast<const float4*>(qs), static_cast<const float4*>(x),
      static_cast<float*>(out), lp, static_cast<unsigned long long*>(total),
      n, d / 4);
  return (int)cudaGetLastError();
}
