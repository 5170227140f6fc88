// flash_attn_sm90: flash attention on Hopper's tensor cores (sm_90a), bf16
// in and out, head width 128, causal or bidirectional, grouped-query.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py,
// flash_attention_pallas / _flash_kernel, for bf16 at D = Dv = 128 (the LM
// path's heads); every other type and width runs the CUDA-core kernel in
// flash_attn.cu.
//
// What it computes. For q (B, H, Sq, 128), k (B, KV, Sk, 128) and
// v (B, KV, Sk, 128), H % KV == 0, query head h reading KV head h / (H / KV):
//   s[i, j] = q[i] . k[j]            (bf16 products, fp32 sums)
//   s[i, j] = -1e30                  where causal and j > i + q_offset
//   p[i, j] = exp(s[i, j] * sm_scale - m_i)         (fp32, m_i the running max)
//   o[i]    = sum_j bf16(p[i, j]) v[j] / max(sum_j p[i, j], 1e-30)
// with m, the normaliser and the accumulator carried in fp32 over key tiles.
// The one difference from the TPU kernel's arithmetic: p is rounded to bf16
// for the product with v (the tensor cores take bf16 operands), as the JAX
// package's own _sdpa paths round it. The normaliser sums the fp32 p. That
// adds at most 2^-8 * max|v| to each output: |sum_j (bf16(p_j) - p_j) v_j| / l
// <= 2^-8 * sum_j p_j |v_j| / l <= 2^-8 * max|v|.
//
// What bounds it on this card. Operations: 2 * 128 + 2 * 128 flops per
// (query, key) pair that the mask keeps. At the LM path's shape (B 4, H 40,
// S 4096, causal) that is 6.9e11 flops a call, 0.695 ms at the bf16 tensor
// cores' 989 TFLOP/s; q, k, v and o are 0.40 GB, 0.12 ms at 3.35 TB/s.
//
// What the design does about it. Both products run on the tensor cores
// (wgmma), fed by the Tensor Memory Accelerator (TMA):
//  * One CTA owns 128 query rows of one (batch, head): two consumer
//    warpgroups of 64 rows each, the wgmma M. It walks key tiles of 128.
//  * Shared memory: the Q tile (32 KB) and a two-stage ring of K and V tiles
//    (32 + 32 KB a stage), 160 KB. Each tile is two panels of 64 columns,
//    128 bytes a row, loaded by TMA with the 128-byte swizzle that the wgmma
//    descriptors name. K and V have their own "full" barriers, so QK^T can
//    start while V still lands; one "empty" barrier a stage, on which each
//    consumer warpgroup arrives once it has read both.
//  * S = Q K^T is wgmma m64n128k16 with both operands K-major in shared
//    memory. The online softmax runs on the fp32 accumulator in registers:
//    a row lives in a quad of threads, so its max takes two shfl_xor; p is
//    exp2 of s * (sm_scale * log2 e) minus the scaled max; the row sums stay
//    per thread until the end.
//  * P never leaves registers: the S accumulator of m64n128 maps pairwise
//    onto the A fragments of eight k16 steps, so p goes to bf16 in place
//    and O += P V is wgmma with A from registers. V is (keys, Dv) with Dv
//    contiguous, the B operand's MN-major form: the instruction's transpose
//    bit, and a descriptor whose leading offset steps between the two
//    64-column panels.
//  * Warp specialisation: a third warpgroup's first thread issues every TMA
//    load; setmaxnreg gives that warpgroup 40 registers a thread and the two
//    consumers 232.
//  * GQA: the tensor maps are 4-D over (D, S, heads, batch) with the
//    tensors' own strides, and the loads name KV head h / G, so the model's
//    (B, S, H, D) projections pass as (B, H, S, D) views and the G-fold
//    repeat is never made. The output leaves through shared memory (the
//    warpgroup's own Q rows) by TMA store through the output's strides, so
//    it can live in (B, S, H, Dv) storage.
//  * Masks: causal tiles wholly above the diagonal are skipped. That is
//    exact: the first tile holds key 0, which every row keeps (q_offset >= 0),
//    so m is finite from then on and a skipped tile's p would be exactly 0.
//    Only tiles that reach past the diagonal or past Sk are masked: causal
//    keys score -1e30, keys past Sk -inf (TMA fills those rows with zeros,
//    which would score 0, not "absent"). Both give p = 0 exactly. Query rows
//    past Sq are zero on load and clipped by the TMA store. A row whose max
//    jumps by hundreds (one-hot attention at the LM's init) rescales by
//    exp2 of a large negative number, which is 0 and finite.
//  * Query tiles run heaviest first within each head.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;                  // query rows a CTA; 64 a consumer
constexpr int BK = 128;                  // keys a tile
constexpr int HD = 128;                  // head width (D = Dv)
constexpr int PANEL_COLS = 64;           // bf16 columns in a 128-byte row
constexpr int STAGES = 2;
constexpr int TILE_BYTES = 128 * HD * 2;       // 32 KB: two panels
constexpr int PANEL_BYTES = 128 * 128;         // 128 rows of 128 bytes
constexpr int WG_ROWS_BYTES = 64 * 128;        // a consumer's 64 rows of a panel

struct alignas(1024) Smem {
  uint8_t q[TILE_BYTES];
  uint8_t k[STAGES][TILE_BYTES];
  uint8_t v[STAGES][TILE_BYTES];
  uint64_t q_full, k_full[STAGES], v_full[STAGES], empty[STAGES];
};
constexpr int SMEM_BYTES = sizeof(Smem) + 1024;   // room to align the base

struct Params {
  int Sq, Sk, G, q_offset;
  float scale_log2;                      // sm_scale * log2(e)
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

// --- TMA ---------------------------------------------------------------------
__device__ __forceinline__ void tma_load(const CUtensorMap* map, uint64_t* bar,
                                         void* dst, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma -------------------------------------------------------------------
// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}
// K-major (rows of 128 bytes, 8-row groups 1,024 bytes apart; the leading
// offset is unused). MN-major V: 8 key rows a group, 1,024 bytes apart; the
// next 64 columns one panel on.
constexpr uint32_t KMAJOR_LBO = 16, KMAJOR_SBO = 1024;
constexpr uint32_t V_LBO = PANEL_BYTES, V_SBO = 1024;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma: its registers are "changed" here.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
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

// d (64 x 128, fp32) (+)= A (64 x 16, from shared memory, K-major) *
// B (16 x 128, from shared memory, K-major); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC_REGS
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC64
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A (64 x 16, bf16 pairs in registers) * B (16 x 128, from shared
// memory, MN-major: the transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " ACC_REGS
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

struct Tile {
  int h, kvh, b, q0, n_tiles;
};

__device__ __forceinline__ void load_q(Smem& s, const CUtensorMap* tq,
                                       const Tile& t) {
  mbar_expect_tx(&s.q_full, TILE_BYTES);
  tma_load(tq, &s.q_full, s.q, 0, t.q0, t.h, t.b);
  tma_load(tq, &s.q_full, s.q + PANEL_BYTES, PANEL_COLS, t.q0, t.h, t.b);
}

// Key tile i into stage i % 2, once both consumers have released its last use.
__device__ __forceinline__ void load_kv(Smem& s, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const Tile& t,
                                        int i) {
  const int st = i % STAGES;
  mbar_wait(&s.empty[st], ((i / STAGES) & 1) ^ 1);
  const int k0 = i * BK;
  mbar_expect_tx(&s.k_full[st], TILE_BYTES);
  tma_load(tk, &s.k_full[st], s.k[st], 0, k0, t.kvh, t.b);
  tma_load(tk, &s.k_full[st], s.k[st] + PANEL_BYTES, PANEL_COLS, k0, t.kvh, t.b);
  mbar_expect_tx(&s.v_full[st], TILE_BYTES);
  tma_load(tv, &s.v_full[st], s.v[st], 0, k0, t.kvh, t.b);
  tma_load(tv, &s.v_full[st], s.v[st] + PANEL_BYTES, PANEL_COLS, k0, t.kvh, t.b);
}

// One consumer warpgroup: rows q0 + 64 w .. + 63 of the tile.
template <bool CAUSAL>
__device__ __forceinline__ void consume(Smem& s, const CUtensorMap* to,
                                        const Params& p,
                                        const Tile& t, int w) {
  const int tid = threadIdx.x % 128;
  const int g = (tid % 32) / 4;          // row within the warp's 8 (and +8)
  const int c = tid % 4;                 // column pair within each 8
  const int row0 = 16 * (tid / 32) + g;  // this thread's rows: row0, row0 + 8
  const int q0w = t.q0 + 64 * w;
  const int qpos0 = q0w + row0 + p.q_offset;
  const uint32_t qa = smem_u32(s.q) + w * WG_ROWS_BYTES;

  float o[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) o[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  mbar_wait(&s.q_full, 0);
  for (int i = 0; i < t.n_tiles; ++i) {
    const int st = i % STAGES;
    const uint32_t phase = (i / STAGES) & 1;
    const int k0 = i * BK;
    float d[64];
    mbar_wait(&s.k_full[st], phase);
    const uint32_t kb = smem_u32(s.k[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk / 4) * PANEL_BYTES + (kk % 4) * 32;
      wgmma_ss(d, make_desc(qa + off, KMAJOR_LBO, KMAJOR_SBO),
               make_desc(kb + off, KMAJOR_LBO, KMAJOR_SBO), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(d);

    // masks, only where the tile reaches past the diagonal or past Sk
    if (k0 + BK > p.Sk || (CAUSAL && k0 + BK - 1 > q0w + p.q_offset)) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * c + e;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float& x = d[4 * j + 2 * r + e];
            if (kpos >= p.Sk) x = -INFINITY;
            else if (CAUSAL && kpos > qpos0 + 8 * r) x = -1e30f;
          }
        }
    }

    // online softmax: row max over the quad, exp2, rescale
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        mx = fmaxf(mx, fmaxf(d[4 * j + 2 * r], d[4 * j + 2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2((m[r] - mx) * p.scale_log2);   // 0 on the first tile
      m[r] = mx;
      const float ms = mx * p.scale_log2;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = d[4 * j + 2 * r + e];
          x = ex2(fmaf(x, p.scale_log2, -ms));
          rs += x;
        }
      l[r] = l[r] * alpha[r] + rs;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      o[4 * j] *= alpha[0];
      o[4 * j + 1] *= alpha[0];
      o[4 * j + 2] *= alpha[1];
      o[4 * j + 3] *= alpha[1];
    }
    // accumulator of S -> A fragments of P: k16 step kk takes d[8kk .. 8kk+7]
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);

    mbar_wait(&s.v_full[st], phase);
    const uint32_t vb = smem_u32(s.v[st]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(o, pa[kk], make_desc(vb + kk * 16 * 128, V_LBO, V_SBO));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (tid == 0) mbar_arrive(&s.empty[st]);
  }

  // epilogue: normalise, write bf16 rows into this warpgroup's Q rows in the
  // 128-byte swizzled layout, then out by TMA store (rows past Sq clipped)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  uint8_t* out = s.q + w * WG_ROWS_BYTES;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int off = (j / 8) * PANEL_BYTES + row * 128 +
                      (((j % 8) ^ (row % 8)) * 16) + c * 4;
      *reinterpret_cast<uint32_t*>(out + off) =
          pack_bf16(o[4 * j + 2 * r] * l[r], o[4 * j + 2 * r + 1] * l[r]);
    }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + w) : "memory");
  if (tid == 0 && q0w < p.Sq) {
    tma_store(to, out, 0, q0w, t.h, t.b);
    tma_store(to, out + PANEL_BYTES, PANEL_COLS, q0w, t.h, t.b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <bool CAUSAL>
__global__ void __launch_bounds__(384, 1)
flash_attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap to,
                       const Params p) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& s = *reinterpret_cast<Smem*>(smem_raw + pad);

  Tile t;
  t.h = blockIdx.y;
  t.b = blockIdx.z;
  t.kvh = t.h / p.G;
  t.q0 = (gridDim.x - 1 - blockIdx.x) * BQ;         // heaviest first
  const int q_last = min(t.q0 + BQ, p.Sq) - 1;
  const int k_end = CAUSAL ? min(p.Sk, q_last + p.q_offset + 1) : p.Sk;
  t.n_tiles = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&s.q_full, 1);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&s.k_full[i], 1);
      mbar_init(&s.v_full[i], 1);
      mbar_init(&s.empty[i], 2);          // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warpgroup 0 loads, 1 and 2 compute
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      load_q(s, &tq, t);
      for (int i = 0; i < t.n_tiles; ++i) load_kv(s, &tk, &tv, t, i);
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    consume<CAUSAL>(s, &to, p, t, wg - 1);
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

// A 4-D bf16 map over (128 columns, rows, heads, batch) with byte strides
// of rows, heads and batch; boxes of 64 columns by box_rows rows, 128-byte
// swizzle, zeros past the edges. Strides of dimensions of size 1 are never
// used; they are set to 16 bytes so that any view passes the encoder.
int make_map(CUtensorMap* map, const void* ptr, int64_t rows, int64_t heads,
             int64_t batch, int64_t s_row, int64_t s_head, int64_t s_batch,
             uint32_t box_rows) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {
      (cuuint64_t)(rows == 1 ? 16 : s_row * 2),
      (cuuint64_t)(heads == 1 ? 16 : s_head * 2),
      (cuuint64_t)(batch == 1 ? 16 : s_batch * 2)};
  const cuuint32_t box[4] = {PANEL_COLS, box_rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<void*>(ptr), dims, strides, box, elem,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;   // CUresult, offset
}

template <bool CAUSAL>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const CUtensorMap& to, const Params& p, int64_t n_qtiles, int64_t H,
           int64_t B, cudaStream_t stream) {
  auto kernel = flash_attn_sm90_kernel<CAUSAL>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)n_qtiles, (unsigned)H, (unsigned)B);
  kernel<<<grid, 384, SMEM_BYTES, stream>>>(tq, tk, tv, to, p);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }
bool stride_ok(int64_t s, int64_t n) { return n == 1 || (s > 0 && s % 8 == 0); }

}  // namespace

// q (B, H, Sq, 128), k and v (B, KV, Sk, 128), o (B, H, Sq, 128), all bf16,
// each with its own element strides over (batch, head, position) and a
// contiguous last axis; base pointers 16-byte aligned and strides of
// dimensions longer than 1 positive multiples of 8 elements. Needs
// H % KV == 0, q_offset >= 0, Sq and Sk below 2^30, H and B at most 65535.
// Returns cudaGetLastError() after the
// launch, cudaErrorInvalidValue for arguments it does not take, or 10000 +
// libcuda's CUresult when a tensor map cannot be made; nothing is launched
// then.
extern "C" int flash_attention_sm90(
    const void* q, const void* k, const void* v, void* o, int64_t qsb,
    int64_t qsh, int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
    int64_t vsb, int64_t vsh, int64_t vss, int64_t osb, int64_t osh,
    int64_t oss, int64_t B, int64_t H, int64_t KV, int64_t Sq, int64_t Sk,
    int64_t q_offset, int causal, float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  const int64_t lim = int64_t(1) << 30;
  if (KV <= 0 || H % KV || Sk <= 0 || q_offset < 0 || Sq >= lim ||
      Sk >= lim || H > 65535 || B > 65535 ||
      !aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(o) ||
      !stride_ok(qsb, B) || !stride_ok(qsh, H) || !stride_ok(qss, Sq) ||
      !stride_ok(ksb, B) || !stride_ok(ksh, KV) || !stride_ok(kss, Sk) ||
      !stride_ok(vsb, B) || !stride_ok(vsh, KV) || !stride_ok(vss, Sk) ||
      !stride_ok(osb, B) || !stride_ok(osh, H) || !stride_ok(oss, Sq))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  int rc = make_map(&tq, q, Sq, H, B, qss, qsh, qsb, BQ);
  if (!rc) rc = make_map(&tk, k, Sk, KV, B, kss, ksh, ksb, BK);
  if (!rc) rc = make_map(&tv, v, Sk, KV, B, vss, vsh, vsb, BK);
  if (!rc) rc = make_map(&to, o, Sq, H, B, oss, osh, osb, 64);
  if (rc) return rc;
  // past Sk every key is visible anyway: the clamp keeps positions in int
  const Params p{(int)Sq, (int)Sk, (int)(H / KV),
                 (int)(q_offset < Sk ? q_offset : Sk),
                 sm_scale * 1.4426950408889634f};
  const int64_t nq = (Sq + BQ - 1) / BQ;
  auto s = static_cast<cudaStream_t>(stream);
  return causal ? launch<true>(tq, tk, tv, to, p, nq, H, B, s)
                : launch<false>(tq, tk, tv, to, p, nq, H, B, s);
}
