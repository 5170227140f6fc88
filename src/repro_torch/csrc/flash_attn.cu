// flash_attn: fused attention with an online softmax on NVIDIA Hopper
// (sm_90a), causal or bidirectional, grouped-query.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py,
// flash_attention_pallas / _flash_kernel.
//
// What it computes. For q (B, H, Sq, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv)
// with H % KV == 0, query head h attends to KV head h / (H / KV), which is
// what the reference's wrapper computes after repeating the KV heads:
//   s[i, j] = (q[i] . k[j]) * sm_scale                 (fp32, sm_scale = 1/sqrt(D))
//   s[i, j] = -1e30   where causal and j > i + q_offset
//   o[i]    = sum_j exp(s[i, j] - m_i) v[j] / max(sum_j exp(s[i, j] - m_i), 1e-30)
// with m_i, the normaliser and the accumulator carried in fp32 over key
// tiles as the TPU kernel carries them over its sequential grid axis. The
// probabilities stay fp32 in the product with v, as there. Inputs fp32 or
// bf16 (one type for all three), output (B, H, Sq, Dv) in that type.
//
// What bounds it on this card. Operations: 2 * D + 2 * Dv flops per (query,
// key) pair, about half the pairs under the causal mask. Here they run on
// the CUDA cores at 67 TFLOP/s fp32; the bf16 tensor cores would give 989.
// At the LM path's shape (B 4, H 40, S 4096, D 128) that is 6.9e11 flops a
// call, 10.3 ms at the fp32 peak, against 0.4 GB of q, k, v and o, 0.12 ms
// at 3.35 TB/s.
//
// What the design does about it. This is the simple first kernel: fp32 FMA
// on the CUDA cores, no tensor cores, TMA or warp specialisation. It comes
// in two instantiations of one template, by the widest head dim it takes
// (DMAX): 128, and 256 for 128 < D or Dv <= 256 (nemotron-4-340b's 192).
// The wide one stages 192 KB of shared memory, so one block runs an SM at a
// time, and zero-pads D to 256 in the score loop: at D 192 a quarter of its
// score FMAs multiply zeros.
//  * One 256-thread block per (query tile of 64, head, batch). The block
//    stages its queries once, transposed, in shared memory, then walks the
//    key tiles of 64: k transposed and v as they are, both in fp32.
//  * Thread (ty, tx) of the 16 x 16 grid owns query rows 4ty..4ty+3: a 4 x 4
//    score micro-tile (key columns 4tx..4tx+3) and a 4 x DMAX/16 slice of
//    the output accumulator, all in registers. Row max and row sum reduce over
//    the 16 lanes that share the rows with warp shuffles. The probabilities
//    go through shared memory (over the k tile, which is no longer read) for
//    the product with v.
//  * The block reads KV head h / G directly: the G-fold repeat of the
//    reference's wrapper is never materialised.
//  * Causal: key tiles wholly above the diagonal are skipped. That is exact:
//    there every p is exactly 0 and the rescale factor exp(m_prev - m_new)
//    exactly 1, because the first tile holds an unmasked key for every row
//    when q_offset >= 0 (the wrapper requires it). Query tiles run
//    heaviest first.
//  * Ragged edges are bounds-checked rather than asserted as the TPU kernel
//    does: query rows past Sq are not written, keys past Sk score -inf (p
//    exactly 0, as if absent), and columns past D or Dv are zero in shared
//    memory.
//  * A row whose online max rises by hundreds (nearly one-hot attention)
//    rescales its sums by exp(m_prev - m_new), which underflows to 0: that
//    is the right value, and no NaN arises, since m is never -inf after the
//    first tile.
//  * Offsets are 64-bit: B * H * S * D reaches 8.4e7 on the LM path, and the
//    strides of a (B, S, H, D) tensor read as (B, H, S, D) multiply up.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // queries per block
constexpr int BK = 64;           // keys per tile
constexpr int DMAX_NARROW = 128; // the two instantiations' widest head dims;
constexpr int DMAX_WIDE = 256;   // narrower ones are zero-padded
constexpr int kThreads = 256;    // 16 x 16
constexpr int PS = BK + 1;       // padded row of the probability tile
constexpr unsigned kFull = 0xffffffffu;

struct Strides {
  int64_t b, h, s;               // in elements; the last axis is contiguous
};

template <typename T> struct Vec;          // elements in a 16-byte vector
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Rows [0, ROWS) of a (rows, width) slice at src (row stride `stride`), into
// dst transposed: dst[c * ROWS + r] = src[r, c] for c < DMAX, in fp32. Rows at
// or past `nrows` and columns at or past `width` are zero. Consecutive
// threads take consecutive rows, so the shared-memory stores do not conflict.
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const T* __restrict__ src,
                                                int64_t stride, int64_t nrows,
                                                int width, int tid) {
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = DMAX / VN;
  for (int idx = tid; idx < ROWS * CPR; idx += kThreads) {
    const int r = idx % ROWS;
    const int c = idx / ROWS;
    float vals[VN];
    if (r < nrows && c * VN < width) {
      load16(src + r * stride + c * VN, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; ++e) dst[(c * VN + e) * ROWS + r] = vals[e];
  }
}

// The same slice into dst as it is: dst[r * DMAX + c] = src[r, c].
template <typename T, int ROWS, int DMAX>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          int64_t stride, int64_t nrows,
                                          int width, int tid) {
  constexpr int VN = Vec<T>::N;
  constexpr int CPR = DMAX / VN;
  for (int idx = tid; idx < ROWS * CPR; idx += kThreads) {
    const int c = idx % CPR;
    const int r = idx / CPR;
    float vals[VN];
    if (r < nrows && c * VN < width) {
      load16(src + r * stride + c * VN, vals);
    } else {
#pragma unroll
      for (int e = 0; e < VN; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VN; e += 4)
      *reinterpret_cast<float4*>(dst + r * DMAX + c * VN + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

// Qt [DMAX][BQ]; Kt [DMAX][BK], reused for P [BQ][PS]; V [BK][DMAX]:
// 96 KB at DMAX 128 (two blocks an SM), 192 KB at 256 (one)
template <int DMAX> struct Smem {
  static constexpr int KT_FLOATS = DMAX * BK > BQ * PS ? DMAX * BK : BQ * PS;
  static constexpr int BYTES = (DMAX * BQ + KT_FLOATS + BK * DMAX) * 4;
};

template <typename T, bool CAUSAL, int DMAX>
__global__ void __launch_bounds__(kThreads, DMAX <= DMAX_NARROW ? 2 : 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, Strides sq,
                  Strides sk, Strides sv, int64_t H, int64_t G, int64_t Sq,
                  int64_t Sk, int D, int Dv, int64_t q_offset,
                  float sm_scale) {
  constexpr int NG = DMAX / 64;           // groups of 4 value columns a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;
  float* Kt = Qt + DMAX * BQ;
  float* Ps = Kt;
  float* Vs = Kt + Smem<DMAX>::KT_FLOATS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t iq = (int64_t)gridDim.x - 1 - blockIdx.x;   // heaviest first
  const int64_t h = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t kvh = h / G;
  const int64_t q0 = iq * BQ;
  const int64_t nrows_q = Sq - q0 < BQ ? Sq - q0 : BQ;

  const T* kb = k + b * sk.b + kvh * sk.h;
  const T* vb = v + b * sv.b + kvh * sv.h;
  load_transposed<T, BQ, DMAX>(Qt, q + b * sq.b + h * sq.h + q0 * sq.s, sq.s,
                               nrows_q, D, tid);

  int64_t k_end = Sk;
  if (CAUSAL) {
    const int64_t last = q0 + nrows_q - 1 + q_offset;   // last query's position
    if (last + 1 < k_end) k_end = last + 1;
  }
  const int64_t n_tiles = (k_end + BK - 1) / BK;

  float m[4], l[4], acc[4][4 * NG];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) acc[i][c] = 0.f;
  }

  for (int64_t t = 0; t < n_tiles; ++t) {
    const int64_t k0 = t * BK;
    const int64_t nrows_k = Sk - k0 < BK ? Sk - k0 : BK;
    __syncthreads();                      // the last tile's P and V are read
    load_transposed<T, BK, DMAX>(Kt, kb + k0 * sk.s, sk.s, nrows_k, D, tid);
    load_rows<T, BK, DMAX>(Vs, vb + k0 * sv.s, sv.s, nrows_k, Dv, tid);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DMAX; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + d * BQ + ty * 4);
      const float4 c = *reinterpret_cast<const float4*>(Kt + d * BK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t q_pos = q0 + ty * 4 + i + q_offset;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t k_pos = k0 + tx * 4 + j;
        float x = s[i][j] * sm_scale;
        if (k_pos >= Sk) x = -INFINITY;
        else if (CAUSAL && k_pos > q_pos) x = -1e30f;
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, w));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int w = 8; w > 0; w >>= 1) rs += __shfl_xor_sync(kFull, rs, w);
      alpha[i] = expf(m[i] - m_new);       // 0 on the first tile (m = -inf)
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
    }

    __syncthreads();                      // every thread is done with Kt
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Ps[(ty * 4 + i) * PS + tx * 4 + j] = s[i][j];
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NG; ++c) acc[i][c] *= alpha[i];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + kk * DMAX + g * 64 + tx * 4);
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][g * 4 + e] = fmaf(p[i], vc[e], acc[i][g * 4 + e]);
      }
    }
  }

  // o is (B, H, Sq, Dv), contiguous
  T* ob = o + ((b * H + h) * Sq + q0) * Dv;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nrows_q) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g * 64 + tx * 4 + e;
        if (col < Dv) store(ob + r * Dv + col, acc[i][g * 4 + e] * inv);
      }
  }
}

template <typename T, bool CAUSAL, int DMAX>
int launch(const void* q, const void* k, const void* v, void* o, Strides sq,
           Strides sk, Strides sv, int64_t B, int64_t H, int64_t G, int64_t Sq,
           int64_t Sk, int D, int Dv, int64_t q_offset, float sm_scale,
           cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, CAUSAL, DMAX>;
  constexpr int bytes = Smem<DMAX>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, H, G, Sq, Sk,
      D, Dv, q_offset, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int DMAX>
int by_mask(bool causal, const void* q, const void* k, const void* v,
            void* o, Strides sq, Strides sk, Strides sv, int64_t B,
            int64_t H, int64_t G, int64_t Sq, int64_t Sk, int D, int Dv,
            int64_t q_offset, float sm_scale, cudaStream_t s) {
  return causal ? launch<T, true, DMAX>(q, k, v, o, sq, sk, sv, B, H, G, Sq,
                                        Sk, D, Dv, q_offset, sm_scale, s)
                : launch<T, false, DMAX>(q, k, v, o, sq, sk, sv, B, H, G, Sq,
                                         Sk, D, Dv, q_offset, sm_scale, s);
}

// the narrow instantiation up to head dim 128, the wide one above
template <typename T>
int dispatch(bool causal, const void* q, const void* k, const void* v,
             void* o, Strides sq, Strides sk, Strides sv, int64_t B,
             int64_t H, int64_t G, int64_t Sq, int64_t Sk, int D, int Dv,
             int64_t q_offset, float sm_scale, cudaStream_t s) {
  if (D <= DMAX_NARROW && Dv <= DMAX_NARROW)
    return by_mask<T, DMAX_NARROW>(causal, q, k, v, o, sq, sk, sv, B, H, G, Sq,
                                   Sk, D, Dv, q_offset, sm_scale, s);
  return by_mask<T, DMAX_WIDE>(causal, q, k, v, o, sq, sk, sv, B, H, G, Sq, Sk,
                               D, Dv, q_offset, sm_scale, s);
}

}  // namespace

// q (B, H, Sq, D), k (B, KV, Sk, D), v (B, KV, Sk, Dv), all fp32 (dtype 0)
// or all bf16 (dtype 1), each with its own element strides over (batch,
// head, position) and a contiguous last axis; every row and stride 16-byte
// aligned. o (B, H, Sq, Dv) contiguous, in the inputs' type. Needs H % KV
// == 0, 0 < D, Dv <= 256 with D and Dv multiples of 8, q_offset >= 0, and
// ceil(Sq / 64), H, B within the grid. Returns cudaGetLastError() after the
// launch; arguments it does not take return cudaErrorInvalidValue without
// launching.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int64_t qsb, int64_t qsh, int64_t qss,
                               int64_t ksb, int64_t ksh, int64_t kss,
                               int64_t vsb, int64_t vsh, int64_t vss,
                               int64_t B, int64_t H, int64_t KV, int64_t Sq,
                               int64_t Sk, int64_t D, int64_t Dv,
                               int64_t q_offset, int causal, int dtype,
                               float sm_scale, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return (int)cudaSuccess;
  if (KV <= 0 || H % KV || Sk <= 0 || D <= 0 || Dv <= 0 || D > DMAX_WIDE ||
      Dv > DMAX_WIDE || D % 8 || Dv % 8 || q_offset < 0 || H > 65535 || B > 65535 ||
      (Sq + BQ - 1) / BQ > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const Strides sq{qsb, qsh, qss}, sk{ksb, ksh, kss}, sv{vsb, vsh, vss};
  auto s = static_cast<cudaStream_t>(stream);
  const int64_t G = H / KV;
  if (dtype == 0)
    return dispatch<float>(causal != 0, q, k, v, o, sq, sk, sv, B, H, G, Sq, Sk,
                           (int)D, (int)Dv, q_offset, sm_scale, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(causal != 0, q, k, v, o, sq, sk, sv, B, H, G,
                                   Sq, Sk, (int)D, (int)Dv, q_offset, sm_scale,
                                   s);
  return (int)cudaErrorInvalidValue;
}
