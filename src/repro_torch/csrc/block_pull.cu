// block_pull: the BMO Monte-Carlo pull on NVIDIA Hopper (sm_90a), for one
// query or a batch of queries.
//
// Replaces the TPU kernels src/repro/kernels/block_pull.py,
// block_pull_multi_pallas / _pull_multi_kernel and block_pull_pallas /
// _pull_kernel. Both entry points below run the one kernel: the
// single-query pull is the batched one with Q = 1.
//
// What it computes. For each (query q, selected arm b, pull p):
//   out[q,b,p] = mean_{j<block} (x[arm[q,b], blk[q,b,p]*block + j] - qs[q, same])^2
// (|.| for l1), in fp32 whatever the input type (fp32 or bf16).
// Output (Q, B, P) fp32.
//
// What bounds it on this card. Memory: each pull is one contiguous
// block-wide slice (512 B at block = 128 fp32) at a random row of a corpus
// far larger than the 50 MB L2, so the kernel moves about Q*B*P*block*4
// bytes of random corpus reads; the query slices mostly hit in L2. Its
// arithmetic (3 flops per element) is negligible beside that.
//
// What the design does about it. One warp per pull, flattened into
// blockIdx.x (the per-round driver's init pulls Q*n*P = 1024*131072*2
// slices in one launch, beyond any other grid dimension), 8 warps per
// block. Each slice is read with vector loads of up to 16 bytes,
// neighbouring lanes on neighbouring addresses, and reduced with warp
// shuffles, so a 512-byte slice is four full 128-byte transactions. Many
// warps in flight per SM keep enough loads outstanding to cover the
// device-memory latency.
//
// The arm and block ids come in as the caller holds them, int32 or int64
// (the paper path's arm ids are int64, its block ids int32): the kernel is
// instantiated for each pair, so a call launches this one kernel and no
// conversion.
//
// Offsets are 64-bit: arm * d_pad reaches 131,071 * 16,384 > INT32_MAX.
// A negative arm id marks a lane whose result the caller discards: the warp
// reads nothing and writes 0. An arm or block id out of range writes NaN
// instead of reading outside the corpus.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Sum over one block-wide slice of this lane's share of the distance terms.
// The slice is cut into vectors of VEC elements (at most 16 bytes); lane l
// reads vectors l, l + 32, ... so a warp's loads are contiguous.
template <typename T, int BLOCK, bool L1>
__device__ __forceinline__ float slice_partial(const T* __restrict__ xr,
                                               const T* __restrict__ qr,
                                               int lane) {
  constexpr int PER_LANE = BLOCK / 32;
  constexpr int MAX_VEC = 16 / (int)sizeof(T);
  constexpr int VEC = PER_LANE < MAX_VEC ? PER_LANE : MAX_VEC;
  using V = typename Raw<VEC * (int)sizeof(T)>::type;
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < PER_LANE / VEC; ++c) {
    const int off = (c * 32 + lane) * VEC;
    const V a = *reinterpret_cast<const V*>(xr + off);
    const V b = *reinterpret_cast<const V*>(qr + off);
    const T* ae = reinterpret_cast<const T*>(&a);
    const T* be = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float diff = to_float(ae[e]) - to_float(be[e]);
      s += L1 ? fabsf(diff) : diff * diff;
    }
  }
  return s;
}

template <typename T, int BLOCK, bool L1, typename IA, typename IB>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
block_pull_kernel(const T* __restrict__ x, const T* __restrict__ qs,
                  const IA* __restrict__ arm_idx,
                  const IB* __restrict__ blk_idx,
                  float* __restrict__ out, int64_t n, int64_t d_pad,
                  int64_t B, int64_t P, int64_t pulls) {
  const int lane = threadIdx.x & 31;
  const int64_t pull =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pull >= pulls) return;
  const int64_t pair = pull / P;          // q * B + b
  const int64_t q = pair / B;
  const int64_t arm = arm_idx[pair];
  if (arm < 0) {
    if (lane == 0) out[pull] = 0.f;
    return;
  }
  const int64_t nb = d_pad / BLOCK;
  const int64_t blk = blk_idx[pull];
  if (arm >= n || blk < 0 || blk >= nb) {
    if (lane == 0) out[pull] = NAN;
    return;
  }
  const int64_t off = blk * BLOCK;
  float s = slice_partial<T, BLOCK, L1>(x + arm * d_pad + off,
                                        qs + q * d_pad + off, lane);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) out[pull] = s / (float)BLOCK;
}

template <typename T, int BLOCK, typename IA, typename IB>
void launch(bool l1, const void* x, const void* qs, const void* arm,
            const void* blk, float* out, int64_t n, int64_t d_pad,
            int64_t B, int64_t P, int64_t pulls, cudaStream_t stream) {
  const unsigned grid = (unsigned)((pulls + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const auto* xp = static_cast<const T*>(x);
  const auto* qp = static_cast<const T*>(qs);
  const auto* ap = static_cast<const IA*>(arm);
  const auto* bp = static_cast<const IB*>(blk);
  if (l1) {
    block_pull_kernel<T, BLOCK, true, IA, IB>
        <<<grid, kWarpsPerBlock * 32, 0, stream>>>(xp, qp, ap, bp, out, n,
                                                   d_pad, B, P, pulls);
  } else {
    block_pull_kernel<T, BLOCK, false, IA, IB>
        <<<grid, kWarpsPerBlock * 32, 0, stream>>>(xp, qp, ap, bp, out, n,
                                                   d_pad, B, P, pulls);
  }
}

template <typename T, typename IA, typename IB>
int dispatch(int block, bool l1, const void* x, const void* qs,
             const void* arm, const void* blk, float* out, int64_t n,
             int64_t d_pad, int64_t B, int64_t P, int64_t pulls,
             cudaStream_t s) {
  switch (block) {
    case 32:  launch<T, 32, IA, IB>(l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s); break;
    case 64:  launch<T, 64, IA, IB>(l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s); break;
    case 128: launch<T, 128, IA, IB>(l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s); break;
    case 256: launch<T, 256, IA, IB>(l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// the id types: 0 = int32, 1 = int64
template <typename T>
int dispatch_ids(int arm_type, int blk_type, int block, bool l1, const void* x,
                 const void* qs, const void* arm, const void* blk, float* out,
                 int64_t n, int64_t d_pad, int64_t B, int64_t P, int64_t pulls,
                 cudaStream_t s) {
  if (arm_type == 0 && blk_type == 0)
    return dispatch<T, int32_t, int32_t>(block, l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s);
  if (arm_type == 1 && blk_type == 0)
    return dispatch<T, int64_t, int32_t>(block, l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s);
  if (arm_type == 0 && blk_type == 1)
    return dispatch<T, int32_t, int64_t>(block, l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s);
  if (arm_type == 1 && blk_type == 1)
    return dispatch<T, int64_t, int64_t>(block, l1, x, qs, arm, blk, out, n, d_pad, B, P, pulls, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (n, d_pad); qs (Q, d_pad), both fp32 (dtype 0) or both bf16 (dtype 1);
// arm (Q, B) and blk (Q, B, P), each int32 (type 0) or int64 (type 1);
// out (Q, B, P) fp32. All contiguous, x and qs 16-byte aligned. metric:
// 0 = l2, 1 = l1. Returns cudaGetLastError() after the launch; an
// unsupported block width or type returns cudaErrorInvalidValue without
// launching. The grid needs ceil(Q*B*P / 8) < 2^31 blocks.
extern "C" int block_pull_multi(const void* x, const void* qs, const void* arm,
                                const void* blk, void* out, int64_t n,
                                int64_t d_pad, int64_t Q, int64_t B, int64_t P,
                                int block, int metric, int dtype, int arm_type,
                                int blk_type, void* stream) {
  const int64_t pulls = Q * B * P;
  if (pulls <= 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool l1 = metric == 1;
  auto* op = static_cast<float*>(out);
  if (dtype == 0)
    return dispatch_ids<float>(arm_type, blk_type, block, l1, x, qs, arm, blk,
                               op, n, d_pad, B, P, pulls, s);
  if (dtype == 1)
    return dispatch_ids<__nv_bfloat16>(arm_type, blk_type, block, l1, x, qs,
                                       arm, blk, op, n, d_pad, B, P, pulls, s);
  return (int)cudaErrorInvalidValue;
}
