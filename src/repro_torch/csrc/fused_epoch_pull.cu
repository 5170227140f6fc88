// fused_epoch_pull: the round-fused BMO racing pull on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_race.py,
// fused_epoch_pull_pallas / _fused_epoch_kernel.
//
// What it computes. For each (query q, selected arm b): T block pulls
//   v_t = mean_{j<block} (x[arm[q,b], blk[q,b,t]*block + j] - qs[q, same])^2
// (|.| for l1), folded into a sequential Welford accumulator exactly as the
// TPU kernel does (delta = v - mean; mean += delta/(t+1); m2 += delta*(v - mean)).
// Output (Q, B, 2) fp32 = (mean, M2) of the T values.
//
// What bounds it on this card. Memory: each pull is one contiguous
// block*4-byte slice (512 B at block = 128) at a random row of a corpus far
// larger than the 50 MB L2, so the kernel moves about Q*B*T*block*4 bytes of
// random corpus reads; the query slices mostly hit in L2. Its arithmetic
// (3 flops per element) is negligible beside that.
//
// What the design does about it. One warp per (q, b) pair, flattened into
// blockIdx.x (B reaches 131,072 at the wide init, above gridDim.y's 65,535
// limit), 8 warps per block. Each pull is read with 16-byte vector loads,
// neighbouring lanes on neighbouring addresses (32 lanes x float4 = 128
// values), and reduced with warp shuffles, so every 512-byte slice is four
// full 128-byte transactions. Many warps in flight per SM keep enough loads
// outstanding to cover the device-memory latency, and each warp loads two
// pulls before it reduces either. n_buf (pulls to load ahead) is accepted
// for the reference's interface and not used yet.
//
// Offsets are 64-bit: arm * d_pad reaches 131,071 * 16,384 > INT32_MAX.
// A negative arm id marks a lane whose result the caller discards: the warp
// reads nothing and writes (0, 0). An arm or block id out of range writes
// NaN instead of reading outside the corpus.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <int BLOCK, bool L1>
__device__ __forceinline__ float pull_partial(const float* __restrict__ xr,
                                              const float* __restrict__ qr,
                                              int lane) {
  // BLOCK / 32 consecutive values per lane, as float4, float2 or float
  constexpr int PER_LANE = BLOCK / 32;
  float s = 0.f;
  if constexpr (PER_LANE >= 4) {
#pragma unroll
    for (int i = 0; i < PER_LANE / 4; ++i) {
      const int off = (i * 32 + lane) * 4;
      const float4 a = *reinterpret_cast<const float4*>(xr + off);
      const float4 b = *reinterpret_cast<const float4*>(qr + off);
      const float d0 = a.x - b.x, d1 = a.y - b.y, d2 = a.z - b.z, d3 = a.w - b.w;
      if constexpr (L1) {
        s += fabsf(d0) + fabsf(d1) + fabsf(d2) + fabsf(d3);
      } else {
        s += d0 * d0 + d1 * d1 + d2 * d2 + d3 * d3;
      }
    }
  } else if constexpr (PER_LANE == 2) {
    const float2 a = *reinterpret_cast<const float2*>(xr + lane * 2);
    const float2 b = *reinterpret_cast<const float2*>(qr + lane * 2);
    const float d0 = a.x - b.x, d1 = a.y - b.y;
    s = L1 ? fabsf(d0) + fabsf(d1) : d0 * d0 + d1 * d1;
  } else {
    const float d0 = xr[lane] - qr[lane];
    s = L1 ? fabsf(d0) : d0 * d0;
  }
  return s;
}

template <int BLOCK, bool L1>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
fused_epoch_pull_kernel(const float* __restrict__ x,
                        const float* __restrict__ qs,
                        const int32_t* __restrict__ arm_idx,
                        const int32_t* __restrict__ blk_idx,
                        float* __restrict__ out,
                        int64_t n, int64_t d_pad, int64_t B, int64_t T,
                        int64_t pairs) {
  const int lane = threadIdx.x & 31;
  const int64_t pair =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pair >= pairs) return;
  const int64_t q = pair / B;
  const int64_t arm = arm_idx[pair];
  float* o = out + pair * 2;
  if (arm < 0) {
    if (lane == 0) { o[0] = 0.f; o[1] = 0.f; }
    return;
  }
  const int64_t nb = d_pad / BLOCK;
  bool bad = arm >= n;
  const float* xrow = x + (bad ? 0 : arm) * d_pad;
  const float* qrow = qs + q * d_pad;
  const int32_t* blk = blk_idx + pair * T;

  // a bad block id is flagged and read as block 0, so no load leaves the row
  auto offset = [&](int64_t t) {
    const int64_t b = blk[t];
    const bool ok = b >= 0 && b < nb;
    bad |= !ok;
    return (ok ? b : 0) * BLOCK;
  };
  float mean = 0.f, m2 = 0.f;
  // running Welford over the epoch's T pulls, the TPU kernel's order
  auto fold = [&](float s, int64_t t) {
    const float v = s / (float)BLOCK;
    const float delta = v - mean;
    mean = mean + delta / (float)(t + 1);
    m2 = m2 + delta * (v - mean);
  };
  int64_t t = 0;
  // two pulls per step: both slices are loaded before either is reduced,
  // so each warp keeps two 512-byte reads in flight
  for (; t + 1 < T; t += 2) {
    const int64_t o0 = offset(t), o1 = offset(t + 1);
    float s0 = pull_partial<BLOCK, L1>(xrow + o0, qrow + o0, lane);
    float s1 = pull_partial<BLOCK, L1>(xrow + o1, qrow + o1, lane);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, w);
      s1 += __shfl_xor_sync(0xffffffffu, s1, w);
    }
    fold(s0, t);
    fold(s1, t + 1);
  }
  if (t < T) {
    const int64_t o0 = offset(t);
    float s0 = pull_partial<BLOCK, L1>(xrow + o0, qrow + o0, lane);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s0 += __shfl_xor_sync(0xffffffffu, s0, w);
    fold(s0, t);
  }
  if (lane == 0) {
    o[0] = bad ? NAN : mean;
    o[1] = bad ? NAN : m2;
  }
}

template <int BLOCK>
void launch(bool l1, const float* x, const float* qs, const int32_t* arm,
            const int32_t* blk, float* out, int64_t n, int64_t d_pad,
            int64_t B, int64_t T, int64_t pairs, cudaStream_t stream) {
  const unsigned grid = (unsigned)((pairs + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (l1) {
    fused_epoch_pull_kernel<BLOCK, true><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        x, qs, arm, blk, out, n, d_pad, B, T, pairs);
  } else {
    fused_epoch_pull_kernel<BLOCK, false><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
        x, qs, arm, blk, out, n, d_pad, B, T, pairs);
  }
}

}  // namespace

// x (n, d_pad) fp32; qs (Q, d_pad) fp32; arm (Q, B) int32; blk (Q, B, T)
// int32; out (Q, B, 2) fp32. All contiguous and 16-byte aligned. metric:
// 0 = l2, 1 = l1. Returns cudaGetLastError() after the launch; an
// unsupported block width returns cudaErrorInvalidValue without launching.
extern "C" int fused_epoch_pull_f32(const void* x, const void* qs,
                                    const void* arm, const void* blk,
                                    void* out, int64_t n, int64_t d_pad,
                                    int64_t Q, int64_t B, int64_t T,
                                    int block, int metric, int n_buf,
                                    void* stream) {
  (void)n_buf;
  const int64_t pairs = Q * B;
  if (pairs <= 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool l1 = metric == 1;
  const auto* xp = static_cast<const float*>(x);
  const auto* qp = static_cast<const float*>(qs);
  const auto* ap = static_cast<const int32_t*>(arm);
  const auto* bp = static_cast<const int32_t*>(blk);
  auto* op = static_cast<float*>(out);
  switch (block) {
    case 32:  launch<32>(l1, xp, qp, ap, bp, op, n, d_pad, B, T, pairs, s); break;
    case 64:  launch<64>(l1, xp, qp, ap, bp, op, n, d_pad, B, T, pairs, s); break;
    case 128: launch<128>(l1, xp, qp, ap, bp, op, n, d_pad, B, T, pairs, s); break;
    case 256: launch<256>(l1, xp, qp, ap, bp, op, n, d_pad, B, T, pairs, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
