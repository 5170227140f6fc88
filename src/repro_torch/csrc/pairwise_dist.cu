// pairwise_dist: exact pairwise distances on NVIDIA Hopper (sm_90a), the
// exactness judge of the BMO-NN port.
//
// Replaces the TPU kernel src/repro/kernels/pairwise_dist.py,
// pairwise_dist_pallas / _dist_kernel.
//
// What it computes. out[q, r] = sum_j (qs[q, j] - x[r, j])^2 (l2, squared)
// or sum_j |qs[q, j] - x[r, j]| (l1), for qs (Q, d) and x (n, d) fp32,
// accumulated in fp32. Output (Q, n) fp32. The difference is taken first
// and squared or made absolute: no norm expansion, no TF32, no tensor
// cores, so the sums are as exact as fp32 accumulation allows. Q, n and d
// may be any size: the edges are bounds-checked (the TPU kernel pads).
//
// What bounds it on this card. Operations: 3 flops per (q, r, j) term, on
// the CUDA cores at 67 TFLOP/s fp32. At the oracle's shape (256 queries
// against 100,000 x 12,288) that is 0.94e12 flops, 14 ms, against 5 GB of
// inputs, 1.5 ms at 3.35 TB/s.
//
// What the design does about it. Two schedules.
//  * Tiled, for Q > 4: one 256-thread block per 64 x 64 (query x row) tile
//    of the output. Slices of 32 coordinates of both operands are staged in
//    shared memory (coalesced loads, padded rows so neither the stores nor
//    the reads conflict), and each thread accumulates a 4 x 4 micro-tile in
//    registers. Each operand element read from shared memory feeds 4 terms.
//  * Row-wise, for Q <= 4 (the paper path's exact evaluation: one query
//    against the 32 rows just selected, d = 16,384): one 256-thread block per
//    (query, row) pair, striding over d and reducing through warp shuffles.
//    A 64 x 64 tile would leave 63 of its 64 query rows empty and walk d in
//    one block.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;   // queries per tile
constexpr int TN = 64;   // corpus rows per tile
constexpr int TK = 32;   // coordinates per shared-memory slice
constexpr int kThreads = 256;
constexpr int kRowWiseMaxQ = 4;

template <bool L1>
__device__ __forceinline__ float term(float a, float b) {
  const float diff = a - b;
  return L1 ? fabsf(diff) : diff * diff;
}

template <bool L1>
__global__ void __launch_bounds__(kThreads)
pairwise_tiled(const float* __restrict__ qs, const float* __restrict__ x,
               float* __restrict__ out, int64_t Q, int64_t n, int64_t d) {
  __shared__ float qsh[TK][TM + 1];
  __shared__ float xsh[TK][TN + 1];
  const int tx = threadIdx.x & 15;       // rows tx, tx + 16, tx + 32, tx + 48
  const int ty = threadIdx.x >> 4;       // queries ty, ty + 16, ...
  const int64_t q0 = (int64_t)blockIdx.y * TM;
  const int64_t r0 = (int64_t)blockIdx.x * TN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = 0; k0 < d; k0 += TK) {
    // a warp loads 32 consecutive coordinates of one row; out-of-range
    // entries are 0 in both operands and add nothing
#pragma unroll
    for (int e = 0; e < (TM * TK) / kThreads; ++e) {
      const int idx = threadIdx.x + kThreads * e;
      const int r = idx / TK, c = idx % TK;
      const int64_t gk = k0 + c;
      const int64_t gq = q0 + r, gr = r0 + r;
      qsh[c][r] = (gq < Q && gk < d) ? qs[gq * d + gk] : 0.f;
      xsh[c][r] = (gr < n && gk < d) ? x[gr * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qsh[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = xsh[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += term<L1>(a[i], b[j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t gq = q0 + ty + 16 * i;
    if (gq >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t gr = r0 + tx + 16 * j;
      if (gr < n) out[gq * n + gr] = acc[i][j];
    }
  }
}

template <bool L1>
__global__ void __launch_bounds__(kThreads)
pairwise_rows(const float* __restrict__ qs, const float* __restrict__ x,
              float* __restrict__ out, int64_t n, int64_t d) {
  __shared__ float part[kThreads / 32];
  const int64_t pair = blockIdx.x;       // q * n + r
  const float* qr = qs + (pair / n) * d;
  const float* xr = x + (pair % n) * d;
  float s = 0.f;
#pragma unroll 4
  for (int64_t c = threadIdx.x; c < d; c += kThreads) s += term<L1>(qr[c], xr[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kThreads / 32 ? part[lane] : 0.f;
#pragma unroll
    for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    if (lane == 0) out[pair] = s;
  }
}

template <bool L1>
void launch(const float* qs, const float* x, float* out, int64_t Q, int64_t n,
            int64_t d, cudaStream_t stream) {
  if (Q <= kRowWiseMaxQ) {
    pairwise_rows<L1><<<(unsigned)(Q * n), kThreads, 0, stream>>>(qs, x, out, n, d);
  } else {
    const dim3 grid((unsigned)((n + TN - 1) / TN), (unsigned)((Q + TM - 1) / TM));
    pairwise_tiled<L1><<<grid, kThreads, 0, stream>>>(qs, x, out, Q, n, d);
  }
}

}  // namespace

// qs (Q, d) fp32; x (n, d) fp32; out (Q, n) fp32; all contiguous. metric:
// 0 = l2 (squared), 1 = l1. Returns cudaGetLastError() after the launch.
// The grid needs ceil(n / 64) < 2^31 and ceil(Q / 64) <= 65,535 tiles, or
// Q * n < 2^31 pairs when Q <= 4.
extern "C" int pairwise_dist_f32(const void* qs, const void* x, void* out,
                                 int64_t Q, int64_t n, int64_t d, int metric,
                                 void* stream) {
  if (Q <= 0 || n <= 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(qs);
  const auto* xp = static_cast<const float*>(x);
  auto* op = static_cast<float*>(out);
  if (metric == 1) {
    launch<true>(qp, xp, op, Q, n, d, s);
  } else {
    launch<false>(qp, xp, op, Q, n, d, s);
  }
  return (int)cudaGetLastError();
}
