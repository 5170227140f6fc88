// fwht: normalized fast Walsh-Hadamard transform on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fwht.py, fwht_pallas /
// _fwht_kernel.
//
// What it computes. y = H_d x / sqrt(d) along the last axis of (rows, d),
// d a power of two <= 32768, H_d in Sylvester (natural) order. Input fp32 or
// bf16; the butterflies run in fp32 and the result is cast back to the input
// type (round to nearest even), as the TPU kernel does.
//
// What bounds it on this card. Memory: 2 * rows * d * itemsize bytes of
// device traffic against d*log2(d) additions per row, far below the card's
// compute rate. The log2(d) butterfly stages themselves run out of shared
// memory, whose bandwidth is an order above the device memory's.
//
// What the design does about it. One block per row (per few rows when d is
// small, so a block always holds at least 4096 values): the row is read once
// with coalesced loads into dynamic shared memory, transformed there with
// log2(d) stages (a, b) -> (a + b, a - b) at stride h = 1, 2, 4, ..., and
// written once. A row of 16,384 fp32 values is 64 KB and one of 32,768 is
// 128 KB, above the 48 KB default, so the launch raises the kernel's dynamic
// shared-memory limit first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMinValuesPerBlock = 4096;
constexpr int kMaxD = 32768;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void fwht_kernel(const T* __restrict__ x, T* __restrict__ y,
                            int64_t rows, int d, int log2d, int rows_per_block,
                            float scale) {
  extern __shared__ float s[];
  const int64_t row0 = (int64_t)blockIdx.x * rows_per_block;
  const int nrows = (int)min((int64_t)rows_per_block, rows - row0);
  const int nvals = nrows * d;
  const T* src = x + row0 * d;
  for (int i = threadIdx.x; i < nvals; i += blockDim.x) s[i] = to_f32(src[i]);
  __syncthreads();

  const int half = d >> 1;
  const int npairs = nrows * half;
  for (int lh = 0; lh < log2d; ++lh) {
    const int h = 1 << lh;
    for (int p = threadIdx.x; p < npairs; p += blockDim.x) {
      const int r = p >> (log2d - 1);
      const int pp = p & (half - 1);
      const int i = r * d + ((pp >> lh) << (lh + 1)) + (pp & (h - 1));
      const float a = s[i], b = s[i + h];
      s[i] = a + b;
      s[i + h] = a - b;
    }
    __syncthreads();
  }

  T* dst = y + row0 * d;
  for (int i = threadIdx.x; i < nvals; i += blockDim.x) dst[i] = from_f32<T>(s[i] / scale);
}

template <typename T>
int launch(const void* x, void* y, int64_t rows, int d, cudaStream_t stream) {
  int log2d = 0;
  while ((1 << log2d) < d) ++log2d;
  const int rows_per_block = d >= kMinValuesPerBlock ? 1 : kMinValuesPerBlock / d;
  const int64_t grid = (rows + rows_per_block - 1) / rows_per_block;
  const int pairs = rows_per_block * (d >> 1);
  const int threads = pairs < 1024 ? (pairs < 32 ? 32 : pairs) : 1024;
  const size_t smem = (size_t)rows_per_block * d * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwht_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // the scale is sqrt(d) rounded to fp32, divided as the reference divides
  const float scale = (float)sqrt((double)d);
  fwht_kernel<T><<<(unsigned)grid, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, d, log2d,
      rows_per_block, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y (rows, d) contiguous, same type: dtype 0 = fp32, 1 = bf16. d a power
// of two in [2, 32768]. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue without launching for an unsupported d or dtype.
extern "C" int fwht_rows(const void* x, void* y, int64_t rows, int d,
                         int dtype, void* stream) {
  if (d < 2 || d > kMaxD || (d & (d - 1)) != 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(x, y, rows, d, s);
    case 1: return launch<__nv_bfloat16>(x, y, rows, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
