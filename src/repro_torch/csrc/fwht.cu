// fwht: normalized fast Walsh-Hadamard transform on NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fwht.py, fwht_pallas /
// _fwht_kernel.
//
// What it computes. y = H_d x / sqrt(d) along the last axis of (rows, d),
// d a power of two in [2, 32768], H_d in Sylvester (natural) order: one
// butterfly (a, b) -> (a + b, a - b) for each bit of the column index. Input
// fp32 or bf16; the butterflies run in fp32, the division by sqrt(d) rounded
// to fp32 is an IEEE division (a product by 2^-k where d = 4^k, which is the
// same number), and the result is cast back to the input type with
// round-to-nearest-even, as the TPU kernel does.
//
// What bounds it on this card. Device memory: each value is read once and
// written once, 2 * rows * d * itemsize bytes, against d * log2(d) additions
// a row, some 7 flops a byte below what the card does at its memory rate.
// What stands in the way is everything the butterflies move between threads:
// log2(d) = 14 stages at the main path's d = 16,384, each of which pairs
// values that some thread must bring together.
//
// What the design does about it. A thread holds E = 64 values of the row
// (128 for a bf16 row of 32,768) in registers, loaded and stored 16 bytes at a
// time (4 fp32 or 8 bf16), and every stage is arranged to need as little
// traffic as can be had (kernels/fwht_plan.py has the bit maps; the CPU tests
// replay them through ref.fwht_staged and check the layout's banks):
//   1. Load. The 16-byte access holds the column bits [0, v) (v = 2 fp32, 3
//      bf16), the lanes bits [v, v+5), so a warp reads 512 contiguous bytes;
//      the E/2^v accesses of a thread take the row's top e-v bits. All of a
//      thread's loads are issued before any is used.
//   2. log2(E) stages in registers on those bits, then the 5 lane bits by
//      __shfl_xor_sync, one shuffle and one FFMA a value a stage.
//   3. Wide rows (d > 2^(e+5): 4,096 and up in both types) need the bits
//      above the lanes, which lie in other warps: one exchange through
//      shared memory, each fp32 value written once and read once, into the
//      narrow layout whose accesses hold bits [0, v) and [v+5, e+5), where
//      the last stages run in registers. Shared-memory traffic a row: 8*d
//      bytes, 2x the fp32 row and 4x the bf16 row (it was 14 stages x 16
//      bytes a pair, 28x the fp32 row). Each warp's access to shared
//      memory is 32 float4 slots side by side (a bf16 vector's second
//      float4 lies above the lanes' 512 bytes), so every quarter-warp hits
//      all 32 banks once: no conflicts, no padding.
//   4. Scale and store from the narrow layout: again 512 contiguous bytes a
//      warp, 16 bytes a thread.
//   Narrow rows (d <= 2^(e+5)) skip step 3: a warp holds whole rows (4 warps
//   a block, at least 8,192 values), and the last block's rows past the
//   tensor are masked (a 16-byte access that would cross the end of the
//   tensor, only when d * itemsize < 16, goes value by value).
// Latency. A wide row is one block: at d = 16,384 fp32, 256 threads and 64
// KB of shared memory, launch bounds for 2 blocks an SM (at most 128
// registers), so while one block transforms its row the other's 64 KB of
// loads are in flight; chip_smoke.py reports ptxas's registers and spills
// and the blocks an SM the occupancy calculator grants.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLogD = 15;
constexpr int kNarrowWarps = 4;
constexpr unsigned kAllLanes = 0xffffffffu;

// The plan of one (type, d); kernels/fwht_plan.py computes the same numbers.
template <typename T, int LOG_D>
struct Plan {
  static constexpr int kVecLog = sizeof(T) == 4 ? 2 : 3;  // values a 16 B access
  static constexpr int kVec = 1 << kVecLog;
  // the load stages e + 5 bits, the store e - v more
  static constexpr int kELog = LOG_D <= 2 * 6 - kVecLog + 5 ? 6 : 7;
  static constexpr int kE = 1 << kELog;
  static constexpr int kAccesses = kE / kVec;       // 16 B accesses a thread
  static constexpr bool kWide = LOG_D > kELog + 5;
  static constexpr int kThreads = kWide ? 1 << (LOG_D - kELog) : 32 * kNarrowWarps;
  static constexpr int kTileLog = kWide ? LOG_D : kELog + 5 + 2;  // 4 warps
  static constexpr int kRowsPerBlock = 1 << (kTileLog - LOG_D);
  static constexpr int kSmem = kWide ? (int)sizeof(float) << LOG_D : 0;
  // wide: the shift of a thread's accesses at the load (the row's top bits)
  static constexpr int kTopShift = LOG_D - (kELog - kVecLog);
  // blocks an SM the launch bounds ask for (at most 128 registers a thread
  // for 2): two 64 KB rows at d = 16,384; one where a block holds 32,768
  static constexpr int kMinBlocks = kE * kThreads <= 16384 ? 2 : 1;
  static_assert(LOG_D <= 2 * kELog - kVecLog + 5, "a row the plan cannot cover");
};

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ uint32_t bf16_pack(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// one 16-byte access: 4 fp32 or 8 bf16 values as fp32
__device__ __forceinline__ void load16(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* v) {
  const uint4 a = __ldcs(reinterpret_cast<const uint4*>(p));
  v[0] = bf16_lo(a.x); v[1] = bf16_hi(a.x); v[2] = bf16_lo(a.y); v[3] = bf16_hi(a.y);
  v[4] = bf16_lo(a.z); v[5] = bf16_hi(a.z); v[6] = bf16_lo(a.w); v[7] = bf16_hi(a.w);
}
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(bf16_pack(v[0], v[1]), bf16_pack(v[2], v[3]),
                                            bf16_pack(v[4], v[5]), bf16_pack(v[6], v[7]));
}

// the narrow kernel's accesses near the end of the tensor: value by value
// where a 16-byte access would cross it, none past it
template <typename T>
__device__ __forceinline__ void load16_masked(const T* x, int64_t i, int64_t total, float* v) {
  constexpr int kVec = 16 / sizeof(T);
  if (i + kVec <= total) return load16(x + i, v);
#pragma unroll
  for (int k = 0; k < kVec; ++k) v[k] = i + k < total ? to_f32(x[i + k]) : 0.0f;
}
template <typename T>
__device__ __forceinline__ void store16_masked(T* y, int64_t i, int64_t total, const float* v) {
  constexpr int kVec = 16 / sizeof(T);
  if (i + kVec <= total) return store16(y + i, v);
#pragma unroll
  for (int k = 0; k < kVec; ++k)
    if (i + k < total) y[i + k] = from_f32<T>(v[k]);
}

// butterflies on register bit `bit` (a compile-time constant once unrolled)
template <int E>
__device__ __forceinline__ void reg_stage(float* r, int bit) {
  const int m = 1 << bit;
#pragma unroll
  for (int p = 0; p < E; ++p) {
    if (p & m) continue;
    const float a = r[p], b = r[p | m];
    r[p] = a + b;
    r[p | m] = a - b;
  }
}

// butterflies on lane bit `bit`: the lane with the bit clear keeps a + b,
// the other b' = a - b, one shuffle and one FFMA (+-1 * mine + theirs,
// rounded once as an addition is) a value
template <int E>
__device__ __forceinline__ void lane_stage(float* r, int lane, int bit) {
  const float sign = (lane >> bit) & 1 ? -1.0f : 1.0f;
#pragma unroll
  for (int p = 0; p < E; ++p) {
    const float other = __shfl_xor_sync(kAllLanes, r[p], 1 << bit);
    r[p] = fmaf(sign, r[p], other);
  }
}

// the division by sqrt(d) rounded to fp32; for d = 4^k it is exact, the
// product by 2^-k
template <int LOG_D>
__device__ __forceinline__ float normalize(float v, float scale) {
  if constexpr (LOG_D % 2 == 0) return v * (1.0f / (float)(1 << (LOG_D / 2)));
  else return __fdiv_rn(v, scale);
}

template <typename T, int LOG_D>
__global__ void __launch_bounds__(Plan<T, LOG_D>::kThreads)
fwht_kernel_narrow(const T* __restrict__ x, T* __restrict__ y, int64_t total,
                   float scale) {
  using P = Plan<T, LOG_D>;
  constexpr int V = P::kVecLog;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t first = ((int64_t)blockIdx.x << P::kTileLog) +
                        ((int64_t)warp << (P::kELog + 5));
  if (first >= total) return;  // a whole warp past the end: no shuffle waits on it
  const int64_t base = first + (lane << V);
  float r[P::kE];
#pragma unroll
  for (int h = 0; h < P::kAccesses; ++h)
    load16_masked(x, base + ((int64_t)h << (V + 5)), total, r + h * P::kVec);
  // register bit k holds column bit k (k < v) or k + 5; lane bit b column v + b
#pragma unroll
  for (int k = 0; k < P::kELog; ++k)
    if ((k < V ? k : k + 5) < LOG_D) reg_stage<P::kE>(r, k);
#pragma unroll
  for (int b = 0; b < 5; ++b)
    if (V + b < LOG_D) lane_stage<P::kE>(r, lane, b);
#pragma unroll
  for (int p = 0; p < P::kE; ++p) r[p] = normalize<LOG_D>(r[p], scale);
#pragma unroll
  for (int h = 0; h < P::kAccesses; ++h)
    store16_masked(y, base + ((int64_t)h << (V + 5)), total, r + h * P::kVec);
}

template <typename T, int LOG_D>
__global__ void __launch_bounds__(Plan<T, LOG_D>::kThreads, Plan<T, LOG_D>::kMinBlocks)
fwht_kernel_wide(const T* __restrict__ x, T* __restrict__ y, float scale) {
  using P = Plan<T, LOG_D>;
  constexpr int V = P::kVecLog;
  constexpr int kGroups = P::kVec / 4;  // float4 groups of one access
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* src = x + ((int64_t)blockIdx.x << LOG_D);
  T* dst = y + ((int64_t)blockIdx.x << LOG_D);
  float r[P::kE];

  // load: register bits [0, v) and the top e - v column bits, lanes
  // [v, v+5), warps the bits between
  const int load_base = (lane << V) | (warp << (V + 5));
#pragma unroll
  for (int h = 0; h < P::kAccesses; ++h)
    load16(src + (load_base | (h << P::kTopShift)), r + h * P::kVec);
#pragma unroll
  for (int k = 0; k < P::kELog; ++k) reg_stage<P::kE>(r, k);
#pragma unroll
  for (int b = 0; b < 5; ++b) lane_stage<P::kE>(r, lane, b);

  // the exchange: column i's float4 group lies at float4 slot
  // lane | group << 5 | (i >> (v+5)) << (v+3), i.e. fwht_plan.smem_addr / 4
#pragma unroll
  for (int h = 0; h < P::kAccesses; ++h) {
    const int hi = ((warp << (V + 5)) | (h << P::kTopShift)) >> 2;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float* v = r + h * P::kVec + 4 * g;
      smem[lane | (g << 5) | hi] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  __syncthreads();
  // the narrow layout: register bits [0, v) and [v+5, e+5), warps the rest
  const int store_base = (lane << V) | (warp << (P::kELog + 5));
#pragma unroll
  for (int h = 0; h < P::kAccesses; ++h) {
    const int hi = ((warp << (P::kELog + 5)) | (h << (V + 5))) >> 2;
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 a = smem[lane | (g << 5) | hi];
      float* v = r + h * P::kVec + 4 * g;
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    }
  }
  // register bit k >= v holds column bit k + 5: stage those the load did not
#pragma unroll
  for (int k = V; k < P::kELog; ++k)
    if (k + 5 < P::kTopShift) reg_stage<P::kE>(r, k);
#pragma unroll
  for (int p = 0; p < P::kE; ++p) r[p] = normalize<LOG_D>(r[p], scale);
#pragma unroll
  for (int h = 0; h < P::kAccesses; ++h)
    store16(dst + (store_base | (h << (V + 5))), r + h * P::kVec);
}

template <typename T, int LOG_D>
int launch(const void* x, void* y, int64_t rows, cudaStream_t stream) {
  using P = Plan<T, LOG_D>;
  // sqrt(d) rounded to fp32, divided by as the reference divides
  const float scale = (float)sqrt((double)(1 << LOG_D));
  const T* in = static_cast<const T*>(x);
  T* out = static_cast<T*>(y);
  if constexpr (P::kWide) {
    if (P::kSmem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fwht_kernel_wide<T, LOG_D>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
      if (err != cudaSuccess) return (int)err;
    }
    fwht_kernel_wide<T, LOG_D><<<(unsigned)rows, P::kThreads, P::kSmem, stream>>>(in, out, scale);
  } else {
    const int64_t grid = (rows + P::kRowsPerBlock - 1) / P::kRowsPerBlock;
    fwht_kernel_narrow<T, LOG_D><<<(unsigned)grid, P::kThreads, 0, stream>>>(
        in, out, rows << LOG_D, scale);
  }
  return (int)cudaGetLastError();
}

// {E, threads, rows a block, dynamic shared bytes, blocks an SM}
template <typename T, int LOG_D>
int plan_of(int* out) {
  using P = Plan<T, LOG_D>;
  out[0] = P::kE;
  out[1] = P::kThreads;
  out[2] = P::kRowsPerBlock;
  out[3] = P::kSmem;
  cudaError_t err;
  if constexpr (P::kWide) {
    if (P::kSmem > 48 * 1024) {
      err = cudaFuncSetAttribute(fwht_kernel_wide<T, LOG_D>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], fwht_kernel_wide<T, LOG_D>, P::kThreads, P::kSmem);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4], fwht_kernel_narrow<T, LOG_D>, P::kThreads, 0);
  }
  return (int)err;
}

template <typename T, int LOG_D = 1>
int dispatch(int log2d, const void* x, void* y, int64_t rows, cudaStream_t stream,
             int* plan) {
  if constexpr (LOG_D > kMaxLogD) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (log2d != LOG_D) return dispatch<T, LOG_D + 1>(log2d, x, y, rows, stream, plan);
    return plan ? plan_of<T, LOG_D>(plan) : launch<T, LOG_D>(x, y, rows, stream);
  }
}

bool valid_d(int d) { return d >= 2 && d <= (1 << kMaxLogD) && (d & (d - 1)) == 0; }

int run(int d, int dtype, const void* x, void* y, int64_t rows, void* stream, int* plan) {
  if (!valid_d(d)) return (int)cudaErrorInvalidValue;
  int log2d = 0;
  while ((1 << log2d) < d) ++log2d;
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(log2d, x, y, rows, s, plan);
    case 1: return dispatch<__nv_bfloat16>(log2d, x, y, rows, s, plan);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x, y (rows, d) contiguous, 16-byte aligned, same type: dtype 0 = fp32,
// 1 = bf16. d a power of two in [2, 32768]. Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue without launching for an
// unsupported d or dtype.
extern "C" int fwht_rows(const void* x, void* y, int64_t rows, int d,
                         int dtype, void* stream) {
  if (rows <= 0) return valid_d(d) ? (int)cudaSuccess : (int)cudaErrorInvalidValue;
  return run(d, dtype, x, y, rows, stream, nullptr);
}

// The kernel's plan for (d, dtype) into out[5]: E, threads, rows a block,
// dynamic shared bytes (kernels/fwht_plan.py's numbers), and the blocks an
// SM holds at once by the occupancy calculator. Returns a CUDA error code.
extern "C" int fwht_plan_of(int d, int dtype, int* out) {
  return run(d, dtype, nullptr, nullptr, 0, nullptr, out);
}
