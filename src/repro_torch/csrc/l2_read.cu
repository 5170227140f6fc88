// l2_read: a measurement kernel, not a port of a TPU kernel. It reads one
// buffer small enough to stay in L2 (8-32 MB in chip_smoke.py, which
// takes the fastest) `reps` times over, with 16-byte loads that bypass L1 (ld.global.cg), so
// that its time gives the card's L2 read rate. chip_smoke.py prices the
// pull kernels' schedules against that rate (their "L2 floor"): the rows
// schedule sends its query slices through L2 by design.
//
// One persistent grid of `blocks` blocks of 512 threads walks the buffer
// grid-stride; each thread folds what it reads into one word, written to
// out[thread] so the loads cannot be dropped.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void __launch_bounds__(512)
l2_read_kernel(const uint4* __restrict__ buf, int64_t n16, int reps,
               uint32_t* __restrict__ out) {
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  uint32_t acc = 0;
  for (int r = 0; r < reps; ++r) {
    for (int64_t i = tid; i < n16; i += 4 * stride) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = i + u * stride < n16 ? __ldcg(buf + i + u * stride)
                                    : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
  }
  out[tid] = acc;
}

}  // namespace

// buf: n16 16-byte words, 16-byte aligned; out: blocks * 512 words.
// Returns cudaGetLastError() after the launch.
extern "C" int l2_read(const void* buf, int64_t n16, int reps, int blocks,
                       void* out, void* stream) {
  l2_read_kernel<<<blocks, 512, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(buf), n16, reps, static_cast<uint32_t*>(out));
  return (int)cudaGetLastError();
}
