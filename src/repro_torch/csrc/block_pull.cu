// block_pull: the BMO Monte-Carlo pull on NVIDIA Hopper (sm_90a), for one
// query or a batch of queries.
//
// Replaces the TPU kernels src/repro/kernels/block_pull.py,
// block_pull_multi_pallas / _pull_multi_kernel and block_pull_pallas /
// _pull_kernel. Both entry points below run these kernels: the
// single-query pull is the batched one with Q = 1.
//
// What it computes. For each (query q, selected arm b, pull p):
//   out[q,b,p] = mean_{j<block} (x[arm[q,b], blk[q,b,p]*block + j] - qs[q, same])^2
// (|.| for l1), in fp32 whatever the input type (fp32 or bf16).
// Output (Q, B, P) fp32.
//
// What bounds it on this card. Memory: each pull is one contiguous
// block-wide slice (512 B at block = 128 fp32) of a corpus row far larger
// than the 50 MB L2, and the same slice of a query row. Its arithmetic (3
// flops per element) is negligible beside that, and the tensor cores have
// no product to take here (see fused_epoch_pull.cu).
//
// What the design does about it: two schedules, picked by the wrapper from
// the operands' shapes and strides (kernels/pull_schedule.py).
//
// "pair", for a round and for the paper path: one warp per pull, flattened
// into blockIdx.x, 8 warps per block. Each slice is read with vector loads
// of up to 16 bytes, neighbouring lanes on neighbouring addresses, and
// reduced with warp shuffles, so a 512-byte slice is four full 128-byte
// transactions. Many warps in flight per SM keep enough loads outstanding
// to cover the device-memory latency. A round reads only P = 2 slices of
// each query row, so staging the rows would cost more than it saves.
//
// "rows", for the wide init, where every query races the same arm vector
// (an expanded (Q, B) tensor, passed here as one (B,) vector): a block owns
// one arm, copies its row into shared memory once by TMA bulk copies, then
// walks every query (pull_common.cuh): the corpus crosses device memory
// once per launch and only the query side goes through L2.
//
// The pair kernel takes the arm and block ids as the caller holds them,
// int32 or int64 (the paper path's arm ids are int64, its block ids int32),
// instantiated for each pair of types, so a call launches this one kernel
// and no conversion. The rows kernel takes the block ids likewise and the
// (B,) arm vector as int32.
//
// Offsets are 64-bit: arm * d_pad reaches 131,071 * 16,384 > INT32_MAX.
// A negative arm id marks a lane whose result the caller discards: nothing
// is read and the result is 0. An arm or block id out of range gives NaN,
// and nothing outside the corpus is read.
#include "pull_common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

using pull::Raw;
using pull::to_float;

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
                  const IA* __restrict__ arm_idx, int64_t arm_stride,
                  const IB* __restrict__ blk_idx,
                  float* __restrict__ out, int64_t n, int64_t d_pad,
                  int64_t B, int64_t P, int64_t pulls) {
  const int lane = threadIdx.x & 31;
  const int64_t pull =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (pull >= pulls) return;
  const int64_t pair = pull / P;          // q * B + b
  const int64_t q = pair / B;
  const int64_t arm = arm_idx[q * arm_stride + (pair - q * B)];
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

// the rows schedule: arm blockIdx.x of the shared (B,) vector staged in
// shared memory, then every query in order, one a group of 8 lanes (four a
// warp), each query's P pulls two at a time
template <typename T, int BLOCK, bool L1, typename IB>
__global__ void __launch_bounds__(pull::kRowsWarps * 32, pull::kRowsMinBlocks)
block_pull_rows_kernel(const T* __restrict__ x, const T* __restrict__ qs,
                       const int32_t* __restrict__ arms,
                       const IB* __restrict__ blk_idx,
                       float* __restrict__ out, int64_t n, int64_t d_pad,
                       int64_t Q, int64_t B, int64_t P) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  T* row = reinterpret_cast<T*>(smem);
  const int64_t b = blockIdx.x;
  const int64_t arm = arms[b];
  const bool reads = arm >= 0 && arm < n;
  pull::stage_row(row, x, arm, n, d_pad, &bar);

  const int lane = threadIdx.x & 31, grp = lane >> 3, gl = lane & 7;
  const int64_t nb = d_pad / BLOCK;
  constexpr int64_t step = pull::kRowsWarps * pull::kGroupsPerWarp;
  int64_t base = (int64_t)(threadIdx.x >> 5) * pull::kGroupsPerWarp;
  int64_t q = pull::rows_query(base + grp, Q);
  int64_t c0, c1;
  pull::first_ids(blk_idx + (q * B + b) * P, P, reads, c0, c1);
  for (; base < Q; base += step) {
    const bool live = base + grp < Q;
    const int64_t nq = pull::rows_query(base + step + grp, Q);
    int64_t n0, n1;
    pull::first_ids(blk_idx + (nq * B + b) * P, P, reads && base + step < Q,
                    n0, n1);
    const T* qr = reads ? qs + q * d_pad : row;
    const IB* bl = blk_idx + (q * B + b) * P;
    float* o = out + (q * B + b) * P;
    // a bad block id is flagged and read as block 0, so no load leaves the row
    auto offset = [&](int64_t i, bool& ok) -> int64_t {
      if (!reads) { ok = true; return 0; }
      const int64_t k = i == 0 ? c0 : i == 1 ? c1 : (int64_t)bl[i];
      ok = k >= 0 && k < nb;
      return (ok ? k : 0) * BLOCK;
    };
    auto value = [&](float s, bool ok) -> float {
      return arm < 0 ? 0.f : (arm >= n || !ok) ? NAN : s / (float)BLOCK;
    };
    int64_t i = 0;
    for (; i + 1 < P; i += 2) {
      bool ok0, ok1;
      const int64_t o0 = offset(i, ok0), o1 = offset(i + 1, ok1);
      const float s0 = pull::group_partial<T, BLOCK, L1>(row + o0, qr + o0, gl);
      const float s1 = pull::group_partial<T, BLOCK, L1>(row + o1, qr + o1, gl);
      const float v0 = value(pull::group_sum(s0), ok0);
      const float v1 = value(pull::group_sum(s1), ok1);
      if (live && gl == 0) { o[i] = v0; o[i + 1] = v1; }
    }
    if (i < P) {
      bool ok0;
      const int64_t o0 = offset(i, ok0);
      const float v0 = value(pull::group_sum(pull::group_partial<T, BLOCK, L1>(
                                 row + o0, qr + o0, gl)), ok0);
      if (live && gl == 0) o[i] = v0;
    }
    q = nq;
    c0 = n0;
    c1 = n1;
  }
}

struct Args {
  const void* x; const void* qs; const void* arm; const void* blk;
  float* out; int64_t n, d_pad, Q, B, P, arm_stride; bool rows;
};

template <typename T, int BLOCK, bool L1, typename IA, typename IB>
int launch(const Args& a, cudaStream_t stream) {
  const auto* xp = static_cast<const T*>(a.x);
  const auto* qp = static_cast<const T*>(a.qs);
  const auto* bp = static_cast<const IB*>(a.blk);
  if (a.rows) {
    const size_t smem = (size_t)a.d_pad * sizeof(T);
    auto kernel = block_pull_rows_kernel<T, BLOCK, L1, IB>;
    cudaError_t err = pull::allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)a.B, pull::kRowsWarps * 32, smem, stream>>>(
        xp, qp, static_cast<const int32_t*>(a.arm), bp, a.out, a.n, a.d_pad,
        a.Q, a.B, a.P);
  } else {                                // pair
    const int64_t pulls = a.Q * a.B * a.P;
    const unsigned grid =
        (unsigned)((pulls + kWarpsPerBlock - 1) / kWarpsPerBlock);
    block_pull_kernel<T, BLOCK, L1, IA, IB>
        <<<grid, kWarpsPerBlock * 32, 0, stream>>>(
            xp, qp, static_cast<const IA*>(a.arm), a.arm_stride, bp, a.out,
            a.n, a.d_pad, a.B, a.P, pulls);
  }
  return (int)cudaGetLastError();
}

template <typename T, int BLOCK, typename IA, typename IB>
int launch_metric(bool l1, const Args& a, cudaStream_t s) {
  return l1 ? launch<T, BLOCK, true, IA, IB>(a, s)
            : launch<T, BLOCK, false, IA, IB>(a, s);
}

template <typename T, typename IA, typename IB>
int dispatch(int block, bool l1, const Args& a, cudaStream_t s) {
  switch (block) {
    case 32:  return launch_metric<T, 32, IA, IB>(l1, a, s);
    case 64:  return launch_metric<T, 64, IA, IB>(l1, a, s);
    case 128: return launch_metric<T, 128, IA, IB>(l1, a, s);
    case 256: return launch_metric<T, 256, IA, IB>(l1, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// the id types: 0 = int32, 1 = int64; the rows schedule takes int32 arms
template <typename T>
int dispatch_ids(int arm_type, int blk_type, int block, bool l1,
                 const Args& a, cudaStream_t s) {
  if (arm_type == 0 && blk_type == 0)
    return dispatch<T, int32_t, int32_t>(block, l1, a, s);
  if (arm_type == 0 && blk_type == 1)
    return dispatch<T, int32_t, int64_t>(block, l1, a, s);
  if (a.rows) return (int)cudaErrorInvalidValue;
  if (arm_type == 1 && blk_type == 0)
    return dispatch<T, int64_t, int32_t>(block, l1, a, s);
  if (arm_type == 1 && blk_type == 1)
    return dispatch<T, int64_t, int64_t>(block, l1, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x (n, d_pad); qs (Q, d_pad), both fp32 (dtype 0) or both bf16 (dtype 1);
// blk (Q, B, P), int32 (type 0) or int64 (type 1); out (Q, B, P) fp32. x,
// qs and blk contiguous, x and qs 16-byte aligned. metric: 0 = l2, 1 = l1.
// rows 0: the pair schedule, arm (Q, B) int32 or int64 at
// arm[q * arm_stride + b] (arm_stride 0 for a vector every query shares);
// the grid needs ceil(Q*B*P / 8) < 2^31 blocks. rows 1: the rows schedule,
// one block an arm (B < 2^31), arm the (B,) int32 vector every query
// shares. Returns cudaGetLastError() after the launch; an unsupported block
// width or type returns cudaErrorInvalidValue without launching.
extern "C" int block_pull_multi(const void* x, const void* qs, const void* arm,
                                const void* blk, void* out, int64_t n,
                                int64_t d_pad, int64_t Q, int64_t B, int64_t P,
                                int64_t arm_stride, int block, int metric,
                                int dtype, int arm_type, int blk_type,
                                int rows, void* stream) {
  if (Q * B * P <= 0) return (int)cudaSuccess;
  auto s = static_cast<cudaStream_t>(stream);
  const bool l1 = metric == 1;
  const Args a{x, qs, arm, blk, static_cast<float*>(out), n, d_pad, Q, B, P,
               arm_stride, rows != 0};
  if (dtype == 0) return dispatch_ids<float>(arm_type, blk_type, block, l1, a, s);
  if (dtype == 1)
    return dispatch_ids<__nv_bfloat16>(arm_type, blk_type, block, l1, a, s);
  return (int)cudaErrorInvalidValue;
}
