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
// What bounds it on this card. Memory: each pull is one block-wide slice
// (512 B at block = 128) of a corpus row and the same slice of a query row,
// and the corpus (8.6 GB at the main path's 131,072 x 16,384) is far larger
// than the 50 MB L2. Its arithmetic (3 flops per element) is negligible
// beside the bytes. Neither tensor core product helps: each (query, arm)
// pair reads its own 2-128 random blocks, a gather and not a product, and
// computing every block's distance to keep two would be Q*n*d*2 = 4.4 PFLOP
// at the init, some 9 ms at the TF32 rate before any precision repair,
// against 1.5 ms for the pulls themselves on the CUDA cores.
//
// What the design does about it: two schedules, picked by the wrapper from
// the operands' shapes and strides (kernels/pull_schedule.py).
//
// "rows", for the wide init, where every query races the same arm vector
// (an expanded (Q, B) tensor, passed here as one (B,) vector): a block owns
// one arm, copies its row into shared memory once by TMA bulk copies, then
// walks every query, reading that query's block ids and query slices from
// device memory (L2) and the arm's slices from shared memory. So the corpus
// crosses device memory once per launch and only the query side goes
// through L2. The blocks in flight walk the queries in the same order, from
// the first, so the query rows they read at one time form a window that can
// stay in L2. One row a block (64 KB at d_pad 16,384) keeps three blocks on
// an SM, so one stages its row while two stream queries; each group loads
// its next query's first block ids a step ahead.
//
// "pair", for everything else (the epochs): a block serves one query and
// copies its row into shared memory once. Each warp takes four of the
// query's arms, one per group of 8 lanes, and first marks in a bitmap the
// distinct blocks each arm's T pulls touch (T = 128 draws over 128 blocks
// touch about 81). It then streams those blocks once each through a ring of
// n_buf slots in shared memory (TMA bulk copies completing on one mbarrier
// a slot, n_buf pulls of each arm in flight: the reference's streaming
// depth, cfg.kernel_buffers), computes each block's distance into a table,
// and finally folds the table's values in t order. The fold, and so the
// result, is the sequential one; each distinct block is read from device
// memory once and the query row once. Where the query row and the ring do
// not fit in shared memory together, the query slices are read from device
// memory (L2) as they are summed.
//
// Offsets are 64-bit: arm * d_pad reaches 131,071 * 16,384 > INT32_MAX.
// A negative arm id marks a lane whose result the caller discards: nothing
// is read and the result is (0, 0). An arm or block id out of range gives
// NaN, and nothing outside the corpus is read.
#include "pull_common.cuh"

namespace {

using pull::kGroupsPerWarp;

constexpr int kMaxWarps = 16;   // a pair block's warps at most

// running Welford over the T pulls, the TPU kernel's order
struct Welford {
  float mean = 0.f, m2 = 0.f;
  __device__ __forceinline__ void fold(float v, int64_t t) {
    const float delta = v - mean;
    mean = mean + delta / (float)(t + 1);
    m2 = m2 + delta * (v - mean);
  }
};

__device__ __forceinline__ void write_stats(float* o, bool skip, bool bad,
                                            const Welford& w) {
  *reinterpret_cast<float2*>(o) =
      skip ? make_float2(0.f, 0.f)
           : bad ? make_float2(NAN, NAN) : make_float2(w.mean, w.m2);
}

// --- rows: one arm of a vector shared by every query ------------------------
template <int BLOCK, bool L1>
__global__ void __launch_bounds__(pull::kRowsWarps * 32, pull::kRowsMinBlocks)
fused_epoch_pull_rows_kernel(const float* __restrict__ x,
                             const float* __restrict__ qs,
                             const int32_t* __restrict__ arms,
                             const int32_t* __restrict__ blk_idx,
                             float* __restrict__ out, int64_t n, int64_t d_pad,
                             int64_t Q, int64_t B, int64_t T) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar;
  float* row = reinterpret_cast<float*>(smem);
  const int64_t b = blockIdx.x;
  const int64_t arm = arms[b];
  const bool reads = arm >= 0 && arm < n;
  pull::stage_row(row, x, arm, n, d_pad, &bar);

  const int lane = threadIdx.x & 31, grp = lane >> 3, gl = lane & 7;
  const int64_t nb = d_pad / BLOCK;
  constexpr int64_t step = pull::kRowsWarps * kGroupsPerWarp;
  int64_t base = (int64_t)(threadIdx.x >> 5) * kGroupsPerWarp;
  int64_t q = pull::rows_query(base + grp, Q);
  int64_t c0, c1;
  pull::first_ids(blk_idx + (q * B + b) * T, T, reads, c0, c1);
  for (; base < Q; base += step) {
    const bool live = base + grp < Q;
    const int64_t nq = pull::rows_query(base + step + grp, Q);
    int64_t n0, n1;
    pull::first_ids(blk_idx + (nq * B + b) * T, T, reads && base + step < Q,
                    n0, n1);
    const float* qr = reads ? qs + q * d_pad : row;
    const int32_t* bl = blk_idx + (q * B + b) * T;
    // pull t's block (0 where the pair reads nothing); a bad id is flagged
    // and read as block 0, so no load leaves the row
    auto block_at = [&](int64_t t) -> int64_t {
      return !reads ? 0 : t == 0 ? c0 : t == 1 ? c1 : (int64_t)bl[t];
    };
    bool bad = arm >= n;
    Welford w;
    int64_t t = 0;
    // two pulls per step: both query slices are loaded before either is
    // reduced
    for (; t + 1 < T; t += 2) {
      const int64_t k0 = block_at(t), k1 = block_at(t + 1);
      const bool ok0 = k0 >= 0 && k0 < nb, ok1 = k1 >= 0 && k1 < nb;
      bad = bad || !ok0 || !ok1;
      const int64_t o0 = (ok0 ? k0 : 0) * BLOCK, o1 = (ok1 ? k1 : 0) * BLOCK;
      const float s0 = pull::group_partial<float, BLOCK, L1>(row + o0, qr + o0, gl);
      const float s1 = pull::group_partial<float, BLOCK, L1>(row + o1, qr + o1, gl);
      w.fold(pull::group_sum(s0) / (float)BLOCK, t);
      w.fold(pull::group_sum(s1) / (float)BLOCK, t + 1);
    }
    if (t < T) {
      const int64_t k0 = block_at(t);
      const bool ok0 = k0 >= 0 && k0 < nb;
      bad = bad || !ok0;
      const int64_t o0 = (ok0 ? k0 : 0) * BLOCK;
      w.fold(pull::group_sum(pull::group_partial<float, BLOCK, L1>(
                 row + o0, qr + o0, gl)) / (float)BLOCK, t);
    }
    if (live && gl == 0)
      write_stats(out + (q * B + b) * 2, arm < 0, bad, w);
    q = nq;
    c0 = n0;
    c1 = n1;
  }
}

// --- pair: one query a block, each arm's distinct blocks streamed once ------
//
// Shared memory, in this order (pair_smem below gives its size):
//   query row     d_pad floats (when staged)
//   ring          warps x n_buf slots x 4 arms x block floats
//   table         warps x 4 arms x nb floats: each distinct block's value
//   bitmap        warps x 4 arms x ceil(nb / 32) words
//   slot blocks   warps x n_buf x 4 block ids: what each slot holds
//   barriers      warps x n_buf (4 arrivals each: one a group) + 1 (the row)
__host__ __device__ inline size_t pair_smem(bool stage, int64_t d_pad,
                                            int block, int warps, int n_buf) {
  const int64_t nb = d_pad / block, words = (nb + 31) / 32;
  size_t bytes = stage ? (size_t)d_pad * 4 : 0;
  bytes += (size_t)warps * n_buf * kGroupsPerWarp * block * 4;
  bytes += (size_t)warps * kGroupsPerWarp * nb * 4;
  bytes += (size_t)warps * kGroupsPerWarp * words * 4;
  bytes += (size_t)warps * n_buf * kGroupsPerWarp * 4;
  bytes = (bytes + 7) & ~(size_t)7;
  return bytes + ((size_t)warps * n_buf + 1) * 8;
}

template <int BLOCK, bool L1, bool STAGE_Q>
__global__ void __launch_bounds__(kMaxWarps * 32)
fused_epoch_pull_pair_kernel(const float* __restrict__ x,
                             const float* __restrict__ qs,
                             const int32_t* __restrict__ arm_idx,
                             int64_t arm_stride,
                             const int32_t* __restrict__ blk_idx,
                             float* __restrict__ out, int64_t n, int64_t d_pad,
                             int64_t B, int64_t T, int n_buf) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int SLOT = kGroupsPerWarp * BLOCK;  // floats
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 3, gl = lane & 7;
  const int64_t q = blockIdx.x;
  const int64_t nb = d_pad / BLOCK;
  const int words = (int)((nb + 31) / 32);

  float* qrow = reinterpret_cast<float*>(smem);
  float* ring = qrow + (STAGE_Q ? d_pad : 0);
  float* table = ring + (size_t)warps * n_buf * SLOT;
  uint32_t* bits = reinterpret_cast<uint32_t*>(
      table + (size_t)warps * kGroupsPerWarp * nb);
  int32_t* slot_blk = reinterpret_cast<int32_t*>(
      bits + (size_t)warps * kGroupsPerWarp * words);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + pair_smem(STAGE_Q, d_pad, BLOCK, warps, n_buf)
      - ((size_t)warps * n_buf + 1) * 8);
  float* my_ring = ring + (size_t)warp * n_buf * SLOT;
  float* my_table = table + ((size_t)warp * kGroupsPerWarp + grp) * nb;
  uint32_t* my_bits = bits + ((size_t)warp * kGroupsPerWarp + grp) * words;
  int32_t* my_slot_blk = slot_blk + (size_t)warp * n_buf * kGroupsPerWarp;
  uint64_t* my_bars = bars + (size_t)warp * n_buf;
  uint64_t* row_bar = bars + (size_t)warps * n_buf;

  if (threadIdx.x == 0) {
    for (int i = 0; i < warps * n_buf; ++i) pull::mbar_init(bars + i, kGroupsPerWarp);
    pull::mbar_init(row_bar, 1);
    pull::mbar_init_fence();
  }
  __syncthreads();
  const float* qsrc = qs + q * d_pad;
  if (STAGE_Q && threadIdx.x == 0)
    pull::copy_row(qrow, qsrc, (uint32_t)(d_pad * 4), row_bar);
  bool row_ready = !STAGE_Q;
  uint32_t it = 0;   // pulls this warp has consumed: slot it % n_buf

  for (int64_t base = (int64_t)warp * kGroupsPerWarp; base < B;
       base += (int64_t)warps * kGroupsPerWarp) {
    const int64_t b = base + grp;
    const bool live = b < B;
    const int64_t arm = live ? (int64_t)arm_idx[q * arm_stride + b] : -1;
    const bool valid_arm = arm >= 0 && arm < n;
    const int32_t* bl = blk_idx + (q * B + (live ? b : 0)) * T;

    // 1. the distinct blocks of this arm's T pulls
    for (int w = gl; w < words; w += pull::kGroup) my_bits[w] = 0u;
    __syncwarp();
    bool bad = live && arm >= n;
    if (valid_arm) {
      for (int64_t t = gl; t < T; t += pull::kGroup) {
        const int64_t k = bl[t];
        if (k >= 0 && k < nb) atomicOr(&my_bits[k >> 5], 1u << (k & 31));
        else bad = true;
      }
    }
    __syncwarp();
    bad = (__ballot_sync(0xffffffffu, bad) >> (grp * pull::kGroup)) & 0xffu;
    const bool reads = valid_arm && !bad;
    int cnt = 0;
    if (reads)
      for (int w = gl; w < words; w += pull::kGroup) cnt += __popc(my_bits[w]);
#pragma unroll
    for (int w = pull::kGroup / 2; w > 0; w >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, w);
    const int steps = (int)__reduce_max_sync(0xffffffffu, (unsigned)cnt);

    // 2. stream the distinct blocks through the ring; the group's first lane
    // starts its arm's copies, walking the bitmap in block order
    const uint32_t it0 = it;
    int wi = 0;
    uint32_t wb = (gl == 0 && cnt > 0) ? my_bits[0] : 0u;
    auto fetch = [&](int s) {
      const uint32_t slot = (it0 + s) % n_buf;
      uint64_t* bar = my_bars + slot;
      if (s >= cnt) {                     // nothing left: arrive only
        pull::mbar_expect_tx(bar, 0);
        return;
      }
      while (wb == 0u) wb = my_bits[++wi];
      const int k = wi * 32 + __ffs(wb) - 1;
      wb &= wb - 1u;
      my_slot_blk[slot * kGroupsPerWarp + grp] = k;
      float* dst = my_ring + (size_t)slot * SLOT + grp * BLOCK;
      constexpr uint32_t bytes = BLOCK * 4;
      pull::mbar_expect_tx(bar, bytes);
      pull::bulk_copy(dst, x + arm * d_pad + (int64_t)k * BLOCK, bytes, bar);
    };
    if (gl == 0)
      for (int s = 0; s < min(n_buf, steps); ++s) fetch(s);
    if (!row_ready && steps > 0) {
      pull::mbar_wait(row_bar, 0);
      row_ready = true;
    }
    for (int s = 0; s < steps; ++s) {
      const uint32_t slot = (it0 + s) % n_buf;
      pull::mbar_wait(my_bars + slot, ((it0 + s) / n_buf) & 1u);
      const bool mine = s < cnt;
      const int k = mine ? my_slot_blk[slot * kGroupsPerWarp + grp] : 0;
      const float* xs = my_ring + (size_t)slot * SLOT + grp * BLOCK;
      const float* qsl = (STAGE_Q ? qrow : qsrc) + (int64_t)k * BLOCK;
      const float sum =
          pull::group_sum(pull::group_partial<float, BLOCK, L1>(xs, qsl, gl));
      if (mine && gl == 0) my_table[k] = sum / (float)BLOCK;
      __syncwarp();                       // the slot is read: refill it
      if (gl == 0 && s + n_buf < steps) fetch(s + n_buf);
    }
    it = it0 + (uint32_t)steps;
    __syncwarp();

    // 3. fold the T values in t order
    if (live && gl == 0) {
      Welford w;
      if (reads)
        for (int64_t t = 0; t < T; ++t) w.fold(my_table[bl[t]], t);
      write_stats(out + (q * B + b) * 2, arm < 0, bad, w);
    }
    __syncwarp();                         // before the next set's bitmap
  }
  // no copy may land after the block has left
  if (!row_ready) pull::mbar_wait(row_bar, 0);
}

template <int BLOCK, bool L1>
int launch(int schedule, int warps, const float* x, const float* qs,
           const int32_t* arm, int64_t arm_stride, const int32_t* blk,
           float* out, int64_t n, int64_t d_pad, int64_t Q, int64_t B,
           int64_t T, int n_buf, cudaStream_t stream) {
  cudaError_t err;
  if (schedule == 2) {                    // rows
    const size_t smem = (size_t)d_pad * 4;
    auto kernel = fused_epoch_pull_rows_kernel<BLOCK, L1>;
    if ((err = pull::allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<(unsigned)B, pull::kRowsWarps * 32, smem, stream>>>(
        x, qs, arm, blk, out, n, d_pad, Q, B, T);
  } else {                                // pair
    const bool stage = schedule == 0;
    const size_t smem = pair_smem(stage, d_pad, BLOCK, warps, n_buf);
    auto kernel = stage ? fused_epoch_pull_pair_kernel<BLOCK, L1, true>
                        : fused_epoch_pull_pair_kernel<BLOCK, L1, false>;
    if ((err = pull::allow_smem(kernel, smem)) != cudaSuccess) return (int)err;
    kernel<<<(unsigned)Q, warps * 32, smem, stream>>>(
        x, qs, arm, arm_stride, blk, out, n, d_pad, B, T, n_buf);
  }
  return (int)cudaGetLastError();
}

template <int BLOCK>
int launch_metric(bool l1, int schedule, int warps, const float* x,
                  const float* qs, const int32_t* arm, int64_t arm_stride,
                  const int32_t* blk, float* out, int64_t n, int64_t d_pad,
                  int64_t Q, int64_t B, int64_t T, int n_buf, cudaStream_t s) {
  return l1 ? launch<BLOCK, true>(schedule, warps, x, qs, arm,
                                  arm_stride, blk, out, n, d_pad, Q, B, T,
                                  n_buf, s)
            : launch<BLOCK, false>(schedule, warps, x, qs, arm,
                                   arm_stride, blk, out, n, d_pad, Q, B, T,
                                   n_buf, s);
}

}  // namespace

// x (n, d_pad) fp32; qs (Q, d_pad) fp32; blk (Q, B, T) int32; out (Q, B, 2)
// fp32. x, qs and blk contiguous, x and qs 16-byte aligned. metric: 0 = l2,
// 1 = l1. schedule: 0 = pair with the query row staged, 1 = pair with the
// query slices read from device memory, both with `warps` warps a block
// (1-16) and arm (Q, B) int32 at arm[q * arm_stride + b] (arm_stride 0 for a
// vector every query shares); 2 = rows, one block an arm (B < 2^31), arm
// the (B,) int32 vector every query shares (warps ignored). Returns
// cudaGetLastError() after the launch; an unsupported block width or
// schedule returns cudaErrorInvalidValue without launching.
extern "C" int fused_epoch_pull_f32(const void* x, const void* qs,
                                    const void* arm, const void* blk,
                                    void* out, int64_t n, int64_t d_pad,
                                    int64_t Q, int64_t B, int64_t T,
                                    int64_t arm_stride, int block, int metric,
                                    int n_buf, int schedule, int warps,
                                    void* stream) {
  if (Q * B <= 0) return (int)cudaSuccess;
  if (schedule < 0 || schedule > 2 || n_buf < 1 ||
      (schedule < 2 && (warps < 1 || warps > kMaxWarps)))
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  const bool l1 = metric == 1;
  const auto* xp = static_cast<const float*>(x);
  const auto* qp = static_cast<const float*>(qs);
  const auto* ap = static_cast<const int32_t*>(arm);
  const auto* bp = static_cast<const int32_t*>(blk);
  auto* op = static_cast<float*>(out);
  switch (block) {
    case 32:  return launch_metric<32>(l1, schedule, warps, xp, qp, ap, arm_stride, bp, op, n, d_pad, Q, B, T, n_buf, s);
    case 64:  return launch_metric<64>(l1, schedule, warps, xp, qp, ap, arm_stride, bp, op, n, d_pad, Q, B, T, n_buf, s);
    case 128: return launch_metric<128>(l1, schedule, warps, xp, qp, ap, arm_stride, bp, op, n, d_pad, Q, B, T, n_buf, s);
    case 256: return launch_metric<256>(l1, schedule, warps, xp, qp, ap, arm_stride, bp, op, n, d_pad, Q, B, T, n_buf, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
