// segsum: the multigrid finalize's per-plane payload sums with second
// moments, its id -> rank table lookup, and the plain per-id sums of the
// raster's ground histogram.
//
// Replaces the TPU kernels buildingsegment_tpu/ops/segsum.py
// _paymom_kernel (wrapper plane_payload_moment_sums) and _lookup_kernel
// (wrapper table_lookup), both called from seg/coarse.py step 4, and
// _segsum_kernel (wrapper plane_sums), called from raster/ortho.py
// ground_threshold.  _segsum_t_kernel (plane_sums_t) computes the same
// function as _segsum_kernel in transposed layout.
//
// paymom: for every row with id s < bound (bound = ceil128(n_live), the
// TPU kernel's live 128-id chunks), sums[s] += [1, n^, p, |p|^2] and
// moments[s] += (xx, yy, zz, xy, xz, yz) of d = p - q[s], q the coarse
// plane centers.
//
// What bounds it on the H100: the ordered adds, not bytes.  It reads 36 B
// a live row (about 8 MB at the slice's 223k rows, ~2.4 us at 3.35 TB/s)
// and does 6 products a row; the row-order sums, which keep the result
// independent of scheduling and equal to the plain version's bit for bit,
// are f32 left folds that cannot be split: per block one chain as long as
// an id's rows there, then one chain over the blocks per (id, column).
//
// Design: the TPU kernel accumulated one-hot matmuls in a VMEM table
// carried across its sequential grid.  Hopper's blocks run in parallel,
// so the sums take a fixed order: block b owns rows
// [b*kPaymomRows, (b+1)*kPaymomRows) and sums each id's rows there in row
// order, then a second kernel adds the block partials in block order.
// The plain version (ops/segsum.py block_order_sums) takes the same
// order, so both agree bit for bit; the count column is exact.
//   partial: stage-then-fold (block_fold.cuh).  512 threads load the
//     block's ids, payload rows and q[id] coalesced and compute every
//     row's 14 columns (the 8 payload sums and the 6 products of
//     d = p - q[id]) into shared memory; the rows are sorted by id (row
//     order kept within an id) and one lane per (id, column) folds its
//     rows from shared memory.  Only the ids the block touches write a
//     partial row; a per-(block, id) flag marks them (cleared for the
//     rest), so an untouched row is never written or read;
//   reduce: one 512-thread block per id.  Each round every thread loads
//     one block's flag and, if set, its partial row into a shared stage,
//     loading the next round while 14 lanes fold the current one, column
//     by column in block order, a group of eight loaded ahead of the adds
//     (block_fold::fold_in_order).  An untouched block adds +0.f: a fold from
//     +0 never yields -0, so that keeps the bits the plain version's
//     zero partial gives.

// lookup: out[i] = lut[id_i] for 0 <= id_i < bound (bound =
// ceil128(n_live), capped at the table), else 0: one thread a row, a
// direct gather (the TPU kernel's one-hot matmul over the live chunks).
//
// lookup_cols (replaces _lookup_cols_kernel, wrapper table_lookup_cols,
// which nothing in either package calls): out[c, i] = lut[id_i, c] + 0
// for 0 <= id_i < bound, else 0, written column-major (f32[cols, n]),
// cols <= 8.  One thread an output element, consecutive threads on
// consecutive rows of one column, so the id reads and the writes are
// coalesced and only the table reads gather.  The TPU kernel's one-hot
// matmul adds exact zeros, so its result is the table value, except that
// its zero-initialised sum turns -0 into +0: the "+ 0" keeps that.  Bound
// by bytes: 4 B of id in and 4 * cols B out a row.
//
// plane_sums: acc[t, c] = sum of payload[i, c] over the rows with id_i = t,
// for t < bound (bound = ceil128(n_live), capped at the table), cols <= 128.
// The TPU kernel took a one-hot [128, tile] x [tile, cols] matmul per live
// 128-id chunk, accumulated in VMEM across its sequential grid.  The fixed
// order here is paymom's: block b sums each id's rows of
// [b*kSegsumRows, (b+1)*kSegsumRows) in row order from +0, then the block
// partials are added in block order from +0.  The plain version
// (ops/segsum.py block_order_sums) takes the same order, so the two agree
// bit for bit, and a count column is exact below 2^24.
//
// What bounds it on the H100: latency.  The raster's histogram (1.18M
// rows, cols = 1, about a dozen live ids) reads 8 B a row (~9.4 MB: ~2.8
// us at 3.35 TB/s); the fixed order leaves per block one add chain as
// long as an id's rows there (on a scan, a block's most frequent z bin
// holds about half its rows), then one chain over the ~1,150 blocks per
// (id, column); 1,152 blocks of 512 threads fill the SMs in about 2.2
// waves.
//
// Design: paymom's stage-then-fold.
//   partial: block_fold.cuh, NCOL columns staged a round: 2 (cols <= 2,
//     the histogram) or 16.  512 threads load the block's ids and
//     payload coalesced (a dead row's payload is not read), sort the
//     (id << 10 | row) keys (by counting where the live bound is at most
//     256, as the histogram's 128 is, else by the bitonic network),
//     number the runs, and fold each (run, column) from shared memory.
//     A wider payload folds its columns in chunks of 16 over the same
//     sorted keys, restaging each chunk: the loads of every add stay in
//     shared memory, where reading the payload from device memory in
//     sorted order would put one memory latency in each add of the
//     chain.  Only the ids the block touches write a partial row; a
//     per-(block, id) flag marks them;
//   reduce: one 512-thread block per (id, chunk of 16 columns).  Each
//     round every thread loads one block's flag and, if set, its partial
//     row into a shared stage, loading the next round while the lanes of
//     the columns fold the current one in block order, a group of eight
//     loaded ahead of the adds.  An untouched block adds +0.f, which
//     keeps the plain version's bits.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_fold.cuh"

namespace {

constexpr int kPaymomRows = block_fold::kRows;
constexpr int kCols = 16;     // partial row: 8 payload sums + 6 moments, padded
constexpr int kSumCols = 14;  // the columns summed
using PaymomSmem = block_fold::Smem<kSumCols>;

__global__ void __launch_bounds__(block_fold::kThreads, 2)
paymom_partial_kernel(const int* __restrict__ ids,
                      const float* __restrict__ payload,
                      const float* __restrict__ q, int nq,
                      float* __restrict__ partial,
                      uint8_t* __restrict__ touched, int n, int bound) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PaymomSmem& sm = *reinterpret_cast<PaymomSmem*>(smem_raw);
  const int b = blockIdx.x;
  uint8_t* tflag = touched + static_cast<size_t>(b) * bound;
  for (int s = threadIdx.x; s < bound; s += blockDim.x) tflag[s] = 0;
  const int base = b * kPaymomRows;
  for (int i = threadIdx.x; i < kPaymomRows; i += blockDim.x) {
    const int r = base + i;
    const int s = r < n ? ids[r] : -1;
    if (s < 0 || s >= bound) {
      sm.key[i] = block_fold::dead_key(i);
      continue;
    }
    sm.key[i] = block_fold::live_key(s, i);
    const float* a = payload + static_cast<size_t>(r) * 8;
    float* v = sm.val + i * PaymomSmem::kStride;
#pragma unroll
    for (int c = 0; c < 8; ++c) v[c] = a[c];
    const bool hq = s < nq;
    const float dx = v[4] - (hq ? q[3 * s] : 0.f);
    const float dy = v[5] - (hq ? q[3 * s + 1] : 0.f);
    const float dz = v[6] - (hq ? q[3 * s + 2] : 0.f);
    v[8] = dx * dx;
    v[9] = dy * dy;
    v[10] = dz * dz;
    v[11] = dx * dy;
    v[12] = dx * dz;
    v[13] = dy * dz;
  }
  __syncthreads();
  block_fold::sort_keys(sm.key);
  const int nrun = block_fold::find_runs(sm.key, sm.seg, sm.warp_sum);
  float* part = partial + static_cast<size_t>(b) * bound * kCols;
  block_fold::fold_runs(sm, nrun, [&](int s, int c, float acc) {
    part[s * kCols + c] = acc;
    if (c == 0) tflag[s] = 1;
  });
}

constexpr int kReduceThreads = 512;  // partial blocks staged a round
constexpr int kStageStride = kSumCols + 1;

__global__ void __launch_bounds__(kReduceThreads)
paymom_reduce_kernel(const float* __restrict__ partial,
                     const uint8_t* __restrict__ touched,
                     float* __restrict__ sums, float* __restrict__ moments,
                     int nblk, int bound, int accumulate) {
  __shared__ float stage[kReduceThreads * kStageStride];
  const int s = blockIdx.x;
  const int t = threadIdx.x;
  // thread t loads partial block b0 + t of the round
  auto load = [&](int b0, float* v) {
    const int b = b0 + t;
#pragma unroll
    for (int c = 0; c < kSumCols; ++c) v[c] = 0.f;
    if (b < nblk && touched[static_cast<size_t>(b) * bound + s]) {
      // partial rows are 64 B and the table 16 B aligned
      const float4* p = reinterpret_cast<const float4*>(
          partial + (static_cast<size_t>(b) * bound + s) * kCols);
      const float4 a0 = p[0], a1 = p[1], a2 = p[2], a3 = p[3];
      v[0] = a0.x; v[1] = a0.y; v[2] = a0.z; v[3] = a0.w;
      v[4] = a1.x; v[5] = a1.y; v[6] = a1.z; v[7] = a1.w;
      v[8] = a2.x; v[9] = a2.y; v[10] = a2.z; v[11] = a2.w;
      v[12] = a3.x; v[13] = a3.y;
    }
  };
  float v[kSumCols];
  load(0, v);
  // thread t < kSumCols: column t, from +0 or (accumulate) from the row
  // already in the table: a shard continuing the shards before it
  float acc = 0.f;
  if (accumulate) {
    if (t < 8)
      acc = sums[s * 8 + t];
    else if (t < kSumCols)
      acc = moments[s * 6 + t - 8];
  }
  for (int b0 = 0; b0 < nblk; b0 += kReduceThreads) {
#pragma unroll
    for (int c = 0; c < kSumCols; ++c) stage[t * kStageStride + c] = v[c];
    __syncthreads();
    if (b0 + kReduceThreads < nblk) load(b0 + kReduceThreads, v);
    if (t < kSumCols) {
      acc = block_fold::fold_in_order(
          0, min(kReduceThreads, nblk - b0), acc,
          [&](int j) { return stage[j * kStageStride + t]; });
    }
    __syncthreads();
  }
  if (t < 8)
    sums[s * 8 + t] = acc;
  else if (t < kSumCols)
    moments[s * 6 + t - 8] = acc;
}

__global__ void lookup_kernel(const int* __restrict__ ids,
                              const int* __restrict__ lut, int bound,
                              int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  out[i] = (id >= 0 && id < bound) ? lut[id] : 0;
}

__global__ void lookup_cols_kernel(const int* __restrict__ ids,
                                   const float* __restrict__ lut, int cols,
                                   int bound, float* __restrict__ out,
                                   int n) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;  // k = c * n + i
  if (k >= cols * n) return;
  const int c = k / n;
  const int id = ids[k - c * n];
  out[k] = (id >= 0 && id < bound) ? lut[id * cols + c] + 0.f : 0.f;
}

constexpr int kSegsumRows = block_fold::kRows;
constexpr int kSegsumChunk = 16;  // columns a reduce block folds

// The partial tables of block b: NCOL payload columns staged a round.
template <int NCOL>
__global__ void __launch_bounds__(block_fold::kThreads, NCOL <= 2 ? 4 : 2)
segsum_partial_kernel(const int* __restrict__ ids,
                      const float* __restrict__ payload, int cols,
                      float* __restrict__ partial,
                      uint8_t* __restrict__ touched, int n, int bound) {
  using Smem = block_fold::Smem<NCOL>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.x;
  uint8_t* tflag = touched + static_cast<size_t>(b) * bound;
  for (int s = threadIdx.x; s < bound; s += blockDim.x) tflag[s] = 0;
  const int base = b * kSegsumRows;
  constexpr int kPer = block_fold::kRows / block_fold::kThreads;
  bool live[kPer];
  // columns [c0, c0 + NCOL) of this thread's live rows, 0 past cols
  auto stage = [&](int c0) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (!live[j]) continue;
      const int i = threadIdx.x + j * block_fold::kThreads;
      const float* a = payload + static_cast<size_t>(base + i) * cols + c0;
      float* v = sm.val + i * Smem::kStride;
#pragma unroll
      for (int c = 0; c < NCOL; ++c) v[c] = c0 + c < cols ? a[c] : 0.f;
    }
  };
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = threadIdx.x + j * block_fold::kThreads;
    const int r = base + i;
    const int s = r < n ? ids[r] : -1;
    live[j] = s >= 0 && s < bound;
    sm.key[i] = live[j] ? block_fold::live_key(s, i) : block_fold::dead_key(i);
  }
  stage(0);
  __syncthreads();
  if (bound <= block_fold::kBucketBound) {
    int* cnt = reinterpret_cast<int*>(smem_raw + sizeof(Smem));
    block_fold::bucket_sort_keys(sm.key, cnt, bound + 1, sm.warp_sum);
  } else {
    block_fold::sort_keys(sm.key);
  }
  const int nrun = block_fold::find_runs(sm.key, sm.seg, sm.warp_sum);
  float* part = partial + static_cast<size_t>(b) * bound * cols;
  for (int c0 = 0;;) {
    block_fold::fold_runs(sm, nrun, [&](int s, int c, float acc) {
      if (c0 + c < cols) part[s * cols + c0 + c] = acc;
      if (c0 + c == 0) tflag[s] = 1;
    });
    c0 += NCOL;
    if (c0 >= cols) break;
    __syncthreads();  // the chunk's folds have read their values
    stage(c0);
    __syncthreads();
  }
}

constexpr int kSegsumStageStride = kSegsumChunk + 1;

// out[s, c0 + c] for one id s (blockIdx.x) and one chunk of up to 16
// columns (blockIdx.y): the flagged partial rows added in block order.
__global__ void __launch_bounds__(kReduceThreads)
segsum_reduce_kernel(const float* __restrict__ partial,
                     const uint8_t* __restrict__ touched,
                     float* __restrict__ out, int nblk, int bound,
                     int cols) {
  __shared__ float stage[kReduceThreads * kSegsumStageStride];
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * kSegsumChunk;
  const int nc = min(kSegsumChunk, cols - c0);
  const int t = threadIdx.x;
  // thread t loads partial block b0 + t of the round
  auto load = [&](int b0, float* v) {
    const int b = b0 + t;
    const bool on = b < nblk && touched[static_cast<size_t>(b) * bound + s];
    const float* p = partial + (static_cast<size_t>(b) * bound + s) * cols + c0;
#pragma unroll
    for (int c = 0; c < kSegsumChunk; ++c) v[c] = on && c < nc ? p[c] : 0.f;
  };
  float v[kSegsumChunk];
  load(0, v);
  float acc = 0.f;  // thread t < nc: column c0 + t
  for (int b0 = 0; b0 < nblk; b0 += kReduceThreads) {
#pragma unroll
    for (int c = 0; c < kSegsumChunk; ++c)
      stage[t * kSegsumStageStride + c] = v[c];
    __syncthreads();
    if (b0 + kReduceThreads < nblk) load(b0 + kReduceThreads, v);
    if (t < nc) {
      acc = block_fold::fold_in_order(
          0, min(kReduceThreads, nblk - b0), acc,
          [&](int j) { return stage[j * kSegsumStageStride + t]; });
    }
    __syncthreads();
  }
  if (t < nc) out[s * cols + c0 + t] = acc;
}

template <int NCOL>
int launch_segsum_partial(const int* ids, const float* payload, int cols,
                          float* partial, uint8_t* touched, int n, int bound,
                          int nblk, cudaStream_t stream) {
  // the bucket sort's counts after the staged rows
  const int smem = sizeof(block_fold::Smem<NCOL>) +
                   (bound <= block_fold::kBucketBound
                        ? block_fold::bucket_ints(bound + 1) * 4
                        : 0);
  cudaFuncSetAttribute(segsum_partial_kernel<NCOL>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  segsum_partial_kernel<NCOL><<<nblk, block_fold::kThreads, smem, stream>>>(
      ids, payload, cols, partial, touched, n, bound);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// partial: f32[nblk, bound, 16], touched: u8[nblk, bound] scratch, nblk =
// ceil(n / kPaymomRows); sums f32[>= bound, 8] and moments f32[>= bound, 6]
// get rows < bound: the block tables' sum, added onto the rows already
// there when accumulate is nonzero.
int bst_paymom(const int* ids, const float* payload, const float* q, int nq,
               float* partial, uint8_t* touched, float* sums, float* moments,
               int n, int bound, int accumulate, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || bound < 0 || bound >= block_fold::kNoId)
    return cudaErrorInvalidValue;
  if (bound == 0) return static_cast<int>(cudaGetLastError());
  const int nblk = (n + kPaymomRows - 1) / kPaymomRows;
  const int smem = sizeof(PaymomSmem);
  cudaFuncSetAttribute(paymom_partial_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  paymom_partial_kernel<<<nblk, block_fold::kThreads, smem, stream>>>(
      ids, payload, q, nq, partial, touched, n, bound);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  paymom_reduce_kernel<<<bound, kReduceThreads, 0, stream>>>(
      partial, touched, sums, moments, nblk, bound, accumulate);
  return static_cast<int>(cudaGetLastError());
}

int bst_lookup(const int* ids, const int* lut, int bound, int* out, int n,
               void* stream) {
  if (n <= 0 || bound < 0) return cudaErrorInvalidValue;
  const int threads = 256;
  lookup_kernel<<<(n + threads - 1) / threads, threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(ids, lut, bound, out,
                                                        n);
  return static_cast<int>(cudaGetLastError());
}

int bst_lookup_cols(const int* ids, const float* lut, int cols, int bound,
                    float* out, int n, void* stream) {
  if (n <= 0 || bound < 0 || cols < 1 || cols > 8)
    return cudaErrorInvalidValue;
  const int threads = 256;
  const int total = cols * n;
  lookup_cols_kernel<<<(total + threads - 1) / threads, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(ids, lut, cols,
                                                            bound, out, n);
  return static_cast<int>(cudaGetLastError());
}

// out: f32[>= bound, cols], rows < bound written; partial: f32[nblk, bound,
// cols] and touched: u8[nblk, bound] scratch, nblk = ceil(n / kSegsumRows).
int bst_plane_sums(const int* ids, const float* payload, int cols,
                   float* partial, uint8_t* touched, float* out, int n,
                   int bound, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || bound <= 0 || bound >= block_fold::kNoId || cols <= 0 ||
      cols > 128)
    return cudaErrorInvalidValue;
  const int nblk = (n + kSegsumRows - 1) / kSegsumRows;
  const int err =
      cols <= 2 ? launch_segsum_partial<2>(ids, payload, cols, partial,
                                           touched, n, bound, nblk, stream)
                : launch_segsum_partial<kSegsumChunk>(
                      ids, payload, cols, partial, touched, n, bound, nblk,
                      stream);
  if (err != cudaSuccess) return err;
  const dim3 grid(bound, (cols + kSegsumChunk - 1) / kSegsumChunk);
  segsum_reduce_kernel<<<grid, kReduceThreads, 0, stream>>>(
      partial, touched, out, nblk, bound, cols);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
