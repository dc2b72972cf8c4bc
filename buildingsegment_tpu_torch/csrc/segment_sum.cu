// segment_sum: the fixed-order per-id sums of the port's graph solve, its
// window label sums and its multigrid finalize.
//
// Replaces no TPU kernel: it stands in for the JAX package's XLA
// scatter-adds (buildingsegment_tpu/seg/region_grow.py:453, :511, :572,
// :845, :1279; seg/coarse.py's merge and flatness sums), which the port
// first computed with PyTorch's accumulating index_put_.  Called from
// ops/segsum.py segment_sums.
//
// Function: for ids 0 <= id < size,
//   out[id, c] = (((+0 + init[id, c]) + rows[r0, c]) + rows[r1, c]) + ...
// over r0 < r1 < ... the rows with idx == id, strictly in row order (no
// init: the fold starts from +0); an id with no rows gets +0 + init[id]
// (or +0).  Rows whose id lies outside [0, size) add nothing and their
// runs are never walked.  The plain
// version (ops/segsum.py segment_sums_reference) adds in this order, so
// the two agree bit for bit.  Ids may reach size - 1 for any size below
// 2^31: the ids are never packed into a sort key with the row.
//
// What bounds it on the H100: the order.  An f32 left fold cannot be
// split without changing bits, so the longest live run is one dependent
// add chain (~4 cycles an add); the bytes (each live row read once, the
// [size, C] table written once) take a few microseconds at the slice.
// PyTorch's accumulate kernel walked each run with one dependent global
// load an add, and walked the dump id of every unlabeled row too.
//
// Design: the parallelism comes from around the chains.
//   keys: key[i] = idx[i] where 0 <= idx[i] < size, else size; the
//     wrapper orders the keys stably (torch.sort, stable), which lists
//     each id's rows contiguously and in row order, the dead rows last;
//   gather: one thread an element copies the live rows into sorted order
//     (coalesced writes), and each run's first and last element record
//     the run's bounds [start[id], end[id]) (zeroed beforehand: an id
//     with no rows keeps an empty run);
//   fold: G lanes an id (G the power of two >= C: 16 ids a warp at
//     C = 1, two at C = 16), lane c folds column c over the run's
//     contiguous rows, its loads issued eight ahead of the adds
//     (block_fold::fold_in_order).  A run longer than kLongRun is
//     listed for
//   fold_long: one 128-thread block a listed run; warps 1-3 copy the run
//     in 32 KB stages into shared memory with 16-byte cp.async, the next
//     stage in flight while the C lanes of warp 0 fold the current one
//     from shared memory, 16 loads ahead of the adds, at a stride fixed
//     at compile time (one instantiation a width), so the add chain
//     waits on no global load and issues little besides its adds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_fold.cuh"
#include "cp_async.cuh"

namespace {

constexpr int kMaxCols = 16;       // lanes an id, at most
constexpr int kLongRun = 256;      // longer runs fold in fold_long
constexpr int kLongThreads = 128;  // a fold_long block
constexpr int kStageFloats = 8192; // a stage's rows: 32 KB
constexpr int kStageSpan = kStageFloats + 4;  // its 16-byte aligned span
constexpr int kLongBlocks = 396;   // fold_long's grid at most: 3 an SM

__global__ void segsum_keys_kernel(const int64_t* __restrict__ idx, int m,
                                   int size, int* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int64_t v = idx[i];
  key[i] = (v >= 0 && v < size) ? static_cast<int>(v) : size;
}

__global__ void segsum_gather_kernel(const int* __restrict__ key,
                                     const int64_t* __restrict__ perm,
                                     const float* __restrict__ rows,
                                     int cols, int m, int size,
                                     float* __restrict__ staged,
                                     int* __restrict__ start,
                                     int* __restrict__ end) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(m) * cols) return;
  const int j = static_cast<int>(e / cols);
  const int c = static_cast<int>(e - static_cast<int64_t>(j) * cols);
  const int k = key[j];
  if (k >= size) return;  // a dead row (they sort last)
  staged[e] = rows[perm[j] * cols + c];
  if (c == 0) {
    if (j == 0 || key[j - 1] != k) start[k] = j;
    if (j == m - 1 || key[j + 1] != k) end[k] = j + 1;
  }
}

// G lanes an id s < size: lane c < cols folds column c of the run, or
// lists the run for fold_long when it is longer than kLongRun.
template <int G>
__global__ void segsum_fold_kernel(const int* __restrict__ start,
                                   const int* __restrict__ end,
                                   const float* __restrict__ staged,
                                   const float* __restrict__ init,
                                   float* __restrict__ out, int size,
                                   int cols,
                                   int* __restrict__ long_ids,
                                   int* __restrict__ n_long) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (t / G >= size) return;
  const int s = static_cast<int>(t / G);
  const int c = static_cast<int>(t & (G - 1));
  const int p0 = start[s], p1 = end[s];
  if (p1 - p0 > kLongRun) {
    if (c == 0) long_ids[atomicAdd(n_long, 1)] = s;
    return;
  }
  if (c >= cols) return;
  const size_t o = static_cast<size_t>(s) * cols + c;
  float acc = 0.f;
  if (init != nullptr) acc = acc + init[o];  // +0 + init: -0 reads +0
  acc = block_fold::fold_in_order(p0, p1, acc, [&](int p) {
    return staged[static_cast<size_t>(p) * cols + c];
  });
  out[o] = acc;
}

// acc + q[0] + q[C] + ... + q[(nr - 1) * C], added left to right; two
// register groups of 16 rows take turns, so the loads of each group are
// issued before the adds of the group before it, and the stride is a
// compile-time constant (the loads carry immediate offsets).
template <int C>
__device__ __forceinline__ float fold_column(const float* q, int nr,
                                             float acc) {
  int r = 0;
  if (nr >= 16) {
    float a[16], b[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) a[u] = q[u * C];
    for (r = 16; r + 32 <= nr; r += 32) {  // a: rows [r - 16, r)
#pragma unroll
      for (int u = 0; u < 16; ++u) b[u] = q[(r + u) * C];
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += a[u];
#pragma unroll
      for (int u = 0; u < 16; ++u) a[u] = q[(r + 16 + u) * C];
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += b[u];
    }
    if (r + 16 <= nr) {
#pragma unroll
      for (int u = 0; u < 16; ++u) b[u] = q[(r + u) * C];
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += a[u];
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += b[u];
      r += 16;
    } else {
#pragma unroll
      for (int u = 0; u < 16; ++u) acc += a[u];
    }
  }
  for (; r < nr; ++r) acc += q[r * C];
  return acc;
}

// One block a listed run, the runs taken in grid strides.  Warp 0 folds
// (lane c column c); warps 1-3 copy stage k + 1 with 16-byte cp.async
// while it folds stage k.  A stage is the 16-byte aligned span around
// its rows' floats; the fold starts at the rows' offset in it (the
// staged array holds 4 floats of slack past its rows for the last span).
template <int C>
__global__ void __launch_bounds__(kLongThreads)
segsum_fold_long_kernel(const int* __restrict__ long_ids,
                        const int* __restrict__ n_long,
                        const int* __restrict__ start,
                        const int* __restrict__ end,
                        const float* __restrict__ staged,
                        const float* __restrict__ init,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float stage[];  // 2 x kStageSpan floats
  // rows a stage: a multiple of 4, so every stage's span starts 16-byte
  // aligned where the first does
  constexpr int kPer = kStageFloats / C / 4 * 4;
  const int t = threadIdx.x;
  const int nl = *n_long;
  for (int item = blockIdx.x; item < nl; item += gridDim.x) {
    const int s = long_ids[item];
    const int p0 = start[s], p1 = end[s];
    const int nstage = (p1 - p0 + kPer - 1) / kPer;
    // stage k: rows [p0 + k * kPer, min(p0 + (k + 1) * kPer, p1)), its
    // floats [f0, f1) copied from f0 rounded down to 4 into buffer k & 1
    const int64_t f_first = static_cast<int64_t>(p0) * C;
    const int off = static_cast<int>(f_first & 3);
    auto issue = [&](int k) {
      const int64_t f0 = f_first + static_cast<int64_t>(k) * kPer * C;
      const int64_t f_end = static_cast<int64_t>(p1) * C;
      const int64_t f1 = f0 + kPer * C < f_end ? f0 + kPer * C : f_end;
      const float* src = staged + (f0 - off);
      float* dst = stage + (k & 1) * kStageSpan;
      const int chunks = static_cast<int>((f1 - f0 + off + 3) >> 2);
      for (int j = t - 32; j < chunks; j += kLongThreads - 32)
        cp_async::copy16(dst + 4 * j, src + 4 * j);
      cp_async::commit();
    };
    float acc = 0.f;
    if (t < C && init != nullptr)
      acc = acc + init[static_cast<size_t>(s) * C + t];
    if (t >= 32) issue(0);
    for (int k = 0; k < nstage; ++k) {
      if (t >= 32) {
        if (k + 1 < nstage) {
          issue(k + 1);  // its buffer's last reader passed the barrier below
          cp_async::wait<1>();
        } else {
          cp_async::wait<0>();
        }
      }
      __syncthreads();
      if (t < C)
        acc = fold_column<C>(stage + (k & 1) * kStageSpan + off + t,
                             min(kPer, p1 - p0 - k * kPer), acc);
      __syncthreads();
    }
    if (t < C) out[static_cast<size_t>(s) * C + t] = acc;
  }
}

template <int C>
int launch_fold_long(const int* long_ids, const int* n_long, const int* start,
                     const int* end, const float* staged, const float* init,
                     float* out, int blocks, cudaStream_t stream) {
  const int smem = 2 * kStageSpan * static_cast<int>(sizeof(float));
  cudaFuncSetAttribute(segsum_fold_long_kernel<C>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  segsum_fold_long_kernel<C><<<blocks, kLongThreads, smem, stream>>>(
      long_ids, n_long, start, end, staged, init, out);
  return static_cast<int>(cudaGetLastError());
}

using LongLaunch = int (*)(const int*, const int*, const int*, const int*,
                           const float*, const float*, float*, int,
                           cudaStream_t);
constexpr LongLaunch kLongLaunch[kMaxCols] = {
    launch_fold_long<1>,  launch_fold_long<2>,  launch_fold_long<3>,
    launch_fold_long<4>,  launch_fold_long<5>,  launch_fold_long<6>,
    launch_fold_long<7>,  launch_fold_long<8>,  launch_fold_long<9>,
    launch_fold_long<10>, launch_fold_long<11>, launch_fold_long<12>,
    launch_fold_long<13>, launch_fold_long<14>, launch_fold_long<15>,
    launch_fold_long<16>};

template <int G>
int launch_fold(const int* start, const int* end, const float* staged,
                const float* init, float* out, int size, int cols,
                int* long_ids, int* n_long, cudaStream_t stream) {
  const int threads = 256;
  const int64_t total = static_cast<int64_t>(size) * G;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) /
                                                threads);
  segsum_fold_kernel<G><<<blocks, threads, 0, stream>>>(
      start, end, staged, init, out, size, cols, long_ids, n_long);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// idx: i64[m]; key: i32[m] scratch, the live ids (dead rows: size) for
// the sort.
int bst_segment_keys(const int64_t* idx, int m, int size, int* key,
                     void* stream_ptr) {
  if (m < 0 || size < 1) return cudaErrorInvalidValue;
  if (m == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  segsum_keys_kernel<<<static_cast<unsigned>(
                           (static_cast<int64_t>(m) + threads - 1) / threads),
                       threads, 0,
                       static_cast<cudaStream_t>(stream_ptr)>>>(
      idx, m, size, key);
  return static_cast<int>(cudaGetLastError());
}

// skey / perm: the keys sorted stably and their rows; rows f32[m, cols];
// staged f32[m * cols + 4] scratch; runs i32[2 * size + 1] zeroed (start,
// end, then the count of long runs); long_ids i32[m / (kLongRun + 1) + 1]
// scratch; init f32[size, cols] or null; out f32[size, cols].
int bst_segment_sums(const int* skey, const int64_t* perm, const float* rows,
                     const float* init, int m, int cols, int size,
                     float* staged, int* runs, int* long_ids, float* out,
                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m < 0 || size < 1 || cols < 1 || cols > kMaxCols)
    return cudaErrorInvalidValue;
  int* start = runs;
  int* end = runs + size;
  int* n_long = runs + 2 * static_cast<size_t>(size);
  const int threads = 256;
  if (m > 0) {
    const int64_t total = static_cast<int64_t>(m) * cols;
    segsum_gather_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                 threads),
                           threads, 0, stream>>>(skey, perm, rows, cols, m,
                                                 size, staged, start, end);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int err;
  if (cols == 1)
    err = launch_fold<1>(start, end, staged, init, out, size, cols,
                         long_ids, n_long, stream);
  else if (cols == 2)
    err = launch_fold<2>(start, end, staged, init, out, size, cols,
                         long_ids, n_long, stream);
  else if (cols <= 4)
    err = launch_fold<4>(start, end, staged, init, out, size, cols,
                         long_ids, n_long, stream);
  else if (cols <= 8)
    err = launch_fold<8>(start, end, staged, init, out, size, cols,
                         long_ids, n_long, stream);
  else
    err = launch_fold<16>(start, end, staged, init, out, size, cols,
                          long_ids, n_long, stream);
  if (err != cudaSuccess || m <= kLongRun) return err;
  return kLongLaunch[cols - 1](long_ids, n_long, start, end, staged, init,
                               out, min(m / (kLongRun + 1) + 1, kLongBlocks),
                               stream);
}

}  // extern "C"
