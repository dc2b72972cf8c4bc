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
//   order (segment_sort.cu): a stable sort of the live rows by id, over
//     only the bits the ids need, writes each live row's columns to its
//     slot in that order (coalesced writes) and each id's run [start,
//     end) of slots ([-1, -1) for an id without rows);
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
// Launches a call: the order's memset, histogram and passes (two for ids
// from 2,049 to 2^22), the fold and, past kLongRun rows, fold_long.  The
// long-run count stays on the card; no launch sets an attribute
// (bst_segment_init does, once a device).
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_fold.cuh"
#include "cp_async.cuh"
#include "segment_sort.cuh"

namespace {

constexpr int kMaxCols = 16;       // lanes an id, at most
constexpr int kLongRun = 256;      // longer runs fold in fold_long
constexpr int kLongThreads = 128;  // a fold_long block
constexpr int kStageFloats = 8192; // a stage's rows: 32 KB
constexpr int kStageSpan = kStageFloats + 4;  // its 16-byte aligned span
constexpr int kLongBlocks = 396;   // fold_long's grid at most: 3 an SM

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

constexpr int kLongSmem = 2 * kStageSpan * static_cast<int>(sizeof(float));

template <int C>
int launch_fold_long(const int* long_ids, const int* n_long, const int* start,
                     const int* end, const float* staged, const float* init,
                     float* out, int blocks, cudaStream_t stream) {
  segsum_fold_long_kernel<C><<<blocks, kLongThreads, kLongSmem, stream>>>(
      long_ids, n_long, start, end, staged, init, out);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int allow_fold_long() {
  return static_cast<int>(cudaFuncSetAttribute(
      segsum_fold_long_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kLongSmem));
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
constexpr int (*kAllowLong[kMaxCols])() = {
    allow_fold_long<1>,  allow_fold_long<2>,  allow_fold_long<3>,
    allow_fold_long<4>,  allow_fold_long<5>,  allow_fold_long<6>,
    allow_fold_long<7>,  allow_fold_long<8>,  allow_fold_long<9>,
    allow_fold_long<10>, allow_fold_long<11>, allow_fold_long<12>,
    allow_fold_long<13>, allow_fold_long<14>, allow_fold_long<15>,
    allow_fold_long<16>};

// The sums' part of the scratch, after the order's: runs, the long-run
// count, the listed runs and the staged rows (4 floats of slack: the
// long-run fold copies 16-byte aligned spans); offsets in bytes.
struct SumsLayout {
  size_t runs, n_long, long_ids, staged, total;
};

size_t align256(size_t n) { return (n + 255) & ~static_cast<size_t>(255); }

SumsLayout sums_layout(int m, int cols, int size) {
  SumsLayout L;
  size_t o = 0;
  L.runs = o;
  o += align256(2 * static_cast<size_t>(size) * sizeof(int));
  L.n_long = o;
  o += 256;
  L.long_ids = o;
  o += align256((static_cast<size_t>(m) / (kLongRun + 1) + 1) * sizeof(int));
  L.staged = o;
  o += align256((static_cast<size_t>(m) * cols + 4) * sizeof(float));
  L.total = o;
  return L;
}

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

// Once a device, before the first call: the long-run fold's and the
// order's passes' shared-memory limits.
int bst_segment_init() {
  for (int c = 0; c < kMaxCols; ++c) {
    const int err = kAllowLong[c]();
    if (err != cudaSuccess) return err;
  }
  return segsort::init();
}

// Bytes of scratch a call takes: the order's, and with cols >= 1 the
// sums' part (cols = 0: bst_segment_order's); 0 for a digit plan that
// does not cover the ids or widths outside 1..16.
size_t bst_segment_scratch(int m, int cols, int size, int passes,
                           int digit_bits) {
  const size_t order = segsort::scratch_bytes(m, size, passes, digit_bits);
  if (order == 0 || cols < 0 || cols > kMaxCols) return 0;
  return cols == 0 ? order : order + sums_layout(m, cols, size).total;
}

// idx: m ids, int64 where idx64 else int32; rows f32[m, cols]; init
// f32[size, cols] or null; out f32[size, cols]; scratch of
// bst_segment_scratch(m, cols, size, passes, digit_bits) bytes.
int bst_segment_sums(const void* idx, int idx64, const float* rows,
                     const float* init, int m, int cols, int size,
                     int passes, int digit_bits, void* scratch,
                     size_t scratch_size, float* out, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (m < 0 || size < 1 || cols < 1 || cols > kMaxCols)
    return cudaErrorInvalidValue;
  const size_t order = segsort::scratch_bytes(m, size, passes, digit_bits);
  const SumsLayout L = sums_layout(m, cols, size);
  if (order == 0 || scratch == nullptr || scratch_size < order + L.total)
    return cudaErrorInvalidValue;
  char* mine = static_cast<char*>(scratch) + order;
  int* runs = reinterpret_cast<int*>(mine + L.runs);
  int* n_long = reinterpret_cast<int*>(mine + L.n_long);
  int* long_ids = reinterpret_cast<int*>(mine + L.long_ids);
  float* staged = reinterpret_cast<float*>(mine + L.staged);
  int err = segsort::sort(idx, idx64 != 0, m, size, passes, digit_bits,
                          scratch, order, runs, rows, cols, staged, nullptr,
                          n_long, stream);
  if (err != cudaSuccess) return err;
  const int* start = runs;
  const int* end = runs + size;
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
