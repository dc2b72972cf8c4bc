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
// What bounds it on the H100: latency.  It reads 36 B a row (about 8 MB
// at the slice's 223k rows) and does 6 products a row; the serial
// row-order sums, which keep the result independent of scheduling, set
// the time.
//
// Design: the TPU kernel accumulated one-hot matmuls in a VMEM table
// carried across its sequential grid.  Hopper's blocks run in parallel,
// so the sums take the fixed order of csrc/compact_sweep.cu: block b owns
// rows [b*kPaymomRows, (b+1)*kPaymomRows) and sums them in row order
// into its own partial table (lanes 0-13 of one warp each own one
// column; a run of equal ids accumulates in a register), then a second
// kernel adds the partial tables in block order.  The plain version
// reproduces that order, so both agree bit for bit; the count column is
// exact.
//
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
// 128-id chunk, accumulated in VMEM across its sequential grid.  Hopper
// has direct reductions, so the design is paymom's fixed order: block b
// owns rows [b*kSegsumRows, (b+1)*kSegsumRows) and sums them in row order
// into its own partial table [bound, cols] (lane l of one warp owns the
// columns l, l+32, ...; a run of equal ids accumulates in a register),
// then a second kernel adds the partial tables in block order.  The plain
// version (ops/segsum.py block_order_sums) takes the same order, so the
// two agree bit for bit, and a count column is exact below 2^24.
//
// What bounds it on the H100: latency.  The raster's histogram reads 8 B a
// row (ids + a ones column, ~9.4 MB at 1.18M rows: ~2.8 us at 3.35 TB/s),
// but each block walks its 1024 rows one after another with one live lane
// when cols = 1, and the reduce walks ~1,150 partial tables serially.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPaymomRows = 1024;
constexpr int kCols = 16;  // 8 payload sums + 6 moments, padded

__global__ void paymom_partial_kernel(
    const int* __restrict__ ids, const float* __restrict__ payload,
    const float* __restrict__ q, int nq, float* __restrict__ partial, int n,
    int bound) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;  // one warp
  float* part = partial + static_cast<size_t>(b) * bound * kCols;
  for (int k = lane; k < bound * kCols; k += 32) part[k] = 0.f;
  __syncthreads();
  if (lane >= 14) return;
  const int r0 = b * kPaymomRows;
  const int r1 = min(r0 + kPaymomRows, n);
  int cur = -1;
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) {
    const int s = ids[r];
    if (s < 0 || s >= bound) continue;
    const float* a = payload + static_cast<size_t>(r) * 8;
    float v;
    if (lane < 8) {
      v = a[lane];
    } else {
      const bool hq = s < nq;
      const float dx = a[4] - (hq ? q[3 * s] : 0.f);
      const float dy = a[5] - (hq ? q[3 * s + 1] : 0.f);
      const float dz = a[6] - (hq ? q[3 * s + 2] : 0.f);
      switch (lane) {
        case 8: v = dx * dx; break;
        case 9: v = dy * dy; break;
        case 10: v = dz * dz; break;
        case 11: v = dx * dy; break;
        case 12: v = dx * dz; break;
        default: v = dy * dz; break;
      }
    }
    if (s != cur) {
      if (cur >= 0) part[cur * kCols + lane] = acc;
      cur = s;
      acc = part[s * kCols + lane];
    }
    acc += v;
  }
  if (cur >= 0) part[cur * kCols + lane] = acc;
}

__global__ void paymom_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ sums,
                                     float* __restrict__ moments, int nblk,
                                     int bound) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= bound * kCols) return;
  const int s = k / kCols, c = k % kCols;
  if (c >= 14) return;
  float a = 0.f;
  for (int b = 0; b < nblk; ++b)
    a += partial[static_cast<size_t>(b) * bound * kCols + k];
  if (c < 8)
    sums[s * 8 + c] = a;
  else
    moments[s * 6 + c - 8] = a;
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

constexpr int kSegsumRows = 1024;

__global__ void segsum_partial_kernel(const int* __restrict__ ids,
                                      const float* __restrict__ payload,
                                      int cols, float* __restrict__ partial,
                                      int n, int bound) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;  // one warp
  float* part = partial + static_cast<size_t>(b) * bound * cols;
  const int r0 = b * kSegsumRows;
  const int r1 = min(r0 + kSegsumRows, n);
  for (int c = lane; c < cols; c += 32) {
    // each lane zeroes and then owns its own columns: no other lane
    // touches them, so no barrier is needed
    for (int s = 0; s < bound; ++s) part[s * cols + c] = 0.f;
    int cur = -1;
    float acc = 0.f;
    for (int r = r0; r < r1; ++r) {
      const int s = ids[r];
      if (s < 0 || s >= bound) continue;
      const float v = payload[static_cast<size_t>(r) * cols + c];
      if (s != cur) {
        if (cur >= 0) part[cur * cols + c] = acc;
        cur = s;
        acc = part[s * cols + c];
      }
      acc += v;
    }
    if (cur >= 0) part[cur * cols + c] = acc;
  }
}

__global__ void segsum_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int nblk,
                                     int size) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= size) return;
  float a = 0.f;
  for (int b = 0; b < nblk; ++b) a += partial[static_cast<size_t>(b) * size + k];
  out[k] = a;
}

}  // namespace

extern "C" {

int bst_paymom(const int* ids, const float* payload, const float* q, int nq,
               float* partial, float* sums, float* moments, int n, int bound,
               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || bound < 0) return cudaErrorInvalidValue;
  if (bound == 0) return static_cast<int>(cudaGetLastError());
  const int nblk = (n + kPaymomRows - 1) / kPaymomRows;
  paymom_partial_kernel<<<nblk, 32, 0, stream>>>(ids, payload, q, nq,
                                                 partial, n, bound);
  const int total = bound * kCols;
  paymom_reduce_kernel<<<(total + 255) / 256, 256, 0, stream>>>(
      partial, sums, moments, nblk, bound);
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
// cols] scratch, nblk = ceil(n / kSegsumRows).
int bst_plane_sums(const int* ids, const float* payload, int cols,
                   float* partial, float* out, int n, int bound,
                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || bound <= 0 || cols <= 0 || cols > 128)
    return cudaErrorInvalidValue;
  const int nblk = (n + kSegsumRows - 1) / kSegsumRows;
  segsum_partial_kernel<<<nblk, 32, 0, stream>>>(ids, payload, cols, partial,
                                                 n, bound);
  const int size = bound * cols;
  segsum_reduce_kernel<<<(size + 255) / 256, 256, 0, stream>>>(partial, out,
                                                               nblk, size);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
