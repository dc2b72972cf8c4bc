// adopt: the multigrid finalize's hole adoption against the top 128
// merged planes.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/adopt.py _adopt_kernel
// (wrapper plane_adopt, called from seg/coarse.py step 4); its opt-in
// twin _adopt_kernel_t computes the same function transposed.
//
// Per hole row i (valid, unlabeled), with payload [1, n^, p, |p|^2], and
// per plane lane l (unit normal n_l, center c_l, offset b_l = n_l·c_l,
// h_l = |c_l|^2 / 2, squared reach r2_l, lane_ok_l):
//   off = p·n_l - b_l,  cos = n^·n_l,  pc2 = p·c_l - h_l,
//   ok  = |off| <= th and |cos| >= cos_th and (|p|^2 - 2 pc2) - off^2 <= r2_l
//         and lane_ok_l;
// the row adopts the first lane of least |off| among the ok lanes, takes
// that lane's merged-root row, and its payload is summed per lane.
//
// What bounds it on the H100: bytes.  Every row reads its hole flag and
// writes 5 B (about 1.3 MB at the slice's 223k rows); only hole rows read
// their 32 B payload and test the live planes (about 24 flops a plane).
// Morton order leaves the holes clustered, so most blocks hold none.
//
// Design: the TPU kernel did the three dot products as one [T,8]x[8,384]
// matmul and the selection on [T,128] vectors.  Here one thread owns one
// row and loops over the 128 lanes of a table held in shared memory,
// keeping the running least |off| (strict <, so the first lane wins a
// tie).  The per-lane sums keep a fixed order (ops/segsum.py
// block_order_sums): block b (kAdoptRows rows) sums each lane's adopted
// rows in row order from +0, and the block partials are added in block
// order from +0.  No add waits on a global load, and no block or lane
// without an adopted row costs a partial:
//   adopt: a block without holes writes its rows' outputs and a cleared
//     block flag, nothing else.  Otherwise every adopted row stages its
//     payload (read once, as two float4s, for the lane search) into a
//     shared array compacted in row order (a ballot scan), noting the
//     first and last staged row of its lane; one thread per (lane,
//     column) folds that span from shared memory, adding +0 for the rows
//     of other lanes.  Only the lanes the block touched write a partial
//     row, flagged per (block, lane); a block that adopted nothing clears
//     its block flag only.
//   reduce: one block per lane.  Each round its 1024 threads read the
//     flags of 1024 blocks (the lane flag only where the block flag is
//     set), compact the touched blocks' partial rows in block order into
//     shared memory, prefetch the next round, and eight threads fold the
//     round's rows, column by column.
// A fold from +0 never yields -0, so adding +0 for another lane's row,
// or skipping an untouched block, keeps every bit of the plain version's
// zero partials.  The plain version computes each dot product in the
// same order, built here with -fmad=false, and sums in the same order:
// both agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kK = 128;
constexpr int kAdoptRows = 256;
// table rows: n_x n_y n_z b c_x c_y c_z h r2 lane_ok
constexpr int kTabRows = 10;
constexpr int kCols = 8;              // payload columns
constexpr int kStride = kCols + 1;    // staged row stride (odd: no conflicts)
constexpr int kWarps = kAdoptRows / 32;

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

__global__ void __launch_bounds__(kAdoptRows)
adopt_kernel(const float* __restrict__ payload,
             const uint8_t* __restrict__ holes,
             const float* __restrict__ table, const int* __restrict__ rowlut,
             uint8_t* __restrict__ adopted, int* __restrict__ row_out,
             float* __restrict__ partial, uint8_t* __restrict__ bflag,
             uint8_t* __restrict__ lflag, int n, float th, float cth,
             int sgn) {
  __shared__ float st[kTabRows * kK];
  __shared__ float val[kAdoptRows * kStride];  // staged rows, row order
  __shared__ int vlane[kAdoptRows];
  __shared__ int first[kK], last[kK];  // each lane's staged span
  __shared__ int wsum[kWarps];
  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const int i = b * kAdoptRows + t;
  const bool hole = i < n && holes[i];
  if (!__syncthreads_or(hole)) {
    if (i < n) {
      adopted[i] = 0;
      row_out[i] = 0;
    }
    if (t == 0) bflag[b] = 0;
    return;
  }
  for (int k = t; k < kTabRows * kK; k += kAdoptRows) st[k] = table[k];
  if (t < kK) {
    first[t] = kAdoptRows;
    last[t] = -1;
  }
  __syncthreads();
  int lane = -1;
  float a[kCols];
  if (hole) {
    // payload rows are 32 B and the tensor 16 B aligned
    const float4* a4 =
        reinterpret_cast<const float4*>(payload + static_cast<size_t>(i) * 8);
    const float4 lo = a4[0], hi = a4[1];
    a[0] = lo.x; a[1] = lo.y; a[2] = lo.z; a[3] = lo.w;
    a[4] = hi.x; a[5] = hi.y; a[6] = hi.z; a[7] = hi.w;
    const float ux = a[1], uy = a[2], uz = a[3];
    const float x = a[4], y = a[5], z = a[6], sq = a[7];
    float best = 0.f;
    for (int l = 0; l < kK; ++l) {
      if (!(st[9 * kK + l] > 0.f)) continue;
      const float mx = st[l], my = st[kK + l], mz = st[2 * kK + l];
      const float off = x * mx + y * my + z * mz - st[3 * kK + l];
      const float aoff = fabsf(off);
      if (!(aoff <= th) || (lane >= 0 && !(aoff < best))) continue;
      const float c = ux * mx + uy * my + uz * mz;
      if (!((sgn ? c : fabsf(c)) >= cth)) continue;
      const float pc2 = x * st[4 * kK + l] + y * st[5 * kK + l] +
                        z * st[6 * kK + l] - st[7 * kK + l];
      if (!((sq - 2.f * pc2) - off * off <= st[8 * kK + l])) continue;
      best = aoff;
      lane = l;
    }
  }
  if (i < n) {
    adopted[i] = lane >= 0;
    row_out[i] = lane >= 0 ? rowlut[lane] : 0;
  }

  // stage the adopted rows, compacted in row order
  const bool got = lane >= 0;
  const unsigned bal = __ballot_sync(0xffffffffu, got);
  if ((t & 31) == 0) wsum[t >> 5] = __popc(bal);
  __syncthreads();
  int before = 0, total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int c = wsum[k];
    before += k < (t >> 5) ? c : 0;
    total += c;
  }
  if (total == 0) {  // holes, none adopted: no partial
    if (t == 0) bflag[b] = 0;
    return;
  }
  if (got) {
    const int p = before + __popc(bal & lanes_below());
#pragma unroll
    for (int c = 0; c < kCols; ++c) val[p * kStride + c] = a[c];
    vlane[p] = lane;
    atomicMin(&first[lane], p);
    atomicMax(&last[lane], p);
  }
  __syncthreads();
  if (t < kK) lflag[static_cast<size_t>(b) * kK + t] = last[t] >= 0;
  if (t == 0) bflag[b] = 1;

  // one thread per (lane, column): the lane's span, in row order, from +0
  float* part = partial + static_cast<size_t>(b) * kK * kCols;
  const int col = t & (kCols - 1);
  for (int l = t / kCols; l < kK; l += kAdoptRows / kCols) {
    const int p0 = first[l], p1 = last[l] + 1;
    if (p1 == 0) continue;
    float acc = 0.f;
    int p = p0;
    for (; p + 8 <= p1; p += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = vlane[p + u] == l ? val[(p + u) * kStride + col] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; p < p1; ++p) acc += vlane[p] == l ? val[p * kStride + col] : 0.f;
    part[l * kCols + col] = acc;
  }
}

constexpr int kReduceThreads = 1024;  // blocks staged a round
constexpr int kReduceWarps = kReduceThreads / 32;

__global__ void __launch_bounds__(kReduceThreads)
adopt_reduce_kernel(const float* __restrict__ partial,
                    const uint8_t* __restrict__ bflag,
                    const uint8_t* __restrict__ lflag,
                    float* __restrict__ acc128, int nblk, int accumulate) {
  __shared__ float stage[kReduceThreads * kStride];
  __shared__ int wsum[kReduceWarps];
  const int l = blockIdx.x;
  const int t = threadIdx.x;
  // thread t reads block b0 + t's flags and, if it touched lane l, its
  // partial row
  auto load = [&](int b0, float* v) {
    const int b = b0 + t;
    if (!(b < nblk && bflag[b] && lflag[static_cast<size_t>(b) * kK + l]))
      return false;
    const float4* p = reinterpret_cast<const float4*>(
        partial + (static_cast<size_t>(b) * kK + l) * kCols);
    const float4 lo = p[0], hi = p[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
    return true;
  };
  float v[kCols];
  bool touched = load(0, v);
  // thread t < kCols: column t, from +0 or (accumulate) from the lane's
  // row already in acc128: a shard continuing the shards before it
  float acc = accumulate && t < kCols ? acc128[l * kCols + t] : 0.f;
  for (int b0 = 0; b0 < nblk; b0 += kReduceThreads) {
    const unsigned bal = __ballot_sync(0xffffffffu, touched);
    if ((t & 31) == 0) wsum[t >> 5] = __popc(bal);
    __syncthreads();
    int before = 0, total = 0;
    for (int k = 0; k < kReduceWarps; ++k) {
      const int c = wsum[k];
      before += k < (t >> 5) ? c : 0;
      total += c;
    }
    if (touched) {
      const int p = before + __popc(bal & lanes_below());
#pragma unroll
      for (int c = 0; c < kCols; ++c) stage[p * kStride + c] = v[c];
    }
    __syncthreads();
    touched = b0 + kReduceThreads < nblk && load(b0 + kReduceThreads, v);
    if (t < kCols) {
      int j = 0;
      for (; j + 8 <= total; j += 8) {
        float u[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) u[k] = stage[(j + k) * kStride + t];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc += u[k];
      }
      for (; j < total; ++j) acc += stage[j * kStride + t];
    }
    __syncthreads();
  }
  if (t < kCols) acc128[l * kCols + t] = acc;
}

}  // namespace

extern "C" int bst_adopt(const float* payload, const uint8_t* holes,
                         const float* table, const int* rowlut,
                         uint8_t* adopted, int* row_out, float* partial,
                         uint8_t* bflag, uint8_t* lflag, float* acc128, int n,
                         float th, float cth, int sgn, int accumulate,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return cudaErrorInvalidValue;
  const int nblk = (n + kAdoptRows - 1) / kAdoptRows;
  adopt_kernel<<<nblk, kAdoptRows, 0, stream>>>(
      payload, holes, table, rowlut, adopted, row_out, partial, bflag, lflag,
      n, th, cth, sgn);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  adopt_reduce_kernel<<<kK, kReduceThreads, 0, stream>>>(
      partial, bflag, lflag, acc128, nblk, accumulate);
  return static_cast<int>(cudaGetLastError());
}
