// Stage-then-fold: the fixed-order per-id sums of one block of rows
// (compact_sweep.cu stats_partial, segsum.cu paymom_partial).
//
// The order is the plain versions' (ops/segsum.py block_order_sums): a
// block of kRows consecutive rows adds each id's rows strictly left to
// right in row order, starting from +0.  An f32 left fold cannot be split
// without changing bits, so the parallelism comes from around it.  A
// block of kThreads threads:
//   1. stage: the kernel loads its rows coalesced, one thread a row, and
//      writes each live row's columns into a shared [kRows][NCOL + 1]
//      array (the odd row stride keeps both the row-per-thread stores and
//      the column-per-lane loads of step 4 free of bank conflicts), and a
//      sort key (id << kRowBits | local row); a dead row gets kNoId;
//   2. sort: a bitonic sort of the kRows keys in shared memory, which
//      lists each id's rows contiguously and still in row order (the row
//      is the key's low bits); stages that stay inside a warp's 64 keys
//      synchronise that warp only;
//   3. runs: a block scan over the run heads numbers each id's run;
//   4. fold: one lane per (run, column) adds its run's values from shared
//      memory, in sorted order.  The loads do not depend on the sum, so
//      they are issued eight ahead of the add chain.  The runs of a lane
//      are disjoint, so no lane adds more than kRows values.
// Where every live id is below kBucketBound, bucket_sort_keys gives step 2
// the same order for about a tenth of the network's instructions.  The
// second pass over the blocks' partials folds with fold_in_order.
// One block's whole fold is then ~kRows dependent adds from shared
// memory, where a serial row walk pays one global-memory latency a row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace block_fold {

constexpr int kRows = 1024;
constexpr int kThreads = 512;  // two keys a thread in the sort and the scan
constexpr int kRowBits = 10;
constexpr int kRowMask = kRows - 1;
constexpr int kNoId = (1 << 21) - 1;  // dead row; every live id is below
constexpr int kLanes = 16;            // lanes a run: one per column
constexpr int kWarps = kThreads / 32;
static_assert(kRows == 2 * kThreads && kRows == 1 << kRowBits, "layout");

template <int NCOL>
struct Smem {
  static_assert(NCOL % 2 == 0 && NCOL <= kLanes, "odd stride, <= 16 cols");
  static constexpr int kStride = NCOL + 1;
  float val[kRows * kStride];  // row i's columns at val[i * kStride]
  int key[kRows];
  int seg[kRows + 1];  // run r: sorted positions [seg[r], seg[r + 1])
  int warp_sum[kWarps];
};

__device__ __forceinline__ int live_key(int id, int row) {
  return (id << kRowBits) | row;
}

__device__ __forceinline__ int dead_key(int row) {
  return (kNoId << kRowBits) | row;
}

// Ascending bitonic sort of key[0, kRows); the keys are distinct (the row
// is part of each).  Ends with a block barrier.
__device__ __forceinline__ void sort_keys(int* key) {
  const int t = threadIdx.x;
  for (int k = 2; k <= kRows; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
      const int a = key[i], b = key[i + j];
      if ((a > b) == ((i & k) == 0)) {
        key[i] = b;
        key[i + j] = a;
      }
      // for j <= 32 the 32 threads of a warp touch keys [64w, 64w + 64)
      // only; the next stage is (k, j / 2), or (2k, k) after j = 1
      const int next = j > 1 ? j >> 1 : k;
      if (j <= 32 && next <= 32) {
        __syncwarp();
      } else {
        __syncthreads();
      }
    }
  }
}

// Exclusive prefix sum of one int a thread over the block, in thread
// order; *total gets the sum.  Ends with a block barrier.
__device__ __forceinline__ int block_scan(int v, int* warp_sum, int* total) {
  const int t = threadIdx.x, lane = t & 31, wid = t >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sum[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int w = lane < kWarps ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kWarps) warp_sum[lane] = w;
  }
  __syncthreads();
  *total = warp_sum[kWarps - 1];
  const int before = (wid > 0 ? warp_sum[wid - 1] : 0) + incl - v;
  __syncthreads();  // warp_sum may be reused
  return before;
}

constexpr int kRowWarps = kRows / 32;
// ids the bucket sort takes: every live id below it (nb <= it + 1
// buckets, the last for the dead rows)
constexpr int kBucketBound = 256;

// Shared ints bucket_sort_keys needs for nb buckets.
__host__ __device__ constexpr int bucket_ints(int nb) {
  return (kRowWarps + 1) * nb;
}

// The order of sort_keys (by id, then row; the dead keys last, by row)
// for keys whose live ids lie below nb - 1, by counting: a row's place is
// the rows of smaller ids, plus those of its id in earlier 32-row warps,
// plus those of its id at lower lanes of its own (__match_any_sync).
// cnt: bucket_ints(nb) shared ints.  Ends with a block barrier.
__device__ __forceinline__ void bucket_sort_keys(int* key, int* cnt, int nb,
                                                 int* warp_sum) {
  const int t = threadIdx.x, lane = t & 31;
  for (int k = t; k < kRowWarps * nb; k += kThreads) cnt[k] = 0;
  __syncthreads();
  int mine[2], bkt[2], rank[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + j * kThreads;  // row i lies in row-warp i / 32
    mine[j] = key[i];
    const int id = mine[j] >> kRowBits;
    bkt[j] = id == kNoId ? nb - 1 : id;
    const unsigned peers = __match_any_sync(0xffffffffu, bkt[j]);
    rank[j] = __popc(peers & ((1u << lane) - 1u));
    if (rank[j] == 0) cnt[(i >> 5) * nb + bkt[j]] = __popc(peers);
  }
  __syncthreads();
  // per bucket: the rows of earlier row-warps, and its total
  int* base = cnt + kRowWarps * nb;
  int tot = 0;
  if (t < nb) {
    for (int rw = 0; rw < kRowWarps; ++rw) {
      const int c = cnt[rw * nb + t];
      cnt[rw * nb + t] = tot;
      tot += c;
    }
  }
  int all;
  const int before = block_scan(tot, warp_sum, &all);
  if (t < nb) base[t] = before;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = t + j * kThreads;
    key[base[bkt[j]] + cnt[(i >> 5) * nb + bkt[j]] + rank[j]] = mine[j];
  }
  __syncthreads();
}

// Numbers the runs of equal live ids among the sorted keys: run r covers
// sorted positions [seg[r], seg[r + 1]).  Returns the number of runs.
// Ends with a block barrier.
__device__ __forceinline__ int find_runs(const int* key, int* seg,
                                         int* warp_sum) {
  const int t = threadIdx.x;
  const int p0 = 2 * t, p1 = p0 + 1;
  const int id0 = key[p0] >> kRowBits, id1 = key[p1] >> kRowBits;
  const int idp = p0 > 0 ? key[p0 - 1] >> kRowBits : -1;
  const int idn = p1 + 1 < kRows ? key[p1 + 1] >> kRowBits : kNoId;
  const int h0 = id0 != kNoId && id0 != idp;
  const int h1 = id1 != kNoId && id1 != id0;
  int nrun;
  const int before = block_scan(h0 + h1, warp_sum, &nrun);
  if (h0) seg[before] = p0;
  if (h1) seg[before + h0] = p1;
  // the live keys end where the dead ones (the largest) begin (idp is -1
  // before position 0)
  if (id0 == kNoId && idp != kNoId) {
    seg[nrun] = p0;
  } else if (id0 != kNoId && id1 == kNoId) {
    seg[nrun] = p1;
  } else if (id1 != kNoId && idn == kNoId) {
    seg[nrun] = p1 + 1;
  }
  __syncthreads();
  return nrun;
}

// acc + get(p0) + get(p0 + 1) + ... + get(p1 - 1), added left to right;
// the loads of each group of eight are issued before the adds of the
// group before it, so the add chain waits on no load latency but the
// first group's.
template <class Get>
__device__ __forceinline__ float fold_in_order(int p0, int p1, float acc,
                                               Get get) {
  int p = p0;
  if (p + 8 <= p1) {
    float cur[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) cur[u] = get(p + u);
    for (p += 8; p + 8 <= p1; p += 8) {
      float nxt[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) nxt[u] = get(p + u);
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += cur[u];
#pragma unroll
      for (int u = 0; u < 8; ++u) cur[u] = nxt[u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc += cur[u];
  }
  for (; p < p1; ++p) acc += get(p);
  return acc;
}

// One lane per (run, column): the run's values added from +0 in sorted
// (= row) order, then emit(id, column, sum).  Lanes of columns >= NCOL
// idle.  No barrier inside.
template <int NCOL, class Emit>
__device__ __forceinline__ void fold_runs(const Smem<NCOL>& sm, int nrun,
                                          Emit emit) {
  constexpr int S = Smem<NCOL>::kStride;
  const int col = threadIdx.x & (kLanes - 1);
  if (col >= NCOL) return;
  for (int r = threadIdx.x / kLanes; r < nrun; r += kThreads / kLanes) {
    const int p0 = sm.seg[r], p1 = sm.seg[r + 1];
    float acc = 0.f;
    int p = p0;
    for (; p + 8 <= p1; p += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = sm.val[(sm.key[p + u] & kRowMask) * S + col];
#pragma unroll
      for (int u = 0; u < 8; ++u) acc += v[u];
    }
    for (; p < p1; ++p) acc += sm.val[(sm.key[p] & kRowMask) * S + col];
    emit(sm.key[p0] >> kRowBits, col, acc);
  }
}

}  // namespace block_fold
