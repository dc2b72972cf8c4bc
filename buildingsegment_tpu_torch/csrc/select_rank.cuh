// Exact order statistics of one row's candidate values, one thread a row
// (stats_sweep.cu, stats_mxu.cu), or one warp a row of at most 128 values
// (warp_pick, stats_mxu.cu; stats_sweep.cu keeps an inline copy).
//
// The r-th smallest of a row's finite values (1-based; equal values each
// hold a rank) is found in passes over the row.  Pass p keeps, in registers, the
// kList smallest values above the previous pass's last kept value, fed in
// chunks of kList: each chunk is sorted by a bitonic network and merged
// into the kept list (the elementwise min of the list and the reversed
// chunk holds the kList smallest of both, as a bitonic sequence, which a
// half-cleaner cascade sorts).  A pass costs about 15 min/max operations a
// candidate, where a bisection over the f32 bit patterns costs two
// compares and an add a candidate for each of its 31 steps.  Ranks up to
// kList need one pass; a rank r needs about r / kList passes (fewer where
// ties jump ahead).  Every index into a register array is a compile-time
// constant.
//
// Values are non-negative floats or +inf ("no candidate"); +inf is never
// ranked: a rank beyond the finite values is +inf.
#pragma once

#include <cuda_runtime.h>

namespace select_rank {

constexpr int kList = 16;
constexpr float kInf = __builtin_huge_valf();

__device__ __forceinline__ void cmp_swap(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmaxf(a, b);
  a = lo;
}

// Ascending bitonic sort of N keys held in registers.
template <int N>
__device__ __forceinline__ void sort_keys(float (&a)[N]) {
#pragma unroll
  for (int k = 2; k <= N; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int l = i ^ j;
        if (l > i) {
          if ((i & k) == 0) {
            cmp_swap(a[i], a[l]);
          } else {
            cmp_swap(a[l], a[i]);
          }
        }
      }
    }
  }
}

// The kList smallest of (list, chunk) into list, ascending; both come in
// ascending, the chunk is consumed.
__device__ __forceinline__ void merge_keep(float (&list)[kList],
                                           const float (&chunk)[kList]) {
#pragma unroll
  for (int i = 0; i < kList; ++i)
    list[i] = fminf(list[i], chunk[kList - 1 - i]);
#pragma unroll
  for (int j = kList >> 1; j > 0; j >>= 1) {
#pragma unroll
    for (int i = 0; i < kList; ++i) {
      const int l = i ^ j;
      if (l > i) cmp_swap(list[i], list[l]);
    }
  }
}

// list[r - 1] for 1 <= r <= kList, else +inf.
__device__ __forceinline__ float pick(const float (&list)[kList], int r) {
  float v = kInf;
#pragma unroll
  for (int i = 0; i < kList; ++i)
    if (r == i + 1) v = list[i];
  return v;
}

// One row's selection state across passes.  Pass p's list holds the
// kList smallest values above `floor` (the previous list's last entry);
// `below` counts the values <= floor once the pass has seen every value.
struct Passes {
  float list[kList];
  float chunk[kList];
  float floor;       // -1: nothing excluded yet
  int below;         // values <= floor, before this pass
  int below_prev;    // `below` of the previous pass
  int list_eq;       // entries of the previous list equal to its last
  int floor_eq;      // values == floor seen in this pass

  __device__ __forceinline__ void start_first() {
    floor = -1.f;
    below = below_prev = list_eq = floor_eq = 0;
    clear();
  }

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < kList; ++i) list[i] = kInf;
  }

  // Candidate slot u of the first pass's current chunk: value v, or +inf
  // for none (the first pass excludes nothing).
  __device__ __forceinline__ void put_first(int u, float v) { chunk[u] = v; }

  // Candidate slot u of a later pass's current chunk.
  __device__ __forceinline__ void put(int u, float v) {
    floor_eq += v == floor;
    chunk[u] = v > floor ? v : kInf;
  }

  __device__ __forceinline__ void end_chunk() {
    sort_keys(chunk);
    merge_keep(list, chunk);
  }

  // After a pass: `below` becomes exact for this pass's list (the first
  // pass excludes nothing).
  __device__ __forceinline__ void end_pass(bool first) {
    if (!first) below = below_prev + (kList - list_eq) + floor_eq;
  }

  // The r-th smallest if this pass settles it (r <= below + kList, or the
  // list ran out of finite values), through `out`; false otherwise.
  __device__ __forceinline__ bool settle(int r, float& out) const {
    if (r <= below) {  // a tie of the previous list's last entry
      out = floor;
      return true;
    }
    if (r <= below + kList || list[kList - 1] == kInf) {
      out = pick(list, r - below);
      return true;
    }
    return false;
  }

  // Prepares the next pass above this list.
  __device__ __forceinline__ void next_pass() {
    floor = list[kList - 1];
    int eq = 0;
#pragma unroll
    for (int i = 0; i < kList; ++i) eq += list[i] == floor;
    list_eq = eq;
    below_prev = below;
    floor_eq = 0;
    clear();
  }
};

// The value at sorted position rc (0-based, rc < 128) of up to 128 values
// held four a lane across a warp (lane l holds positions 4l .. 4l + 3,
// +inf padded): a bitonic sort across the warp (partners inside a lane,
// or in lane ^ (j / 4) through a shuffle), then a shuffle from the lane
// that holds position rc.  Every lane gets the value.
__device__ __forceinline__ float warp_pick(float (&key)[4], int rc) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 2; k <= 128; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < 4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = r ^ j;
          if (o > r) {
            if (((4 * lane + r) & k) == 0) {
              cmp_swap(key[r], key[o]);
            } else {
              cmp_swap(key[o], key[r]);
            }
          }
        }
      } else {
        const int m = j >> 2;
        const bool lower = (lane & m) == 0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float o = __shfl_xor_sync(0xffffffffu, key[r], m);
          const bool keep_min = (((4 * lane + r) & k) == 0) == lower;
          key[r] = keep_min ? fminf(key[r], o) : fmaxf(key[r], o);
        }
      }
    }
  }
  float v = key[0];
#pragma unroll
  for (int r = 1; r < 4; ++r)
    if ((rc & 3) == r) v = key[r];
  return __shfl_sync(0xffffffffu, v, rc >> 2);
}

}  // namespace select_rank
