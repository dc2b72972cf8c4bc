// stats_sweep: the exact k-th-NN squared distance and the hybrid-radius
// normal moments of every row over its +-w Morton window, in one pass.
//
// Replaces the TPU kernel buildingsegment_tpu/ops/stats_sweep.py
// _stats_kernel (wrapper fused_stats_sweep, called from
// knn_normals_window_stats).
//
// What bounds it on the H100: the function itself is bound by bytes and
// operations about equally, a few microseconds each.  A row reads 13 B
// (position, mask) and writes 44 B (dk and 10 moment sums), about 13 MB
// at the slice's 223k rows; it needs a squared distance and a compare or
// two for each of its 2w candidates (96 at w = 48).  What this design
// spends is issue slots: about 11 operations a candidate for its squared
// distance, about 15 min/max operations a candidate for the selection
// (half-rate on the ALU pipe) and the moments' adds for each candidate
// inside the radius.  A bisection of both order statistics over the f32
// bit patterns would spend about 6,000 integer operations a row.
//
// Design: the TPU kernel DMA'd a padded slab per tile and bisected over a
// [2w, tile] block of distance bit patterns in VMEM.  Here a block of
// kRows threads stages the positions and mask of rows
// [b*kRows - w, (b+1)*kRows + w) as float4s in shared memory; one thread
// owns one row.
//   1. One pass over the 2w candidates, in slot order (offsets -w..-1,
//      then +1..+w), computes each squared distance from the staged
//      positions, feeds it to the selection (select_rank.cuh: the 16
//      smallest, kept sorted in registers) and, when it lies within the
//      radius, adds it to the moments (a left fold from the query's own
//      count of 1) and to cnt_r, the count within the radius.
//   2. dk, the r_k-th smallest, comes out of that pass for r_k <= 16;
//      larger ranks take further passes over the staged positions.
//   3. The cap can only bind where cnt_r >= r_cap: the r_cap-th smallest
//      exceeds r^2 exactly when fewer than r_cap candidates lie within r.
//      Elsewhere min(r^2, cap) = r^2 and the moments of step 1 stand.
//   4. A row whose cap binds (about 1% of the rows at 25 mm spacing, but
//      in one warp of seven) is queued in shared memory and taken by a
//      whole warp once the block's rows are done: a bitonic sort of its
//      2w <= 128 distances across the warp gives the cap, and ten lanes
//      fold the moments over d <= cap, one column each, in slot order.
//      Left to its own thread, such a row would hold its warp for three
//      more selection passes and a serial moment fold.  Wider windows
//      take that per-thread way: further passes, then the fold again.
// Order statistics are values, so any exact selection gives the
// bisection's bits.  The library is built with -fmad=false, so every
// product and sum rounds as in the plain PyTorch version: dk and the
// moments are bit-identical to it.
#include <cuda_runtime.h>
#include <stdint.h>

#include "select_rank.cuh"

namespace {

constexpr int kRows = 256;
using select_rank::kInf;
using select_rank::kList;

struct Query {
  const float4* sp;  // staged rows: x, y, z, valid (1 / 0)
  int c;             // the query's staged row
  int w;
  float4 q;
  bool qm;

  // Candidate slot s: the offset to it and its squared distance; false
  // when the pair is not valid.
  __device__ __forceinline__ bool cand(int s, float& dx, float& dy,
                                       float& dz, float& d) const {
    const int j = c + (s < w ? s - w : s - w + 1);
    const float4 p = sp[j];
    dx = p.x - q.x;
    dy = p.y - q.y;
    dz = p.z - q.z;
    d = dx * dx + dy * dy + dz * dz;
    return qm && p.w > 0.5f;
  }
};

struct Moments {
  float s0, s1x, s1y, s1z, sxx, syy, szz, sxy, sxz, syz;

  __device__ __forceinline__ void start(bool qm) {
    s0 = qm ? 1.f : 0.f;
    s1x = s1y = s1z = sxx = syy = szz = sxy = sxz = syz = 0.f;
  }

  __device__ __forceinline__ void add(float dx, float dy, float dz) {
    s0 += 1.f;
    s1x += dx;
    s1y += dy;
    s1z += dz;
    sxx += dx * dx;
    syy += dy * dy;
    szz += dz * dz;
    sxy += dx * dy;
    sxz += dx * dz;
    syz += dy * dz;
  }
};

constexpr int kWarps = kRows / 32;
constexpr int kWarpSlots = 128;   // widest 2w of the warp path: 4 a lane
constexpr int kTerms = 10;        // moment columns
constexpr int kTermStride = kTerms + 1;

// A row whose cap binds, by one warp: its cap from a bitonic sort of its
// 2w <= 128 candidate distances across the warp (4 a lane, +inf padded),
// then its moments over d <= min(r^2, cap) with one lane a column, each
// column a left fold in slot order over rounds of 32 slots staged in the
// warp's scratch (a slot outside the ball stages +0 terms, which leave a
// fold from +0 unchanged).
__device__ __forceinline__ void cap_row_by_warp(const float4* sp, int t_row,
                                                int w, int r_cap, float r2,
                                                float* scr, float* out,
                                                int n, int i) {
  const int lane = threadIdx.x & 31;
  Query qr;
  qr.sp = sp;
  qr.c = t_row + w;
  qr.w = w;
  qr.q = sp[qr.c];
  qr.qm = qr.q.w > 0.5f;
  const int w2 = 2 * w;
  float key[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = 4 * lane + r;
    float dx, dy, dz, d;
    key[r] = (s < w2 && qr.cand(s, dx, dy, dz, d)) ? d : kInf;
  }
#pragma unroll
  for (int k = 2; k <= kWarpSlots; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j < 4) {  // partners in the lane
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int o = r ^ j;
          if (o > r) {
            if (((4 * lane + r) & k) == 0) {
              select_rank::cmp_swap(key[r], key[o]);
            } else {
              select_rank::cmp_swap(key[o], key[r]);
            }
          }
        }
      } else {  // partners in lane ^ (j / 4), same register
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
  const int rc = r_cap - 1;  // sorted position of the cap
  float v = key[0];
#pragma unroll
  for (int r = 1; r < 4; ++r)
    if ((rc & 3) == r) v = key[r];
  const float r_eff2 = fminf(r2, __shfl_sync(0xffffffffu, v, rc >> 2));

  float acc = lane == 0 && qr.qm ? 1.f : 0.f;  // column `lane`
  float* mine = scr + lane * kTermStride;
  for (int s0 = 0; s0 < w2; s0 += 32) {
    const int s = s0 + lane;
    float dx = 0.f, dy = 0.f, dz = 0.f, d;
    const bool use = s < w2 && qr.cand(s, dx, dy, dz, d) && d <= r_eff2;
    mine[0] = use ? 1.f : 0.f;
    mine[1] = use ? dx : 0.f;
    mine[2] = use ? dy : 0.f;
    mine[3] = use ? dz : 0.f;
    mine[4] = use ? dx * dx : 0.f;
    mine[5] = use ? dy * dy : 0.f;
    mine[6] = use ? dz * dz : 0.f;
    mine[7] = use ? dx * dy : 0.f;
    mine[8] = use ? dx * dz : 0.f;
    mine[9] = use ? dy * dz : 0.f;
    __syncwarp();
    if (lane < kTerms) {
      const int cnt = min(32, w2 - s0);
      for (int j = 0; j < cnt; ++j) acc += scr[j * kTermStride + lane];
    }
    __syncwarp();
  }
  if (lane < kTerms) out[(1 + lane) * n + i] = acc;
}

__global__ void __launch_bounds__(kRows, 3) stats_sweep_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const uint8_t* __restrict__ mask,
    float* __restrict__ out, int n, int w, int r_k, int r_cap, float r2) {
  extern __shared__ float4 sp[];
  __shared__ float scratch[kWarps][32 * kTermStride];
  __shared__ int capq[kRows];  // rows whose cap binds, for the warp path
  __shared__ int ncap;
  const int span = kRows + 2 * w;
  const int base = blockIdx.x * kRows - w;
  if (threadIdx.x == 0) ncap = 0;
  for (int k = threadIdx.x; k < span; k += kRows) {
    const int r = base + k;
    const bool in = r >= 0 && r < n;
    sp[k] = make_float4(in ? px[r] : 0.f, in ? py[r] : 0.f,
                        in ? pz[r] : 0.f, (in && mask[r]) ? 1.f : 0.f);
  }
  __syncthreads();
  const int i = blockIdx.x * kRows + threadIdx.x;
  const int w2 = 2 * w;
  const bool warp_cap = w2 <= kWarpSlots;
  if (i < n) {
    Query qr;
    qr.sp = sp;
    qr.c = threadIdx.x + w;
    qr.w = w;
    qr.q = sp[qr.c];
    qr.qm = qr.q.w > 0.5f;

    // 1. the first selection pass, the moments within the radius, cnt_r
    select_rank::Passes ps;
    ps.start_first();
    Moments m;
    m.start(qr.qm);
    int cnt_r = 0;
    for (int s0 = 0; s0 < w2; s0 += kList) {
#pragma unroll
      for (int u = 0; u < kList; ++u) {
        const int s = s0 + u;
        float v = kInf;
        float dx, dy, dz, d;
        if (s < w2 && qr.cand(s, dx, dy, dz, d)) {
          v = d;
          if (d <= r2) {
            ++cnt_r;
            m.add(dx, dy, dz);
          }
        }
        ps.put_first(u, v);
      }
      ps.end_chunk();
    }
    ps.end_pass(true);

    // 2-3. the ranks this thread selects: r_k always (0: none), r_cap
    // where the cap binds and the warp path does not take the row; each
    // further pass settles up to 16 more ranks
    const bool binds = r_cap > 0 && cnt_r >= r_cap;
    float dk = 0.f, cap = kInf;
    bool dk_done = r_k <= 0 || ps.settle(r_k, dk);
    bool cap_done = !binds || warp_cap || ps.settle(r_cap, cap);
    while (!(dk_done && cap_done)) {
      ps.next_pass();
      for (int s0 = 0; s0 < w2; s0 += kList) {
#pragma unroll
        for (int u = 0; u < kList; ++u) {
          const int s = s0 + u;
          float v = kInf;
          float dx, dy, dz, d;
          if (s < w2 && qr.cand(s, dx, dy, dz, d)) v = d;
          ps.put(u, v);
        }
        ps.end_chunk();
      }
      ps.end_pass(false);
      if (!dk_done) dk_done = ps.settle(r_k, dk);
      if (!cap_done) cap_done = ps.settle(r_cap, cap);
    }
    // fewer than r_k finite candidates -> 0 (the kNN path's convention)
    out[i] = (dk == kInf || !qr.qm) ? 0.f : dk;

    if (binds && warp_cap) {
      capq[atomicAdd(&ncap, 1)] = threadIdx.x;
    } else {
      if (binds) {  // the moments again, over d <= min(r^2, cap)
        const float r_eff2 = fminf(r2, cap);
        m.start(qr.qm);
        for (int s = 0; s < w2; ++s) {
          float dx, dy, dz, d;
          if (qr.cand(s, dx, dy, dz, d) && d <= r_eff2) m.add(dx, dy, dz);
        }
      }
      out[1 * n + i] = m.s0;
      out[2 * n + i] = m.s1x;
      out[3 * n + i] = m.s1y;
      out[4 * n + i] = m.s1z;
      out[5 * n + i] = m.sxx;
      out[6 * n + i] = m.syy;
      out[7 * n + i] = m.szz;
      out[8 * n + i] = m.sxy;
      out[9 * n + i] = m.sxz;
      out[10 * n + i] = m.syz;
    }
  }
  // 4. the rows whose cap binds, a warp each (in any order: each row's
  // result is its own)
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  for (int e = warp; e < ncap; e += kWarps) {
    const int t_row = capq[e];
    cap_row_by_warp(sp, t_row, w, r_cap, r2, scratch[warp], out, n,
                    blockIdx.x * kRows + t_row);
  }
}

}  // namespace

extern "C" int bst_stats_sweep(const float* px, const float* py,
                               const float* pz, const uint8_t* mask,
                               float* out, int n, int w, int r_k, int r_cap,
                               float r2, void* stream) {
  if (n <= 0 || w < 1) return cudaErrorInvalidValue;
  const int smem = (kRows + 2 * w) * static_cast<int>(sizeof(float4));
  cudaFuncSetAttribute(stats_sweep_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  stats_sweep_kernel<<<(n + kRows - 1) / kRows, kRows, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      px, py, pz, mask, out, n, w, r_k, r_cap, r2);
  return static_cast<int>(cudaGetLastError());
}
